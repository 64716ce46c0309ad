from iltpu_torch.data.dataset import build_expert_transitions
from iltpu_torch.data.replay import (
    ReplayState,
    replay_append_batch,
    replay_from_transitions,
    replay_init,
    replay_sample,
    replay_transfer,
)
from iltpu_torch.data.synthetic import random_d4rl_dataset

__all__ = [
    "ReplayState",
    "build_expert_transitions",
    "random_d4rl_dataset",
    "replay_append_batch",
    "replay_from_transitions",
    "replay_init",
    "replay_sample",
    "replay_transfer",
]
