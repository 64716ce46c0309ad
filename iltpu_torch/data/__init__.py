from iltpu_torch.data.dataset import D4RL_KEYS, build_expert_transitions, load_d4rl_hdf5
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
    "D4RL_KEYS",
    "ReplayState",
    "build_expert_transitions",
    "load_d4rl_hdf5",
    "random_d4rl_dataset",
    "replay_append_batch",
    "replay_from_transitions",
    "replay_init",
    "replay_sample",
    "replay_transfer",
]
