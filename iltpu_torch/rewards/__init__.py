from iltpu_torch.rewards.adril import init_relabeller, resample_and_relabel
from iltpu_torch.rewards.gail import GAILDiscriminator
from iltpu_torch.rewards.gmmil import GMMILDiscriminator, GMMILState
from iltpu_torch.rewards.mixing import mix_expert_agent_transitions
from iltpu_torch.rewards.red import REDDiscriminator

__all__ = [
    "GAILDiscriminator",
    "GMMILDiscriminator",
    "GMMILState",
    "REDDiscriminator",
    "init_relabeller",
    "mix_expert_agent_transitions",
    "resample_and_relabel",
]
