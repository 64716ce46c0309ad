from iltpu_torch.rewards.gail import GAILDiscriminator
from iltpu_torch.rewards.gmmil import GMMILDiscriminator, GMMILState

__all__ = ["GAILDiscriminator", "GMMILDiscriminator", "GMMILState"]
