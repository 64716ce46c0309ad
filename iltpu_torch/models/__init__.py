from iltpu_torch.models.actor import SoftActor
from iltpu_torch.models.critic import TwinCritic, polyak_update
from iltpu_torch.models.fcnn import MLP

__all__ = ["MLP", "SoftActor", "TwinCritic", "polyak_update"]
