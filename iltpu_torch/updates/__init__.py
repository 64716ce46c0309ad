from iltpu_torch.updates.adversarial import AdversarialConfig, adversarial_imitation_update
from iltpu_torch.updates.bc import actor_opt_state, behavioural_cloning_update
from iltpu_torch.updates.red import target_estimation_update
from iltpu_torch.updates.sac import SACLearner

__all__ = [
    "AdversarialConfig",
    "SACLearner",
    "actor_opt_state",
    "adversarial_imitation_update",
    "behavioural_cloning_update",
    "target_estimation_update",
]
