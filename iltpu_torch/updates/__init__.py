from iltpu_torch.updates.sac import SACLearner

__all__ = ["SACLearner"]
