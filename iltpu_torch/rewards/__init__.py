from iltpu_torch.rewards.gail import GAILDiscriminator

__all__ = ["GAILDiscriminator"]
