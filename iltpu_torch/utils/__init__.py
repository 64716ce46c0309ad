from iltpu_torch.utils.checkpoint import Fields, flatten, load_checkpoint, save_checkpoint, unflatten

__all__ = ["Fields", "flatten", "load_checkpoint", "save_checkpoint", "unflatten"]
