"""The model FLOPs of one update of the GAIL training step (the body the
fused update scan runs once an owed update): one discriminator step with
its reward head, then one SAC update. Counted from shapes, as the
kernels' files count them; what the hardware could do with them is
`peaks.FP32_FLOPS`."""

from portbench.work import gail_update, sac_update


def flops(S: int, A: int, B: int, H: int, Hd: int, active: float, mixup: bool) -> float:
    return sac_update.flops(S, A, B, H) + gail_update.flops(B, S + A, Hd, active, mixup)
