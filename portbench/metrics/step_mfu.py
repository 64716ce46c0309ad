"""Model step: the model FLOPs of one update (the algorithm adapter's
`update_flops`: its reward model's step and the SAC update, from shapes;
GAIL's from `work/step.py`) times the updates the profiled sub-window
completed (its SAC launches, and K for each launch of the K-blocked
kernel), per second of the sub-window on the device's clock, over the
float32 peak, in %."""

from portbench import algorithms, peaks
from portbench.trace import launches
from portbench.work import kblock_update, sac_update


def read(ctx):
    tr, f = ctx["trace"], ctx["facts"]
    if not tr:
        return None
    per = algorithms.adapter(f["algorithm"]).update_flops(ctx)
    if per is None:
        return None
    n = len(launches(tr, sac_update.KERNEL)) + f["unit"] * len(launches(tr, kblock_update.KERNEL))
    w0, w1 = tr["window_us"]
    if n == 0 or w1 <= w0:
        return None
    return 100.0 * per * n / ((w1 - w0) * 1e-6) / peaks.FP32_FLOPS
