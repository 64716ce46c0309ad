"""Model step: the model FLOPs of one update (`work/step.py`: the GAIL step
and the SAC update, from shapes) times the updates the profiled sub-window
completed (its SAC launches), per second of the sub-window on the device's
clock, over the float32 peak, in %."""

from portbench import peaks
from portbench.trace import launches
from portbench.work import sac_update, step


def read(ctx):
    tr, f, active = ctx["trace"], ctx["facts"], ctx.get("gail_active")
    if not tr or active is None:
        return None
    n = len(launches(tr, sac_update.KERNEL))
    w0, w1 = tr["window_us"]
    if n == 0 or w1 <= w0:
        return None
    per = step.flops(f["S"], f["A"], f["B"], f["H"], f["Hd"], active, f["mixup"])
    return 100.0 * per * n / ((w1 - w0) * 1e-6) / peaks.FP32_FLOPS
