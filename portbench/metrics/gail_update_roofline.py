"""GAIL step kernel: the least time of one discriminator step with its
reward head from its shapes and the active share of an update's penalty
rows (`work/gail_update.py`, at the float32 rate and the memory rate) over
the mean device time of a launch in the profiled sub-window, in %."""

from portbench import peaks
from portbench.trace import launches
from portbench.work import gail_update


def read(ctx):
    tr, f, active = ctx["trace"], ctx["facts"], ctx.get("gail_active")
    times = launches(tr, gail_update.KERNEL) if tr else []
    if not times or active is None:
        return None
    S, A, B, Hd = f["S"], f["A"], f["B"], f["Hd"]
    bound = peaks.bound_s(gail_update.flops(B, S + A, Hd, active, f["mixup"]),
                          gail_update.nbytes(B, S, A, Hd, f["sn"], f["mixup"]))
    return 100.0 * bound / (sum(times) / len(times))
