"""SAC step kernel: the least time of one update from its shapes
(`work/sac_update.py`, at the float32 rate and the memory rate) over the
mean device time of a launch in the profiled sub-window, in %."""

from portbench import peaks
from portbench.trace import launches
from portbench.work import sac_update


def read(ctx):
    tr, f = ctx["trace"], ctx["facts"]
    times = launches(tr, sac_update.KERNEL) if tr else []
    if not times:
        return None
    S, A, B, H = f["S"], f["A"], f["B"], f["H"]
    bound = peaks.bound_s(sac_update.flops(S, A, B, H), sac_update.nbytes(S, A, B, H))
    return 100.0 * bound / (sum(times) / len(times))
