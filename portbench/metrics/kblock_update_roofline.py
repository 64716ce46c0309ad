"""K-blocked step kernel: the least time of one launch of K GAIL and SAC
micro-updates from their shapes and the active share of the penalty's
rows in the probed unit's first micro-update (`work/kblock_update.py`, at
the float32 rate and the memory rate) over the mean device time of a
launch in the profiled sub-window, in %."""

from portbench import peaks
from portbench.trace import launches
from portbench.work import kblock_update


def read(ctx):
    tr, f, active = ctx["trace"], ctx["facts"], ctx.get("gail_active")
    times = launches(tr, kblock_update.KERNEL) if tr else []
    if not times or active is None:
        return None
    K, S, A, B, H, Hd = f["unit"], f["S"], f["A"], f["B"], f["H"], f["Hd"]
    bound = peaks.bound_s(kblock_update.flops(K, S, A, B, H, Hd, active, f["mixup"]),
                          kblock_update.nbytes(K, S, A, B, H, Hd, f["sn"], f["mixup"]))
    return 100.0 * bound / (sum(times) / len(times))
