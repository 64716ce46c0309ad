"""Update issue (device ops): the device kernels, copies and memsets of the
profiled sub-window launched from inside its `updates` spans (the host's
launch from the trace's `cuda_runtime` event, matched by correlation id and
mapped through the sub-window's tie), over the updates those spans issued.
Needs the port's span recorder on (`portbench/spans.py`)."""

from portbench.spans import Intervals, to_host_ns


def read(ctx):
    tr, got = ctx.get("trace"), ctx.get("spans")
    if not tr or not got or "launches" not in tr:
        return None
    launched = [to_host_ns(tr, at) for _, at in tr["launches"] if at is not None]
    w0, w1 = tr["window_us"]
    lo, hi = to_host_ns(tr, w0), to_host_ns(tr, w1)
    issued = [s for s in got["spans"] if s[0] == "updates" and lo <= s[1] and s[2] <= hi]
    updates = sum(s[5] for s in issued)
    if not launched or not updates:
        return None
    held = Intervals(issued, "updates")
    return sum(held.holding(t) is not None for t in launched) / updates
