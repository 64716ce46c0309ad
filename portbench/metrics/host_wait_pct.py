"""Host-device handoff: the host's time blocked on the card (the `wait`
spans: the host reads' event, the actions' event in the env step, a pinned
block's event) over the host time of the window before the profiled
sub-window, in %. Needs the port's span recorder on (`portbench/spans.py`)."""

from portbench.spans import in_window


def read(ctx):
    if not ctx.get("spans"):
        return None
    lo, hi = ctx["spans"]["host_ns"]
    return 100.0 * sum(e - s for _, s, e, _, _, _ in in_window(ctx, "wait")) / (hi - lo)
