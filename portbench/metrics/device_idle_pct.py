"""Device: the share of the profiled sub-window in which no operation ran
on the card (100 minus the union of its kernel, copy and memset intervals,
between the two marker kernels), in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    w0, w1 = tr["window_us"]
    return 100.0 * (1.0 - tr["busy_us"] / (w1 - w0))
