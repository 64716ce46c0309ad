"""Replay ring (front): the median host ms of one `front` span (the ring
append, the iteration's draws and its one bulk sample of the replay and the
expert rows) over the window before the profiled sub-window. Needs the
port's span recorder on (`portbench/spans.py`)."""

import numpy as np

from portbench.spans import in_window


def read(ctx):
    x = [1e-6 * (e - s) for _, s, e, _, _, _ in in_window(ctx, "front")]
    return float(np.median(x)) if x else None
