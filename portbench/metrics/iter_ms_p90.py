"""Trainer loop: the 90th percentile of the host ms between consecutive
iteration tops over the window, the profiled sub-window's iterations left
out."""

import numpy as np


def read(ctx):
    x = ctx["window"]["iter_ms"]
    return float(np.percentile(x, 90)) if len(x) >= 10 else None
