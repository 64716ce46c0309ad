"""MuJoCo stepper: the mean host ms of one step of every env (the stepper's
C call and the copies of its outputs), over the window's steps outside the
profiled sub-window."""

import numpy as np


def read(ctx):
    x = ctx["window"]["env_ms"]
    return float(np.mean(x)) if x else None
