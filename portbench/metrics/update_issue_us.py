"""Update issue (host): the median host us of one `update` span (one unit of
`Trainer.run_updates`' loop, its slicing included) over the updates in its
unit, over the window before the profiled sub-window. Needs the port's span
recorder on (`portbench/spans.py`)."""

import numpy as np

from portbench.spans import in_window


def read(ctx):
    x = [1e-3 * (e - s) / attr for _, s, e, _, _, attr in in_window(ctx, "update")]
    return float(np.median(x)) if x else None
