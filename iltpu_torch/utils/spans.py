"""Host spans of the trainer's host loop: where the host is, iteration by
iteration, while the card works or waits.

One `Recorder` serves the whole loop. It is off by default:
`Trainer.spans`, `HostEnv.spans` and `HostReads.spans` are None, and each
span site then costs one attribute read and one branch, with no clock read
and no allocation. A caller turns it on through the API, before the run:

    trainer.spans = Recorder()
    trainer.run()
    trainer.spans.spans  # [(name, start_ns, end_ns, parent, iteration, attr)]

and the host loop hands it to its env and its host reads. Times are
`time.perf_counter_ns()`; `parent` is the index of the enclosing span (-1 at
the top), `iteration` the env step that starts the iteration the span
belongs to. The spans, with their attribute:

| Span | Site | Attribute |
| --- | --- | --- |
| `iteration` | `Trainer._host_loop`, top to top | the iteration's update count |
| `front` | `Trainer.front_of`: ring append, draws, one bulk sample | policy rows sampled |
| `updates` | `Trainer.run_updates`, all of an iteration's units | the iteration's update count |
| `update` | one unit of `run_updates`' loop: the update's views (`per_update`) and `update`, or one K-blocked `update_unit` with its slicing | updates in the unit (1, or K when K-blocked) |
| `env_step` | `HostEnv.step`, whole | envs |
| `wait` | the host blocking on the card: `HostReads.wait`, the actions' event in `HostEnv.step`, a pinned block's event in `HostEnv._block` | `WAIT_READS`, `WAIT_ACTIONS`, `WAIT_BLOCK` |

Under pipelined acting an iteration steps the envs for the next one: its
`env_step` carries the id of the iteration whose transitions it produces
(`Recorder.acting`), and the spans inside it inherit that id.

While a profiler window is open (`trainer.ProfilerWindow`, which sets
`profiling`), each span also enters `torch.profiler.record_function(name)`,
so the window's Chrome trace shows the spans beside the operators and
kernels. A window with no recorder set gets one that keeps nothing
(`keep=False`). The recorder writes no file of its own.
"""

import time
from typing import List, Optional, Tuple

import torch

WAIT_READS, WAIT_ACTIONS, WAIT_BLOCK = 0, 1, 2  # the `wait` span's attribute: where it blocks

now = time.perf_counter_ns  # the recorder's clock

Span = Tuple[str, int, int, int, int, int]  # name, start_ns, end_ns (-1 while open), parent, iteration, attr
_KEPT_NOTHING = (-1, None)


class Recorder:
    """Spans in memory, in the order they opened; see the module's
    docstring. Spans close in the reverse order they opened (`end` takes
    no argument)."""

    def __init__(self, keep: bool = True):
        self.keep = keep
        self.spans: List[Span] = []
        self.acting = 0  # the iteration the next env step produces for
        self.profiling = False  # a profiler window is open: enter record_function too
        self._open: List[Tuple[int, Optional[torch.profiler.record_function]]] = []

    def top(self, step: int, n_updates: int) -> None:
        """Open the `iteration` span of the iteration that starts at env
        step `step`; the loop closes it with `end` at the iteration's end."""
        self.acting = step
        self.begin("iteration", n_updates, step)

    def begin(self, name: str, attr: int = 0, iteration: Optional[int] = None) -> None:
        """Open a span inside the innermost open one. `iteration` None takes
        the enclosing span's, or `acting` at the top."""
        rf = None
        if self.profiling:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        if not self.keep:
            self._open.append(_KEPT_NOTHING if rf is None else (-1, rf))
            return
        parent = self._open[-1][0] if self._open else -1
        if iteration is None:
            iteration = self.spans[parent][4] if parent >= 0 else self.acting
        self._open.append((len(self.spans), rf))
        self.spans.append((name, now(), -1, parent, iteration, attr))

    def end(self) -> None:
        """Close the innermost open span."""
        t = now() if self.keep else 0
        i, rf = self._open.pop()
        if i >= 0:
            name, start, _, parent, iteration, attr = self.spans[i]
            self.spans[i] = (name, start, t, parent, iteration, attr)
        if rf is not None:
            rf.__exit__(None, None, None)
