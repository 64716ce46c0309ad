"""The port's host spans (`iltpu_torch.utils.spans`) read beside the profiled
sub-window's device trace, for the span metrics' readers.

What those readers take from `ctx`:

- `ctx["spans"]`: None where the recorder was off, else `{"spans": [(name,
  start_ns, end_ns, parent, iteration, attr), ...], "host_ns": (lo, hi)}`:
  the recorder's spans on `time.perf_counter_ns()`, and the window before
  the profiled sub-window on that clock, bounded by the iteration tops that
  bound `harness.window_facts`' iterations (`host_window_ns`).
- `ctx["trace"]`, the parsed sub-window (`trace.parse`), with what `attach`
  adds from the raw events: `h_marker`, the host's `time.perf_counter()` just
  after it launched the first marker kernel (the harness's tie, the only
  one), `tie_us`, the same moment on the trace's clock, and `launches`,
  (device start, host launch) in us on the trace's clock of every kernel,
  copy and memset between the markers, the launch taken from its
  `cuda_runtime` event through the `correlation` id (None where the trace
  holds none).

The tie's moment on the trace's clock is the end of the marker's launch
call, which the trace records beside the host's other calls: the first
launch after the profiler starts takes 0.4-4.5 ms on the H100's machine
(CUPTI), so the marker kernel's device start, which `trace.parse` pairs
with `h_marker` for its labels, lies that much before it. Where the trace
lost the first marker kernel, the trace's first kernel launch is its
launch; where it holds no launch at all, `tie_us` falls back to the
window's start.

A device idle gap is attributed by where the host was when the card ran
dry: its start, mapped to the host's clock through the tie, lies inside a
span of the name or not. A device event belongs to the span open when the
host launched it.
"""

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.trace import DEVICE_CATS, MARKER

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def attach(tr: Dict, events: List[Dict], h_marker: float) -> Dict:
    """Add the tie and the launches to a parsed sub-window, from its raw
    Chrome trace events."""
    w0, w1 = tr["window_us"]
    runtime = sorted((float(e["ts"]), float(e.get("dur", 0.0)), e.get("args", {}).get("correlation"),
                      e.get("name", "")) for e in events if e.get("cat") in RUNTIME_CATS)
    launched = {c: ts for ts, _, c, _ in runtime if c is not None}
    returned = {c: ts + dur for ts, dur, c, _ in runtime if c is not None}
    first = min(((float(e["ts"]), e.get("args", {}).get("correlation")) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and MARKER.search(e["name"])),
                default=(None, None))
    if first[0] == w0 and first[1] in returned:  # the first marker kernel, and its launch
        tie = returned[first[1]]
    else:
        tie = next((ts + dur for ts, dur, _, name in runtime if "LaunchKernel" in name), w0)
    tr["h_marker"], tr["tie_us"] = h_marker, tie
    tr["launches"] = sorted(
        (float(e["ts"]), launched.get(e.get("args", {}).get("correlation")))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and not MARKER.search(e["name"])
        and float(e["ts"]) >= w0 and float(e["ts"]) + float(e.get("dur", 0.0)) <= w1)
    return tr


def host_window_ns(run) -> Tuple[int, int]:
    """The window before the profiled sub-window, on the host's clock in ns:
    from the window's first iteration top to the sub-window's first (or the
    window's last), as `harness.window_facts` bounds its iterations."""
    tops = run.tops
    first = next(i for i, (s, _) in enumerate(tops) if s == run.step0)
    last = next(i for i, (s, _) in enumerate(tops) if s == run.step1 and i > first)
    cut = run.profiler.first_profiled() if run.profiler is not None else None
    end = last if cut is None else min(cut, last)
    return round(tops[first][1] * 1e9), round(tops[end][1] * 1e9)


def to_host_ns(tr: Dict, ts_us: float) -> int:
    """A time on the trace's clock (us) on the host's clock (ns), through
    the tie."""
    return round(tr["h_marker"] * 1e9 + (ts_us - tr["tie_us"]) * 1e3)


def idle_gaps(tr: Dict) -> List[Tuple[float, float]]:
    """(start, length) in us of each interval between the markers in which
    no device event ran."""
    w0, w1 = tr["window_us"]
    gaps, hi = [], w0
    for s, e, _ in sorted(tr["kernels"]):
        if s > hi:
            gaps.append((hi, s - hi))
        hi = max(hi, e)
    if w1 > hi:
        gaps.append((hi, w1 - hi))
    return gaps


class Intervals:
    """The spans of one name, which never overlap one another, for asking
    which holds a host time."""

    def __init__(self, spans: Sequence[tuple], name: str):
        self.spans = sorted(s for s in spans if s[0] == name)
        self.starts = [s[1] for s in self.spans]

    def holding(self, t_ns: int) -> Optional[tuple]:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        return self.spans[i] if i >= 0 and t_ns < self.spans[i][2] else None


def in_window(ctx: Dict, name: str) -> List[tuple]:
    """The spans of `name` that start in the host window before the
    sub-window; [] without spans."""
    got = ctx.get("spans")
    if not got:
        return []
    lo, hi = got["host_ns"]
    return [s for s in got["spans"] if s[0] == name and lo <= s[1] < hi]


def idle_in_pct(ctx: Dict, name: str) -> Optional[float]:
    """The share of the sub-window, in %, that the card sat idle in gaps
    that began while the host was inside a span of `name`."""
    tr, got = ctx.get("trace"), ctx.get("spans")
    if not tr or not got or "tie_us" not in tr:
        return None
    w0, w1 = tr["window_us"]
    held = Intervals(got["spans"], name)
    idle = sum(d for s, d in idle_gaps(tr) if held.holding(to_host_ns(tr, s)) is not None)
    return 100.0 * idle / (w1 - w0)
