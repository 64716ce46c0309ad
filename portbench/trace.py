"""The profiled sub-window of a traced run, and the reading of its trace.

torch.profiler with CUDA activity alone (no host operators recorded, so the
host loop runs at its own pace) opens at an iteration's top near the
window's end (`lead_s` before it, after a device synchronise) and closes
at a later top, `seconds` later or at the window's close. It comes last,
and the host-clock metrics read the window before it, so that nothing of
the profiler touches them. The profiler's first start in a process stalls
the host for seconds (on the H100's machine ~7.5 s: loading and starting
CUPTI), so set-up makes one empty profiling pass first (`prepare`).
Two tiny marker kernels (`torch.cuda._sleep`) bound it on the device's
clock: one launched just after the profiler starts, on an idle device, the
other just before it stops. The first also ties the host's clock to the
device's, so each idle gap on the device is named by what the host loop
was doing when the device ran dry (the harness's own stamps: an
iteration's top, the end of its `front`, the stepper's C call).

The trace is written under TMPDIR, read, and deleted.
"""

import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional

import torch

MARKER_CYCLES = 100
MARKER = re.compile(r"spin_kernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each list of the breakdown


class SubWindow:
    def __init__(self, traffic: Dict, window_s: float):
        p = traffic["profile"]
        self.start_s, self.seconds = max(0.0, window_s - float(p["lead_s"])), float(p["seconds"])
        self.prof = None
        self.first = self.last = None
        self.h_marker = None

    @staticmethod
    def prepare() -> None:
        """One empty profiling pass, in set-up: the process's first start
        of CUPTI, which would stall the window's host loop."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()

    def at_top(self, elapsed: float, i: int, run) -> None:
        """The top of iteration `i`, `elapsed` seconds into the window."""
        if self.prof is None and self.first is None and elapsed >= self.start_s:
            run.sync()
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda._sleep(MARKER_CYCLES)
            self.h_marker = time.perf_counter()
            self.first = i
            run.probe_model()
        elif self.prof is not None and time.perf_counter() - self.h_marker >= self.seconds:
            self.stop(i, run)

    def stop(self, i: int, run) -> None:
        if self.prof is None or self.last is not None:
            return
        torch.cuda._sleep(MARKER_CYCLES)
        run.sync()
        self.prof.stop()
        self.last = i

    def first_profiled(self) -> Optional[int]:
        """The iteration the sub-window opened at: the host-clock metrics
        read the iterations before it."""
        return self.first

    def read(self, run) -> Dict:
        """Export, parse and delete the trace; the device events inside the
        markers and the host's labels."""
        if self.prof is None:
            raise RuntimeError("the profiled sub-window never opened: the window is shorter "
                               "than the traffic's profile.lead_s")
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return parse(events, host_labels(run, self.first, self.last), self.h_marker)


def host_labels(run, first: int, last: int) -> List[tuple]:
    """(host s, what the loop starts doing then) over the profiled
    iterations, in time order."""
    marks = []
    for i in range(first, last + 1):
        marks.append((run.tops[i][1], "front (append, sample)"))
    marks += [(t, "act, issue updates") for t in run.front_ends]
    for s, e in run.env_spans:
        marks += [(s, "env step (MuJoCo)"), (e, "pack, copy, reads, loop")]
    return sorted(marks)


def short(name: str) -> str:
    """A kernel's name without namespaces, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    base = name.split("(")[0].split("<")[0].split("::")[-1].strip()
    return base or name


def parse(events: List[Dict], labels: List[tuple], h_marker: float) -> Dict:
    """The device events between the two markers (us on the device's
    clock), the window, its busy union and idle gaps, each gap named by
    the host label at its start."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                 for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    markers = [d for d in dev if MARKER.search(d[2])]
    if not dev:
        raise RuntimeError("the trace holds no device event")
    # the markers bound the window; where CUPTI lost one, the first or last
    # device event stands in (the host had just launched it, or waited for it)
    w0, w1 = dev[0][0], max(d[1] for d in dev)
    if markers and markers[0][0] - w0 <= 0.01 * (w1 - w0):
        w0 = markers[0][0]
    if markers and w1 - markers[-1][1] <= 0.01 * (w1 - w0):
        w1 = markers[-1][1]
    inside = [d for d in dev if d[0] >= w0 and d[1] <= w1]
    busy, gaps = 0.0, []
    lo, hi, last = inside[0]
    for s, e, n in inside[1:]:
        if s > hi:
            busy += hi - lo
            gaps.append((s - hi, hi, last))
            lo, hi, last = s, e, n
        elif e > hi:
            hi, last = e, n
    busy += hi - lo

    def label(ts_us: float) -> str:
        t = h_marker + (ts_us - w0) * 1e-6
        what = "before the first stamp"
        for when, name in labels:
            if when > t:
                break
            what = name
        return what

    gaps.sort(reverse=True)
    return {
        "markers": len(markers), "window_us": (w0, w1), "busy_us": busy, "kernels": [d for d in inside
                                                            if not MARKER.search(d[2])],
        "gaps": [[f"{label(at)} (after {short(after)})", dur * 1e-6]
                 for dur, at, after in gaps[:TOP]],
    }


def device_ops(tr: Dict, top: int = TOP) -> List[list]:
    """The device operations that took most time in the sub-window, by name."""
    by = {}
    for s, e, n in tr["kernels"]:
        by[short(n)] = by.get(short(n), 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def launches(tr: Dict, pattern: str) -> List[float]:
    """The device time, in seconds, of each launch whose name matches."""
    rx = re.compile(pattern)
    return [(e - s) * 1e-6 for s, e, n in tr["kernels"] if rx.search(n)]
