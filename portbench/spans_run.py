"""A traced run of one cell with the port's span recorder on, and its span
metrics: `run.py --trace 1` as it is, plus the six metrics read from the
port's host spans (`portbench/spans.py`).

    python3 portbench/spans_run.py --workload <name> --seed <n> --seconds <s> [--spans 0|1]

`run.py` leaves the recorder off in every run. Here it hands on from
outside what its trace runs would need to read the spans: `trainer.spans =
Recorder()` on the trainer `harness.build` returns, the tie and the launch
events of the sub-window's trace (`spans.attach` on what `trace.parse`
read), and `ctx["spans"]` for the readers. It prints the host-speed record
and the result line as `run.py` does, the span metrics among the per-layer
ones. `--spans 0` leaves the recorder off (the span metrics read nothing),
for the recorder's cost on the other metrics. `--dump PATH` also writes the
sub-window's spans and idle gaps, both on the host's clock, as JSON.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, run, spans  # noqa: E402
from portbench import trace as trace_mod  # noqa: E402

METRICS = (("update_issue_us", "us"), ("launches_per_update", "count"), ("front_ms", "ms"),
           ("host_wait_pct", "%"), ("idle_in_issue_pct", "%"), ("idle_in_env_pct", "%"))


def install(on: bool) -> dict:
    """Wrap the harness's build, the trace's parse and the readers' context
    for one run, with the recorder on or off; returns what the run keeps
    (the recorder, the host window, the parsed trace)."""
    from iltpu_torch.utils.spans import Recorder

    kept = {"recorder": Recorder() if on else None}
    build, parse, window_facts = harness.build, trace_mod.parse, harness.window_facts
    cell_metrics, reader = run.cell_metrics, run.reader

    def build_on(*args, **kwargs):
        trainer = build(*args, **kwargs)
        trainer.spans = kept["recorder"]
        return trainer

    def parse_kept(events, labels, h_marker):
        kept["trace"] = spans.attach(parse(events, labels, h_marker), events, h_marker)
        return kept["trace"]

    def facts_kept(r):
        kept["host_ns"] = spans.host_window_ns(r)
        return window_facts(r)

    def with_spans(bench, cell, trace):
        named = [{"name": n, "unit": u} for n, u in METRICS] if trace else []
        return cell_metrics(bench, cell, trace) + named

    def reader_with_spans(name):
        read = reader(name)
        rec = kept["recorder"]
        got = {"spans": rec.spans, "host_ns": kept.get("host_ns")} if rec is not None else None
        return lambda ctx: read(dict(ctx, spans=got))

    harness.build, trace_mod.parse, harness.window_facts = build_on, parse_kept, facts_kept
    run.cell_metrics, run.reader = with_spans, reader_with_spans
    return kept


def dump(kept: dict, path: str) -> None:
    """The spans that end inside the sub-window and its idle gaps, in ns
    on the host's clock from the sub-window's start (`start_ns`)."""
    tr = kept["trace"]
    lo, hi = (spans.to_host_ns(tr, t) for t in tr["window_us"])
    rec = kept["recorder"]
    out = {"window_ns": hi - lo, "start_ns": lo,
           "gaps": [(spans.to_host_ns(tr, s) - lo, round(d * 1e3)) for s, d in spans.idle_gaps(tr)],
           "spans": [(n, s - lo, e - lo, p, i, a) for n, s, e, p, i, a in
                     (rec.spans if rec is not None else []) if lo <= e and s <= hi]}
    with open(path, "w") as f:
        json.dump(out, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--dump")
    args = p.parse_args(argv)
    bench = run.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    run.T_START = T_START
    kept = install(bool(args.spans))
    result, lines, record = run.measure(bench, cells[args.workload], args.seed, args.seconds, True)
    if args.dump:
        dump(kept, args.dump)
    print(json.dumps({"host_record": record}), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
