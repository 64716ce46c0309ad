"""The benchmark of `iltpu_torch`, the PyTorch and CUDA port: one run of one
cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It builds the cell's trainer from `portbench/configs/<config>.json` and
`portbench/traffic/<traffic>.json`, runs it through `Trainer.run`, measures
a window of `--seconds` after warm-up, checks what the window's trainer
computed against the plain reference (`portbench/correct.py`), and prints:
a host-speed record (one JSON line), then as the last line of standard
output the result, and as the last lines of standard error each number
compared beside its limit. With `--trace 0` the metrics are the cell's
end-to-end ones, with `--trace 1` its per-layer ones, each read by
`portbench/metrics/<name>.py`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# what a run's libraries cache stays in the checkout, at fixed paths
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, os.path.join(ROOT, ".portbench_cache", sub))

FORBIDDEN = ("jax", "jaxlib", "flax", "iltpu")  # top-level module names, compared whole


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def reader(name: str):
    """`portbench/metrics/<name>.py`'s `read`."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (trace 1)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(bench: dict, workload: dict, seed: int, seconds: float, trace: bool,
            extra=None) -> tuple:
    """One run of `workload`: (result, check lines, host record)."""
    import torch

    from portbench import harness, host
    from portbench import trace as trace_mod

    config = harness.load_named("configs", workload["config"])
    traffic = harness.load_named("traffic", workload["traffic"])
    out = harness.run_cell(config, traffic, seed, seconds, trace, T_START, extra)
    run, dev = out["run"], out["device"]
    ctx = {"window": out["window"], "facts": out["facts"], "trace": None}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
              "count": int(workload["chips"]), "memory_peak_bytes": int(out["memory_peak"])}
    result = {"correct": bool(out["checks"]["correct"]), "attempted": out["window"]["env_steps"],
              "failed": 0, "metrics": {}, "device": device}
    if trace:
        tr = run.profiler.read(run)
        ctx["trace"] = tr
        w0, w1 = tr["window_us"]
        device["busy_s"], device["window_s"] = tr["busy_us"] * 1e-6, (w1 - w0) * 1e-6
        result["breakdown"] = {"device_ops": trace_mod.device_ops(tr), "idle_gaps": tr["gaps"]}
    ctx.update(run.model.context(run))
    for m in cell_metrics(bench, workload["name"], trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    numbers = out["checks"]["numbers"]
    result["checks"] = {k: {"value": v, "limit": l} for k, (v, l) in numbers.items()}
    lines = [f"check {k}: {v!r} limit {l!r} {'ok' if v <= l else 'FAILED'}"
             for k, (v, l) in numbers.items()]
    if trace:
        lines.insert(0, f"trace: {tr['markers']} of 2 marker kernels found, window "
                        f"{device['window_s']!r} s, busy {device['busy_s']!r} s")
    return result, lines, host.record()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    workload = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, lines, record = measure(bench, workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"host_record": record}), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
