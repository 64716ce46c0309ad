"""The readings the limits of `correct` are set from, for one cell, in one
process: the program's numbers over many seeds, and those of the control
and of each planted fault (`portbench/faults.py`) over a few.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --modes program,control,sac_unchanged --seconds 2 [--out file.jsonl]

Each (mode, seed) is a whole run through the harness (set-up, a short
window, the check), so the numbers come from the trainer the window ran.
Prints one JSON line a run; `--out` appends them to a file too. Needs the
card, as a run does; the benchmark's own runs never run this. A cell that
BENCHMARK.json does not list (a queued one) is named `<config>.<traffic>`
and runs on one card, from its files alone.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def reading(workload: dict, mode: str, seed: int, seconds: float, extra=None) -> dict:
    """One run of `workload` with `mode` planted ("program": none)."""
    import contextlib

    from portbench import faults, harness

    config = harness.load_named("configs", workload["config"])
    traffic = harness.load_named("traffic", workload["traffic"])
    plant = contextlib.nullcontext() if mode == "program" else faults.planted(mode)
    t = time.perf_counter()
    with plant:
        out = harness.run_cell(config, traffic, seed, seconds, False, t, extra)
    ch = out["checks"]
    return {"workload": workload["name"], "mode": mode, "seed": seed,
            "numbers": {k: v for k, (v, _) in ch["numbers"].items()},
            "correct": ch["correct"], "detail": ch["detail"],
            "env_steps_per_s": out["window"]["env_steps"] / out["window"]["seconds"],
            "run_s": time.perf_counter() - t}


def workload_of(name: str) -> dict:
    """The cell `name` of BENCHMARK.json, else the one its files make."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        listed = {w["name"]: w for w in json.load(f)["workloads"]}
    if name in listed:
        return listed[name]
    config, traffic = name.split(".", 1)
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--modes", default="program", help="comma-separated: program, " +
                   "control or a fault of portbench/faults.py")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    workload = workload_of(args.workload)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps(reading(workload, mode, seed, args.seconds))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
