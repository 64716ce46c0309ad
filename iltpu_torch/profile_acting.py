"""Where the host loop's time goes under each acting mode, on the card.

    python -m iltpu_torch.profile_acting [ROUNDS]

Needs one CUDA card. Runs chip_smoke's trainer configuration (GAIL on
pointmass, 512 envs, 4,096 steps, 1,024 of them before training.start, so
6 iterations of 512 updates; batch 256, widths 256 and 64) through
`Trainer.run`, per update (the kernels for GAIL and SAC) and with
training.update_block=16, in the plain, pipelined (`training.pipeline`)
and host-acting (`training.host_acting`) host loops, alternating the modes
for ROUNDS rounds (default 2). For each run it prints the steady
env-steps/s and the host's ms an iteration in each part of the loop, from
the trainer's own spans (`utils.spans.Recorder`): the `front` (ring
append, draws, bulk sample), issuing the `updates`, the `wait` for the
host reads, and the rest of the `iteration` (the act and the env step,
bookkeeping, the host actor); the array env has no `env_step` span. Then
one iteration's updates of the per-update path, plain and pipelined, under
torch.profiler: the host's self time of the top operators, per call. Ends
with the card's name and power limit.
"""

import os
import subprocess
import sys

import torch

from iltpu_torch.config import load_config
from iltpu_torch.ops import build
from iltpu_torch.trainer import Trainer
from iltpu_torch.utils.spans import Recorder

ARGS = [
    "algorithm=GAIL", "env=pointmass", "env_backend=jax", "num_envs=512", "steps=4096",
    "training.start=1024", "training.sac_pallas=true", "training.disc_pallas=true",
    "training.fused_update_scan=true", "memory.size=100000", "imitation.trajectories=5",
    "expert_data.source=synthetic", "evaluation.episodes=8", "logging.interval=0",
    "check_time_usage=true", "training.timing_skip_steps=2048", "training.timing_marks=2",
]
MODES = {
    "plain": [], "pipelined": ["training.pipeline=true"],
    "host_acting": ["training.host_acting=true"],
    "plain K=16": ["training.update_block=16"],
    "pipelined K=16": ["training.update_block=16", "training.pipeline=true"],
}
PARTS = ("front", "updates", "wait")


def parts(spans):
    """Host ms in each part, summed over the iterations, from the spans
    directly inside each `iteration`; the iterations' count."""
    ms = dict.fromkeys(PARTS + ("rest",), 0.0)
    iters = {i for i, s in enumerate(spans) if s[0] == "iteration"}
    for name, start, end, parent, _, _ in spans:
        if name == "iteration":
            ms["rest"] += 1e-6 * (end - start)
        elif name in PARTS and parent in iters:
            ms[name] += 1e-6 * (end - start)
    ms["rest"] -= sum(ms[k] for k in PARTS)
    return ms, len(iters)


def run(mode, out_dir, profile_at=None):
    """One run of `mode`; returns (steady env-steps/s, the spans); with
    `profile_at`, prints the profiler table of that update iteration."""
    t = Trainer(load_config(ARGS + MODES[mode] + [f"output_dir={out_dir}"]), out_dir=out_dir)
    t.spans = Recorder()
    if profile_at is not None:
        calls, inner = [0], t.run_updates

        def run_updates(*args):
            calls[0] += 1
            if calls[0] != profile_at:
                return inner(*args)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                out = inner(*args)
                torch.cuda.synchronize()
            print(f"{mode}: one iteration's updates, the host's top operators")
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=10))
            return out

        t.run_updates = run_updates
    t.run()
    m = t.metrics
    return m["steady_env_steps"] / m["steady_time"], t.spans.spans


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_acting needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    build.build_all()
    out = os.path.join("outputs", "profile_acting")
    for r in range(rounds):
        for mode in MODES:
            rate, spans = run(mode, os.path.join(out, mode.replace(" ", "_")))
            ms, iters = parts(spans)
            print(f"round {r} {mode}: steady {rate:.1f} env-steps/s; host ms an iteration: "
                  + ", ".join(f"{k} {v / iters:.2f}" for k, v in ms.items())
                  + f" (over {iters} iterations, 6 with updates)", flush=True)
    for mode in ("plain", "pipelined"):  # the steady window's first iteration
        run(mode, os.path.join(out, "profiled"), profile_at=5)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
