"""Where an update's time goes on the card, for each training path.

    python -m iltpu_torch.profile_updates

Needs one CUDA card. For the GAIL per-update, GAIL update_block=16 and
GMMIL paths, AdRIL, DRIL and RED on the SAC kernel, and SAC with the
autograd update (`training.sac_pallas=false`), it builds a trainer at full
width (chip_smoke's configuration: pointmass, batch 256, widths 256 and 64;
no pretraining), fills the replay with 4 x 512
transitions, runs one warm-up iteration of 16 updates, then:

- times three iterations of 128 updates on the host clock, each twice:
  when `transition_core` returns (the host's issue time) and after a
  synchronise (the wall time), and reports the medians; issue close to
  wall means the host, not the card, sets the pace;
- traces one iteration of 64 updates with torch.profiler and reports the
  card's busy share (the union of its kernel intervals over the window from
  the first host event to the last kernel's end), the CUDA kernels launched
  per update summed over every kernel (memsets and copies counted apart),
  and the kernels with the most device time.

For the K-blocked path it also reports the GAIL step's share of a
micro-update. The trace cannot split the two: GAIL runs on one block of
the same kernel, beside SAC on the others. So the share is derived: the
per-update GAIL kernel's device time (from the GAIL path's trace) over the
K-blocked kernel's device time per micro-update; near 1, GAIL sets the
pace.

Prints one JSON line per path, then the share, then the card's name and
power limit.
"""

import json
import os
import subprocess
import time

import torch

from iltpu_torch.config import load_config
from iltpu_torch.trainer import Trainer

OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "outputs",
                       "profile_updates")
BASE = [
    "env=pointmass", "env_backend=jax", "num_envs=512", "training.sac_pallas=true",
    "memory.size=100000", "imitation.trajectories=5", "expert_data.source=synthetic",
]
PATHS = {
    "gail": ["algorithm=GAIL", "training.disc_pallas=true", "training.fused_update_scan=true"],
    "gail_kblock16": ["algorithm=GAIL", "training.disc_pallas=true",
                      "training.fused_update_scan=true", "training.update_block=16"],
    "gmmil": ["algorithm=GMMIL"],
    "adril": ["algorithm=AdRIL"],
    "dril": ["algorithm=DRIL"],
    "red": ["algorithm=RED"],
    "sac_autograd": ["algorithm=SAC", "training.sac_pallas=false"],
}


def busy_ms(prof):
    """(busy ms, window ms) of the card over the profiled window."""
    events = list(prof.events())
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type.name == "CUDA")
    start = min(e.time_range.start for e in events)
    busy, lo, hi = 0.0, kernels[0][0], kernels[0][1]
    for s, e in kernels[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy / 1e3, (kernels[-1][1] - start) / 1e3


def profile(name, extra, out_dir):
    from torch.profiler import ProfilerActivity, profile as trace

    dev = torch.device("cuda")
    t = Trainer(load_config(BASE + extra + [f"output_dir={out_dir}"]), out_dir=out_dir)
    S, A, N = t.state_size, t.action_size, t.cfg.num_envs
    g = torch.Generator(device=dev).manual_seed(0)

    def step_data():
        r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        return [r(N, S), torch.tanh(r(N, A)), r(N), r(N, S), torch.zeros(N, device=dev),
                torch.zeros(N, device=dev)]

    step = 0
    for n in (0, 0, 0, 0, 16):
        t.transition_core(step, *step_data(), n)
        step += N
    torch.cuda.synchronize()
    data = step_data()
    issue, wall = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        t.transition_core(step, *data, 128)
        issue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t.transition_core(step + N, *data, 64)
        torch.cuda.synchronize()
    busy, window = busy_ms(prof)
    device = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    counts = {"kernels": 0, "memsets": 0, "copies": 0}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            kind = ("memsets" if e.name.startswith("Memset") else
                    "copies" if e.name.startswith("Memcpy") else "kernels")
            counts[kind] += 1
    return {
        "path": name, "issue_ms_per_update": 1e3 * sorted(issue)[1] / 128,
        "wall_ms_per_update": 1e3 * sorted(wall)[1] / 128,
        "traced_busy_share": busy / window, "traced_device_ms_per_update": busy / 64,
        **{f"{k}_per_update": v / 64 for k, v in counts.items()},
        "top_kernels": [{"name": e.key[:60], "calls_per_update": e.count / 64,
                         "device_ms_per_call": e.self_device_time_total / 1e3 / e.count,
                         "device_ms_per_update": e.self_device_time_total / 1e3 / 64} for e in top],
    }


def _ms_per_call(result, kernel):
    """Device ms per call of the traced kernel whose name holds `kernel`."""
    for e in result["top_kernels"]:
        if kernel in e["name"]:
            return e["device_ms_per_call"]
    raise RuntimeError(f"profile_updates: no {kernel} among {result['path']}'s top kernels")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_updates: CUDA is not available; it measures the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    results = {}
    for name, extra in PATHS.items():
        results[name] = profile(name, extra, OUT_DIR)
        print(json.dumps(results[name]), flush=True)
    gail_ms = _ms_per_call(results["gail"], "gail_kernel")
    kblock_ms = _ms_per_call(results["gail_kblock16"], "kblock_kernel") / 16
    print(json.dumps({
        "gail_step_ms": gail_ms, "kblock_ms_per_micro_update": kblock_ms,
        "gail_share_of_micro_update": gail_ms / kblock_ms,
        "derived": "per-update GAIL kernel time over K-blocked time per micro-update; "
                   "the trace cannot split the K-blocked kernel",
    }))
    print(smi)


if __name__ == "__main__":
    main()
