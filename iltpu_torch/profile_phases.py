"""Where the time of one SAC update goes on the card, phase by phase.

    python -m iltpu_torch.profile_phases

Needs one CUDA card. It builds `csrc/sac_phases.cu` (the update of
`csrc/sac_update.cu` with a timestamp after each phase's barrier), runs a
full-width update (pointmass: state 5, action 2; batch 256, width 256) five
times on a fresh state, and prints one JSON line: the median microseconds
of each of the 29 phases (barrier included) and of the whole kernel, and
the time of one bare barrier crossing over every block, then the card's
name and power limit.
"""

import ctypes
import json
import subprocess

import torch

from iltpu_torch.models import SoftActor, TwinCritic
from iltpu_torch.ops import build
from iltpu_torch.ops import sac_update as su
from iltpu_torch.updates import SACLearner

PHASES = (
    "actor L1 on s' and s", "actor L2", "actor L3", "head samples", "target L1", "target L2",
    "target L3", "TD target", "critic L1", "critic L2", "critic L3", "critic dq",
    "critic grad L3, dz2", "critic grad L2, dz1", "critic grad L1", "critic AdamW + Polyak",
    "updated critic L1", "updated critic L2", "updated critic L3", "select dq", "input grad L3",
    "input grad L2", "action grad", "head backward", "actor grad L3", "actor grad L2",
    "actor grad L1", "actor AdamW", "temperature",
)


def _bind(lib):
    if not hasattr(lib, "_typed"):
        P = ctypes.c_void_p
        lib.iltpu_phases_update.argtypes = [P] + [ctypes.c_int] * 4 + [ctypes.c_float] * 7 + [P] * 3
        lib.iltpu_phases_update.restype = ctypes.c_int
        lib.iltpu_phases_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.iltpu_phases_scratch_floats.restype = ctypes.c_longlong
        lib.iltpu_phases_barriers.argtypes = [P, ctypes.c_int, ctypes.c_int, P]
        lib.iltpu_phases_barriers.restype = ctypes.c_int
        lib._typed = True
    return lib


def _case(dev, S=5, A=2, B=256, H=256):
    g = torch.Generator(device=dev).manual_seed(0)
    learner = SACLearner(SoftActor(S, A, H, device=dev), TwinCritic(S, A, H, device=dev),
                         learning_rate=3e-4, weight_decay=1e-2, discount=0.97,
                         entropy_target=-0.5 * A, polyak_factor=0.99)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    batch = {"states": r(B, S), "actions": torch.tanh(r(B, A)), "rewards": r(B),
             "next_states": r(B, S), "terminals": torch.zeros(B, device=dev),
             "weights": torch.ones(B, device=dev), "absorbing": torch.zeros(B, device=dev)}
    return learner.hyper, learner.init(g), batch, r(B, A), r(B, A)


def phases(lib, dev, runs=5):
    """Median us of each phase and of the whole update over `runs` updates."""
    h, st, batch, eps2, eps_new = _case(dev)
    B, S = batch["states"].shape
    A, H = eps2.shape[1], st["a"][0].shape[1]
    ops = su._operands(st, batch, eps2, eps_new)
    outs = [torch.empty(B, device=dev), torch.empty(B, device=dev), torch.empty(1, device=dev)]
    ptrs = (ctypes.c_void_p * (len(ops) + 3))(*[t.data_ptr() for t in ops + outs])
    scratch = torch.empty(lib.iltpu_phases_scratch_floats(B, S, A, H), device=dev)
    stamps = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for _ in range(runs + 1):  # the first run warms up
        rc = lib.iltpu_phases_update(
            ptrs, B, S, A, H, h.lr, h.weight_decay, h.alpha_lr, h.discount, h.entropy_target,
            h.polyak, h.min_alpha, scratch.data_ptr(), stamps.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"profile_phases: launch failed with CUDA error {rc}")
        torch.cuda.synchronize()
        t = stamps.tolist()
        rows.append([(t[i + 1] - t[i]) / 1e3 for i in range(len(PHASES))])
    rows = rows[1:]
    median = lambda xs: sorted(xs)[len(xs) // 2]
    return [median(col) for col in zip(*rows)], median([sum(r) for r in rows])


def barrier_us(lib, dev, n=2000):
    """One crossing of the barrier over every block of a cooperative grid."""
    per_sm, sms, _ = su.grid(build.load("sac_update"), 256, 5, 2, 256)
    words = torch.zeros(4, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for timed in (False, True):
        if timed:
            a.record()
        if lib.iltpu_phases_barriers(words.data_ptr(), n, per_sm * sms, stream) != 0:
            raise RuntimeError("profile_phases: barrier launch failed")
        if timed:
            b.record()
        torch.cuda.synchronize()
    return 1e3 * a.elapsed_time(b) / n, per_sm * sms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_phases: CUDA is not available; it measures the card")
    dev = torch.device("cuda")
    lib = _bind(build.load("sac_phases"))
    per_phase, total = phases(lib, dev)
    bar, blocks = barrier_us(lib, dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "update_us": total, "barrier_us": bar, "blocks": blocks,
        "phases_us": {f"{i + 1:2d} {name}": round(t, 2) for i, (name, t) in
                      enumerate(zip(PHASES, per_phase))},
    }))
    print(smi)


if __name__ == "__main__":
    main()
