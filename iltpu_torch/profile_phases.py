"""Where the time of one SAC update or one GAIL step goes on the card,
phase by phase.

    python -m iltpu_torch.profile_phases        # the SAC update
    python -m iltpu_torch.profile_phases gail   # the GAIL step
    python -m iltpu_torch.profile_phases gail --shape 1024,120,128 [--variant wide]
    python -m iltpu_torch.profile_phases pwil   # PWIL's transport

Needs one CUDA card. The SAC mode builds `csrc/sac_phases.cu` (the update of
`csrc/sac_update.cu` with a timestamp after each phase's barrier), runs a
full-width update (width 256) five times on a fresh state at pointmass's
(state 5, action 2, batch 256), hopper's (12, 3, 256) and ant's (112, 8,
1024) shapes, and prints one JSON line a shape: for each of the 21 phases
its median microseconds (barrier included) beside its items, its rounds of
items over the grid it runs on and its picks (each GEMM job's tile, each
column sum's width), the whole kernel's median microseconds, the update's
plan (`sac_update.plan`: barriers, row-owned items, the GEMM phases'
rounds), and the time of one bare barrier crossing over every block. The GAIL mode
builds `csrc/gail_phases.cu` (the step of `csrc/gail_update.cu` with a
barrier and a timestamp after each of its phases: six for a tiled step;
seven for the wide one's cluster, block 0's clock, where the segments'
partial sums, the cross-block reduction and AdamW each take one) and runs the bench
configuration (BCE, spectral norm, AIRL, penalty 1), five steps each after
a warm-up, at each `--shape B,D,Hd` (batch, input D = S + A, width; an
env's D takes its split, e.g. ant's 120 = 112 + 8) or, by default, at
pointmass's and hopper's (batch 256, D 7 and 15, width 64), at the wide
variant's corners (1024,120,128; 256,120,64; 1024,24,128; 1024,15,128) and
at hopper's 256,15,64 in both variants; `--variant tiled|wide` stamps that variant
at each `--shape` (default: the routed one). It prints one JSON line per
shape: the variant, the median microseconds of each phase and of the step
from its first stamp to its last. The PWIL mode builds
`csrc/pwil_phases.cu` (the transport kernel with each CTA's thread 0
summing the SM cycles of each phase of each row)
and runs the 25-segment relabelling (25,000 rows, 25,000 atoms of d 15),
PWIL@25's hopper-sized env step (512 pools x 25,000 atoms) and a
pointmass-sized one (512 x 505 atoms, d 7), printing one JSON line each:
the launch's time (CUDA events), the cluster size, passes a row, and the
microseconds a row of each phase averaged over the CTAs, with the bytes a
CTA's pass reads and the rate that gives; first, how many clusters of 2 to
8 CTAs the card holds at once. All modes end with the card's
name and power limit.
"""

import argparse
import ctypes
import json
import subprocess

import torch

from iltpu_torch.models import SoftActor, TwinCritic
from iltpu_torch.ops import build, operands
from iltpu_torch.ops import gail_update as gu
from iltpu_torch.ops import pwil_transport as pt
from iltpu_torch.ops import sac_update as su
from iltpu_torch.rewards import GAILDiscriminator
from iltpu_torch.updates import SACLearner

# One name a phase of `sac::sac_step`, in order; "rows:" marks a row-owned
# phase (a narrow product with the row step after it).
PHASES = (
    "actor L1 on s' and s", "actor L2", "rows: actor L3, head samples", "target L1", "target L2",
    "rows: target L3, TD target", "critic L1", "critic L2", "rows: critic L3, dq, dz2",
    "critic grad L2, dz1", "critic grad L1 and L3", "critic AdamW + Polyak", "updated critic L1",
    "updated critic L2", "rows: updated critic L3, select dq, dz2", "input grad L2",
    "rows: action grad, head backward, adz2", "actor grad L2, adz1", "actor grad L1 and L3",
    "actor AdamW", "temperature",
)
SAC_SHAPES = ((5, 2, 256), (12, 3, 256), (112, 8, 1024))
GAIL_PHASES = {
    "tiled": ("state and batch to shared memory, sigma", "loss rows", "penalty rows",
              "weight gradients, through sigma, AdamW", "power iteration", "reward rows"),
    "wide": ("state to shared memory, sigma", "loss rows", "penalty rows",
             "segment partials, cross-block sums and dots", "through sigma, AdamW",
             "new weights, power iteration", "reward rows"),
}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _bind(lib):
    if not hasattr(lib, "_typed"):
        P = ctypes.c_void_p
        lib.iltpu_phases_update.argtypes = su.ENTRY_ARGTYPES + [P, P]  # stamps, stream
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


def phases(lib, dev, runs=5, S=5, A=2, B=256):
    """Median us of each phase and of the whole update over `runs` updates."""
    h, st, batch, eps2, eps_new = _case(dev, S, A, B)
    shape = (B, S, A, st["a"][0].shape[1])
    outs = su.outputs(B, dev)  # held while the kernel writes them
    ptrs = su.pack(operands.Table(), st, batch, eps2, eps_new, outs)
    scratch = torch.empty(lib.iltpu_phases_scratch_floats(*shape), device=dev)
    args = su.entry_args(h, ptrs, shape, scratch)
    stamps = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=dev)
    stream = operands.stream(scratch.device)
    rows = []
    for _ in range(runs + 1):  # the first run warms up
        rc = lib.iltpu_phases_update(*args, stamps.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"profile_phases: launch failed with CUDA error {rc}")
        torch.cuda.synchronize()
        t = stamps.tolist()
        rows.append([(t[i + 1] - t[i]) / 1e3 for i in range(len(PHASES))])
    rows = rows[1:]
    return [_median(col) for col in zip(*rows)], _median([sum(r) for r in rows])


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


def _bind_gail(lib):
    if not hasattr(lib, "_typed"):
        head = gu.ENTRY_ARGTYPES + [ctypes.c_int]  # the variant
        lib.iltpu_gail_phases_update.argtypes = head + [ctypes.c_void_p] * 2  # stamps, stream
        lib.iltpu_gail_phases_update.restype = ctypes.c_int
        lib.iltpu_gail_phases_step.argtypes = head + [ctypes.c_void_p]  # stream
        lib.iltpu_gail_phases_step.restype = ctypes.c_int
        lib.iltpu_gail_phases_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.iltpu_gail_phases_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def variant_smem_bytes(B, D, Hd, variant):
    """The dynamic shared memory of a step of `variant` ('tiled' or 'wide')
    at (B, D, Hd); 0 where it cannot take the shape."""
    lib = _bind_gail(build.load("gail_phases"))
    return lib.iltpu_gail_phases_smem_bytes(B, D, Hd, gu.VARIANTS.index(variant))


def variant_step(variant, h, st, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix=None):
    """One unstamped GAIL step in place, as gail_update's kernel runs it but
    of `variant` ('tiled' or 'wide') whatever the route: to time the two at
    a shape both take. Returns (loss, rewards); gail_update's launch count
    does not move."""
    lib = _bind_gail(build.load("gail_phases"))
    B, S = p_s.shape
    loss, rewards = torch.empty(1, device=p_s.device), torch.empty(B, device=p_s.device)
    ptrs = gu.pack(operands.Table(), st, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix, (loss, rewards))
    rc = lib.iltpu_gail_phases_step(*gu.entry_args(h, st, mix, ptrs, B, S, p_a.shape[1]),
                                    gu.VARIANTS.index(variant), operands.stream(p_s.device))
    if rc != 0:
        raise RuntimeError(f"profile_phases: GAIL {variant} step failed with CUDA error {rc}")
    return loss, rewards


# (state, action) of the envs' discriminator inputs D = S + A
ENV_SPLIT = {5: (4, 1), 7: (5, 2), 15: (12, 3), 24: (18, 6), 120: (112, 8)}
GAIL_SHAPES = ((256, 7, 64, None), (256, 15, 64, None), (1024, 120, 128, None),
               (256, 120, 64, None), (1024, 24, 128, None), (1024, 15, 128, None),
               (256, 15, 64, "tiled"), (256, 15, 64, "wide"))


def gail_phases(lib, dev, S, A, B=256, Hd=64, runs=5, variant=None):
    """Median us of each phase and of the step over `runs` steps of the bench
    configuration, each on the state the last one left; `variant` ('tiled'
    or 'wide'; None: the routed one) as variant_step's."""
    g = torch.Generator(device=dev).manual_seed(S)
    h = gu.GAILHyper(1.0, 3e-5, 10.0, "AIRL", "BCE", 0.0)
    st = GAILDiscriminator(S, A, hidden_size=Hd, spectral_norm=True, reward_function="AIRL",
                           device=dev).init(g)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    u = lambda n: torch.rand(n, generator=g, device=dev)
    batch = [r(B, S), torch.tanh(r(B, A)), 1 + 0.5 * u(B), r(B, S), torch.tanh(r(B, A)),
             1 + 0.5 * u(B), u(B)]
    outs = (torch.empty(1, device=dev), torch.empty(B, device=dev))
    args = gu.entry_args(h, st, None, gu.pack(operands.Table(), st, *batch, None, outs), B, S, A)
    names = GAIL_PHASES[variant or gu.variant(B, S + A, Hd)]
    stamps = torch.zeros(len(names) + 1, dtype=torch.int64, device=dev)
    stream = operands.stream(stamps.device)
    rows = []
    for _ in range(runs + 1):  # the first run warms up
        rc = lib.iltpu_gail_phases_update(
            *args, -1 if variant is None else gu.VARIANTS.index(variant), stamps.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"profile_phases: GAIL launch failed with CUDA error {rc}")
        torch.cuda.synchronize()
        t = stamps.tolist()
        rows.append([(t[i + 1] - t[i]) / 1e3 for i in range(len(names))])
    rows = rows[1:]
    return [_median(col) for col in zip(*rows)], _median([sum(r) for r in rows])


PWIL_PHASES = ("row start", "selection pass", "CTA merge", "cluster exchange + merge", "walk",
               "write-back + refill")


def _bind_pwil(lib):
    if not hasattr(lib, "_typed"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.iltpu_pwil_transport.argtypes = pt.ENTRY_ARGTYPES + [P, P]  # stream, stamps
        lib.iltpu_pwil_transport.restype = I
        lib.iltpu_pwil_cluster_size.argtypes = [I, I]
        lib.iltpu_pwil_cluster_size.restype = I
        lib.iltpu_pwil_active_clusters.argtypes = [I]
        lib.iltpu_pwil_active_clusters.restype = I
        lib._typed = True
    return lib


def _cycles_per_us():
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    a.record()
    torch.cuda._sleep(50_000_000)
    b.record()
    torch.cuda.synchronize()
    return 50_000_000 / (1e3 * a.elapsed_time(b))


def pwil_phases(lib, dev, P, N, d, R, T, segments):
    """One stamped launch after a warm-up: per phase the us a row, averaged
    over the CTAs (each CTA's cycles over its rows)."""
    g = torch.Generator(device=dev).manual_seed(N)
    atoms = torch.randn(N, d, generator=g, device=dev)
    queries = 1.2 * torch.randn(R, d, generator=g, device=dev)
    if segments:
        L = R // P
        offsets = torch.arange(0, R + 1, L, dtype=torch.int32, device=dev)
        reset = torch.zeros(R, dtype=torch.bool, device=dev)
        reset[L - 1::L] = True
    else:
        offsets = torch.arange(P + 1, dtype=torch.int32, device=dev)
        reset = torch.ones(R, dtype=torch.bool, device=dev)
    pools = torch.full((P, N), 1.0 / N, device=dev)
    rewards = torch.empty(R, device=dev)
    C = lib.iltpu_pwil_cluster_size(P, N)
    if C < 1:
        raise RuntimeError(f"profile_phases: no cluster size for {P} pools (error {C})")
    stamps = torch.zeros(P * C, 8, dtype=torch.int64, device=dev)
    # the weights of PWIL's reward at its default scales (`rewards/pwil.py`)
    weights = dict(atom_weight=1.0 / N, agent_weight=1.0 / T - 1e-6, bandwidth=5.0 * T / d ** 0.5,
                   scale=5.0)
    args = (*pt.entry_args(atoms, pools, queries, offsets, reset, rewards, **weights),
            operands.stream(atoms.device), stamps.data_ptr())
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for timed in (False, True):  # every row resets or ends its segment: both do the same work
        stamps.zero_()
        a.record()
        if lib.iltpu_pwil_transport(*args) != 0:
            raise RuntimeError("profile_phases: PWIL launch failed")
        b.record()
        torch.cuda.synchronize()
    st = stamps.double()
    rows = st[:, 7].clamp(min=1)
    per_row = (st[:, :6] / rows[:, None]).mean(0) / _cycles_per_us()
    slice_atoms = -(-N // C)
    pass_bytes = slice_atoms * (d + 1) * 4
    passes = float((st[:, 6] / rows).mean())
    return {
        "shape": f"{P} pools x {N} atoms, d {d}, {R} rows", "launch_ms": a.elapsed_time(b),
        "cluster": C, "passes_a_row": round(passes, 3), "row_us": round(float(per_row.sum()), 3),
        "phases_us_a_row": {name: round(float(t), 3) for name, t in zip(PWIL_PHASES, per_row)},
        "pass_bytes_a_cta": pass_bytes,
        "pass_gb_s_a_cta": round(pass_bytes * passes / (1e3 * float(per_row[1])), 2),
    }


def _args(argv):
    parser = argparse.ArgumentParser(prog="python -m iltpu_torch.profile_phases")
    parser.add_argument("mode", nargs="?", default="sac", choices=("sac", "gail", "pwil"))
    parser.add_argument("--shape", action="append", default=[],
                        help="gail: B,D,Hd (batch, input S + A, width); repeatable")
    parser.add_argument("--variant", choices=gu.VARIANTS,
                        help="gail: the variant to stamp at each --shape")
    args = parser.parse_args(argv)
    shapes = []
    for text in args.shape:
        B, D, Hd = (int(x) for x in text.split(","))
        shapes.append((B, D, Hd, args.variant))
    return args.mode, shapes or list(GAIL_SHAPES)


def main(argv=None):
    mode, shapes = _args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_phases: CUDA is not available; it measures the card")
    dev = torch.device("cuda")
    if mode == "sac":
        lib = _bind(build.load("sac_phases"))
        bar, blocks = barrier_us(lib, dev)
        for S, A, B in SAC_SHAPES:
            per_phase, total = phases(lib, dev, S=S, A=A, B=B)
            plan = su.plan(build.load("sac_update"), B, S, A, 256, blocks)
            print(json.dumps({
                "shape": f"B={B} S={S} A={A} H=256", "update_us": total, "barrier_us": bar,
                "blocks": blocks, "plan": {k: plan[k] for k in ("phases", "row_items", "gemm_rounds")},
                "phases": {f"{i + 1:2d} {name}": {"us": round(t, 2), "items": n, "rounds": r,
                                                   "picks": " ".join(p)}
                           for i, (name, t, n, r, p) in enumerate(zip(
                               PHASES, per_phase, plan["items"], plan["rounds"], plan["picks"]))},
            }))
    elif mode == "pwil":
        lib = _bind_pwil(build.load("pwil_phases"))
        print(json.dumps({"clusters_at_once": {c: lib.iltpu_pwil_active_clusters(c)
                                               for c in range(2, 9)}}))
        for P, N, d, R, T, segments in ((25, 25000, 15, 25000, 1000, True),
                                        (512, 25000, 15, 512, 1000, False),
                                        (512, 505, 7, 512, 100, False)):
            print(json.dumps(pwil_phases(lib, dev, P, N, d, R, T, segments)))
    else:
        lib = _bind_gail(build.load("gail_phases"))
        for B, D, Hd, variant in shapes:
            S, A = ENV_SPLIT.get(D, (D - 1, 1))
            variant = variant or gu.variant(B, D, Hd)
            per_phase, total = gail_phases(lib, dev, S, A, B, Hd, variant=variant)
            print(json.dumps({
                "shape": f"B={B} S={S} A={A} Hd={Hd}", "variant": variant, "step_us": total,
                "smem_bytes": variant_smem_bytes(B, D, Hd, variant),
                "blocks": gu.blocks(B, D, Hd) if variant == gu.variant(B, D, Hd) else None,
                "phases_us": {f"{i} {name}": round(t, 2) for i, (name, t) in
                              enumerate(zip(GAIL_PHASES[variant], per_phase))},
            }))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)


if __name__ == "__main__":
    main()
