#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`iltpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, nvcc and nothing
of JAX or `iltpu`. Phases, each printing its results:

1. device: the card's name and power limit (nvidia-smi);
2. build: the four kernels from `iltpu_torch/csrc/` (sac_update,
   gail_update, kblock_update, gaussian_rowsum), one nvcc each, in
   parallel; each one's `-Xptxas -v` register lines (and any spills), the
   GAIL step's shared memory at both shapes, and the cooperative grid
   (blocks per SM) and dynamic shared memory of the SAC and K-blocked
   kernels;
3. kernels: each per-update kernel against its plain PyTorch version on the
   card, one step and a 5-step chain, at the main path's shapes (pointmass:
   state 5, action 2) and at hopper's (state 12, action 3), batch 256, width
   256, discriminator width 64; SAC with min_alpha 0 and 0.05, GAIL with the
   bench configuration (BCE, spectral norm, AIRL, penalty 1, weight decay
   10, lr 3e-5) and the tuned one (Mixup, entropy 0.0248, AIRL), and the
   GAIL step's other variants (inputs up to 32, widths 16 to 128, a ragged
   batch) for one step and the chain. Tolerance:
   |kernel - plain| <= atol + rtol |plain| with rtol 2e-5 / atol 2e-6 for one
   step and 1e-4 / 1e-5 for the chain (fp32, summed in another order); SAC
   also at batch 1024, past the GEMM's whole-depth panels. Each kernel is
   timed twice: on the device alone (the median of CUDA events around each
   of 60 calls queued while a sleep kernel holds the stream) and
   host-paced (the same without the hold);
3b. the K-blocked kernel at K = 1 (GAIL and SAC with no overlap), 2 (one
   hand-over of rewards) and 16 against K calls of the two per-update
   kernels (the same arithmetic: it must be bit-identical) and at K=5
   against its plain version (the chain tolerance), at both shapes, for
   both GAIL configurations x min_alpha 0 and 0.05; times per launch and
   per micro-update at K=16 beside the plain version's and the 16
   per-update calls';
3c. the row-sum kernel: one row sum (centred outside) and GMMIL's fused
   reward (one launch) against their plain versions at GMMIL's 256 x 256
   (D = 7 and 15) and at 256 x 10,001 expert rows (the y loop and a ragged
   edge), at rtol 1e-5 / atol 1e-6 (the sums run in another order);
4. reference: the port's transition_core on the card against the same code
   on the CPU (plain versions), same state and draws, 3 iterations x 8
   updates, at 1e-4 / 1e-5: GAIL per update, GAIL with update_block=4 (two
   K-blocked launches an iteration) and GMMIL;
5. trainer: a GAIL-pointmass run through `iltpu_torch.trainer.Trainer` with
   512 envs, 4096 steps and ~3k updates at the default widths, with the
   launch counters set to 0 just before and checked against the update
   count just after; prints the steady env-steps/s;
5b. the same with training.update_block=16: the K-blocked kernel runs the
   iterations whose update count 16 divides, the per-update kernels the
   rest;
5c. GMMIL-pointmass at the same size: one fused reward launch and one SAC
   launch per update, no GAIL launch and no single row-sum launch.

Then the three steady rates with the nvidia-smi line, one `kernels` JSON
line, the nvidia-smi line, and as the last line {"ok": true, "device":
{...}}. Any failure raises and exits non-zero, and without CUDA or without
the package beside it the script exits 1 at once.
"""

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MEM_RATE = 3.35e12  # bytes/s, H100 SXM HBM3
FP32_RATE = 67e12  # FLOP/s, H100 SXM fp32 without tensor cores
TOL_STEP = (2e-5, 2e-6)
TOL_CHAIN = (1e-4, 1e-5)

TRAINER_ARGS = [
    "algorithm=GAIL", "env=pointmass", "env_backend=jax", "num_envs=512", "steps=4096",
    "training.start=1024", "training.sac_pallas=true", "training.disc_pallas=true",
    "training.fused_update_scan=true", "memory.size=100000", "imitation.trajectories=5",
    "expert_data.source=synthetic", "evaluation.episodes=8", "logging.interval=0",
    "check_time_usage=true", "training.timing_skip_steps=2048", "training.timing_marks=2",
]


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def clone(st):
    return {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in st.items()}


def leaves(st):
    for k, v in st.items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            yield f"{k}[{i}]", t


# parameter leaf -> (its AdamW first and second moments, its step clock)
MOMENTS = {"a": ("am", "av", "ta"), "c": ("cm", "cv", "tc"), "la": ("lam", "lav", "tal"),
           "p": ("m", "v", "t")}
ILL_CONDITIONED = 100 * 1e-8  # sqrt(v_hat) below 100 eps


def compare(name, got, want, tol, got_state=None, want_state=None):
    """Raise unless every element is within tol; return the max abs error
    and the max rel error (over elements where |plain| >= 1e-3).

    The one exception is named, not hidden: a parameter element past tol
    whose AdamW moments m and v agree at tol in both versions and whose
    sqrt(v_hat) is below 100 eps. There the step m_hat / (sqrt(v_hat) + eps)
    turns a rounding-level difference of the gradient into a visible
    fraction of lr (on the first step it is lr sign(g)). At most 8 such
    elements are allowed per comparison, and each is printed."""
    rtol, atol = tol
    worst, worst_rel, named, unexplained = 0.0, 0.0, [], []
    for (path, g), (_, w) in zip(got, want):
        if g.numel() == 0:
            continue
        g = g.to(w.device)
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        big = w.abs() >= 1e-3
        if bool(big.any()):
            worst_rel = max(worst_rel, float((err[big] / w.abs()[big]).max()))
        bad = (err > atol + rtol * w.abs()).flatten().nonzero().flatten().tolist()
        for i in bad:
            what = f"{path} flat {i}: kernel {float(g.flatten()[i])!r} plain {float(w.flatten()[i])!r}"
            key, _, j = path.rstrip("]").partition("[")
            if got_state is None or key not in MOMENTS:
                unexplained.append(what)
                continue
            mk, vk, tk = MOMENTS[key]
            j = int(j or 0)
            m = [st[mk] if not isinstance(st[mk], list) else st[mk][j] for st in (got_state, want_state)]
            v = [st[vk] if not isinstance(st[vk], list) else st[vk][j] for st in (got_state, want_state)]
            m, v = [x.flatten()[i].item() for x in m], [x.flatten()[i].item() for x in v]
            t = float(want_state[tk][0])
            sqrt_vhat = (v[1] / (1 - 0.999**t)) ** 0.5
            agree = all(abs(a - b) <= atol + rtol * abs(b) for a, b in (m, v))
            entry = f"{what}, m {m[0]!r}/{m[1]!r}, sqrt(v_hat) {sqrt_vhat:.3g}"
            (named if agree and sqrt_vhat < ILL_CONDITIONED else unexplained).append(entry)
    if unexplained or len(named) > 8:
        raise AssertionError(
            f"{name}: past rtol {rtol} atol {atol}: " + "; ".join((unexplained or named)[:8])
        )
    if named:
        print(f"{name}: {len(named)} element(s) past rtol {rtol} atol {atol} only through "
              f"an ill-conditioned AdamW step (moments agree): " + "; ".join(named))
    return worst, worst_rel


def worse(a, b):
    return tuple(max(x, y) for x, y in zip(a, b))


def median_ms(fn, n=60):
    """Host-paced time of a call: the median of CUDA events recorded around
    each of n back-to-back calls, so a call the device finishes before the
    host issues the next one is timed at the host's pace."""
    import torch

    for _ in range(5):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[n // 2]


_CYCLES_PER_MS = []


def cycles_per_ms():
    """The clock of torch.cuda._sleep, measured once with events."""
    import torch

    if not _CYCLES_PER_MS:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        cycles = 50_000_000
        torch.cuda._sleep(cycles)  # warm-up
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(cycles / a.elapsed_time(b))
    return _CYCLES_PER_MS[0]


def device_ms(fn, n=60):
    """Device time of a call: the median of CUDA events recorded around each
    of n calls while a sleep kernel holds the stream, long enough for the
    host to queue them all, so no pair of events brackets the device waiting
    for the host. (Where the queue of launches fills, the host waits for the
    device instead, and the device then never waits: the pairs still time
    the device alone.)"""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    hold_ms = 3e3 * (time.perf_counter() - t0) + 20.0  # three times the paced run
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(int(hold_ms * cycles_per_ms()))
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[n // 2]


def sac_case(S, A, B, H, min_alpha, seed, dev):
    import torch
    from iltpu_torch.models import SoftActor, TwinCritic
    from iltpu_torch.updates import SACLearner

    g = torch.Generator(device=dev).manual_seed(seed)
    learner = SACLearner(SoftActor(S, A, H, device=dev), TwinCritic(S, A, H, device=dev),
                         learning_rate=3e-4, weight_decay=1e-2, discount=0.97,
                         entropy_target=-0.5 * A, polyak_factor=0.99, min_alpha=min_alpha)
    st = learner.init(g)
    if min_alpha:
        st["la"].fill_(-6.0)  # the floor is active

    def batch():
        absorbing = (torch.rand(B, generator=g, device=dev) < 0.1).float()
        s = torch.randn(B, S, generator=g, device=dev)
        s[:, -1] = absorbing
        return {
            "states": s, "actions": torch.tanh(torch.randn(B, A, generator=g, device=dev)),
            "rewards": torch.randn(B, generator=g, device=dev),
            "next_states": torch.randn(B, S, generator=g, device=dev),
            "terminals": (torch.rand(B, generator=g, device=dev) < 0.05).float(),
            "weights": torch.ones(B, device=dev), "absorbing": absorbing,
        }, torch.randn(B, A, generator=g, device=dev), torch.randn(B, A, generator=g, device=dev)

    return learner.hyper, st, [batch() for _ in range(5)]


def check_sac(S, A, min_alpha, dev, B=256, timed=True):
    from iltpu_torch.ops.sac_update import sac_update, sac_update_plain

    hyper, st, steps = sac_case(S, A, B, 256, min_alpha, 1 + S, dev)
    worst = (0.0, 0.0)
    for n, tol in ((1, TOL_STEP), (5, TOL_CHAIN)):
        k_st, p_st = clone(st), clone(st)
        for i in range(n):
            b, e2, en = steps[i]
            ka = sac_update(hyper, k_st, b, e2, en)
            pa = sac_update_plain(hyper, p_st, b, e2, en)
        worst = worse(worst, compare(f"sac S={S} A={A} B={B} min_alpha={min_alpha} {n}-step", [
            *leaves(k_st), *leaves(ka)], [*leaves(p_st), *leaves(pa)], tol, k_st, p_st))
    if not timed:
        return worst, None
    b, e2, en = steps[0]
    k_st, p_st = clone(st), clone(st)
    ms = device_ms(lambda: sac_update(hyper, k_st, b, e2, en))
    paced_ms = median_ms(lambda: sac_update(hyper, k_st, b, e2, en))
    plain_ms = median_ms(lambda: sac_update_plain(hyper, p_st, b, e2, en))
    return worst, (ms, paced_ms, plain_ms)


def bound_ms(flops, nbytes):
    """The least time for the work: operations over the fp32 rate against
    bytes over the memory rate, the larger; and which one it is."""
    t_ops, t_bytes = flops / FP32_RATE, nbytes / MEM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def sac_flops(S, A, B, H):
    """The products of one update (2 FLOP a multiply-add; the elementwise
    work is under 1% of them)."""
    X, O = S + A, 2 * A
    actor_fwd = 2 * B * (S * H + H * H + H * O)
    twin_fwd = 2 * 2 * B * (X * H + H * H + H)
    critic_bwd = 2 * 2 * (H * B + B * H + H * H * B + B * H * H + X * H * B)
    input_grad = 2 * 2 * (B * H + B * H * H + B * A * H)
    actor_bwd = 2 * (H * O * B + B * H * O + H * H * B + B * H * H + S * H * B)
    return 2 * actor_fwd + 3 * twin_fwd + critic_bwd + input_grad + actor_bwd


def sac_bound_ms(S, A, B, H):
    """The products over the fp32 rate, against each input read and each
    output written once over the memory rate."""
    X, O = S + A, 2 * A
    actor = S * H + H + H * H + H + H * O + O
    critic = 2 * (X * H + H + H * H + H + H + 1)
    state = 3 * actor + 4 * critic + 6
    batch = B * (2 * S + A + 4) + 2 * B * A
    return bound_ms(sac_flops(S, A, B, H), 4 * (2 * state + batch + 2 * B + 1))


def numel(ts):
    return sum(t.numel() for t in ts)


def gail_case(S, A, B, bce, seed, dev, Hd=64, sn=None, **changes):
    """The bench configuration (bce) or the tuned one, with `changes` to
    the hyperparameters and `sn` to the spectral norm where given."""
    import torch
    from iltpu_torch.ops.gail_update import GAILHyper
    from iltpu_torch.rewards import GAILDiscriminator

    g = torch.Generator(device=dev).manual_seed(seed)
    if bce:  # the bench configuration (algorithms.yaml GAIL)
        hyper = GAILHyper(1.0, 3e-5, 10.0, "AIRL", "BCE", 0.0)
    else:  # the tuned GAIL@10 configuration
        hyper = GAILHyper(0.436, 1.3089e-4, 0.687, "AIRL", "Mixup", 0.0248)
    hyper = hyper._replace(**changes)
    sn = bce if sn is None else sn
    disc = GAILDiscriminator(S, A, hidden_size=Hd, spectral_norm=sn,
                             reward_function=hyper.reward_function, device=dev)
    st = disc.init(g)

    def step():
        r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        u = lambda n: torch.rand(n, generator=g, device=dev)
        args = [r(B, S), torch.tanh(r(B, A)), 1 + 0.5 * u(B), r(B, S), torch.tanh(r(B, A)),
                1 + 0.5 * u(B), u(B)]
        return args, (None if bce else u(B))

    return hyper, st, [step() for _ in range(5)]


def check_gail(S, A, bce, dev, B=256, Hd=64, timed=True, **case):
    from iltpu_torch.ops.gail_update import gail_update, gail_update_plain

    hyper, st, steps = gail_case(S, A, B, bce, 7 + S, dev, Hd, **case)
    worst = (0.0, 0.0)
    for n, tol in ((1, TOL_STEP), (5, TOL_CHAIN)):
        k_st, p_st = clone(st), clone(st)
        for i in range(n):
            args, mix = steps[i]
            kl, kr = gail_update(hyper, k_st, *args, mix)
            pl, pr = gail_update_plain(hyper, p_st, *args, mix)
        worst = worse(worst, compare(
            f"gail S={S} A={A} B={B} Hd={Hd} {hyper} sn={bool(st['sn'])} {n}-step",
            [*leaves(k_st), ("loss", kl), ("rewards", kr)],
            [*leaves(p_st), ("loss", pl), ("rewards", pr)], tol, k_st, p_st))
    if not timed:
        return worst, None, None
    args, mix = steps[0]
    k_st, p_st = clone(st), clone(st)
    ms = device_ms(lambda: gail_update(hyper, k_st, *args, mix))
    paced_ms = median_ms(lambda: gail_update(hyper, k_st, *args, mix))
    plain_ms = median_ms(lambda: gail_update_plain(hyper, p_st, *args, mix))
    return worst, (ms, paced_ms, plain_ms), (hyper, st, args, mix)


# The GAIL step's other variants (inputs padded to 8, 16 or 32 features,
# widths to 1, 2 or 4 warps' lanes; W~1 from shared memory where both are
# large), a ragged batch, the GAIL and FAIRL heads, no penalty, and Mixup
# with spectral norm: (S, A, B, Hd, bce, changes to gail_case).
GAIL_VARIANTS = (
    (3, 1, 256, 16, True, {"grad_penalty": 0.0, "reward_function": "GAIL"}),
    (5, 2, 256, 128, False, {"sn": True, "reward_function": "FAIRL"}),
    (12, 3, 256, 32, True, {}), (12, 3, 256, 128, True, {}), (21, 7, 256, 32, False, {}),
    (18, 6, 256, 64, True, {}), (12, 3, 100, 64, False, {}),
)


def gail_flops(B, Hd, st, args, mix):
    """The products of one step (the penalty's W~1^T g product only for the
    hidden units this data switches on)."""
    import torch

    e_s, e_a, e_w, p_s, p_a, p_w, eps_gp = args
    D = e_s.shape[1] + e_a.shape[1]
    R = 2 * B if mix is None else B
    W1, b1 = st["p"][0], st["p"][1]
    gx = eps_gp[:, None] * torch.cat([e_s, e_a], 1) + (1 - eps_gp[:, None]) * torch.cat([p_s, p_a], 1)
    active = float(((gx @ W1 + b1) > 0).float().mean())  # sigma > 0 keeps the sign
    flops = 2 * R * (D * Hd + Hd)  # loss rows
    flops += 2 * B * D * Hd * (2 + active)  # penalty rows: forward, g, W~1^T g
    flops += 2 * (R + B) * (D * Hd + Hd)  # weight gradients
    return flops + 2 * B * (D * Hd + Hd) + 4 * D * Hd  # reward rows, power iteration


def gail_bound_ms(S, A, B, Hd, case):
    """The products over the fp32 rate, against each input read and each
    output written once over the memory rate."""
    hyper, st, args, mix = case
    D = S + A
    params = D * Hd + 2 * Hd + 1
    state = 3 * params + (2 * Hd + D + 1 if st["sn"] else 0) + 1
    batch = 2 * B * (D + 1) + B + (0 if mix is None else B)
    return bound_ms(gail_flops(B, Hd, st, args, mix), 4 * (2 * state + batch + B + 1))


def kblock_case(S, A, K, bce, min_alpha, dev):
    """Full-width SAC and GAIL states and K-stacked batches and noise."""
    import torch

    B = 256
    sac_hyper, sac_st, _ = sac_case(S, A, B, 256, min_alpha, 1 + S, dev)
    gail_hyper, disc_st, _ = gail_case(S, A, B, bce, 7 + S, dev)
    g = torch.Generator(device=dev).manual_seed(31 + S + K)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    absorbing = (u(K, B) < 0.1).float()
    states = r(K, B, S)
    states[..., -1] = absorbing
    batches = {"states": states, "actions": torch.tanh(r(K, B, A)), "next_states": r(K, B, S),
               "terminals": (u(K, B) < 0.05).float(), "weights": 1 + 0.5 * u(K, B),
               "absorbing": absorbing}
    expert = {"states": r(K, B, S), "actions": torch.tanh(r(K, B, A)), "weights": 1 + 0.5 * u(K, B)}
    noise = {"eps_gp": u(K, B), "eps2": r(K, B, A), "eps_new": r(K, B, A)}
    if not bce:
        noise["mix"] = u(K, B)
    return sac_hyper, gail_hyper, sac_st, disc_st, batches, expert, noise


def per_update_calls(sac_hyper, gail_hyper, sac_st, disc_st, batches, expert, noise):
    """K calls of the two per-update kernels, in order; the last aux."""
    from iltpu_torch.ops.gail_update import gail_update
    from iltpu_torch.ops.sac_update import sac_update

    mix = noise.get("mix")
    for k in range(batches["states"].shape[0]):
        tb = {key: v[k] for key, v in batches.items()}
        loss, tb["rewards"] = gail_update(
            gail_hyper, disc_st, expert["states"][k], expert["actions"][k], expert["weights"][k],
            tb["states"], tb["actions"], tb["weights"], noise["eps_gp"][k],
            None if mix is None else mix[k])
        aux = sac_update(sac_hyper, sac_st, tb, noise["eps2"][k], noise["eps_new"][k])
    return {"loss": loss, "rewards": tb["rewards"], **aux}


def check_kblock(S, A, bce, min_alpha, dev, timed):
    """K = 1, 2 and 16 against K per-update calls (bit-identical? K=1 runs
    GAIL and SAC with no overlap, K=2 hands the rewards over once) and K=5
    against the plain version; with `timed`, the times and the bound at
    K=16. Returns the worst error, {K: bit-identical} and the times."""
    import torch
    from iltpu_torch.ops import gail_update as gu
    from iltpu_torch.ops import sac_update as su
    from iltpu_torch.ops.kblock_update import _batch_operands, kblock_update, kblock_update_plain

    name = f"kblock S={S} A={A} {'BCE' if bce else 'Mixup'} min_alpha={min_alpha}"
    worst, same, out = (0.0, 0.0), {}, None
    for K, tol, reference in ((1, TOL_STEP, per_update_calls), (2, TOL_STEP, per_update_calls),
                              (16, TOL_STEP, per_update_calls), (5, TOL_CHAIN, kblock_update_plain)):
        sh, gh, sac_st, disc_st, batches, expert, noise = kblock_case(S, A, K, bce, min_alpha, dev)
        k_sac, k_disc, r_sac, r_disc = clone(sac_st), clone(disc_st), clone(sac_st), clone(disc_st)
        ka = kblock_update(sh, gh, k_sac, k_disc, batches, expert, noise)
        ra = reference(sh, gh, r_sac, r_disc, batches, expert, noise)
        torch.cuda.synchronize()
        what = f"{name} K={K} vs {reference.__name__}"
        for part in (compare(f"{what} sac", leaves(k_sac), leaves(r_sac), tol, k_sac, r_sac),
                     compare(f"{what} disc", leaves(k_disc), leaves(r_disc), tol, k_disc, r_disc),
                     compare(f"{what} aux", ka.items(), ra.items(), tol)):
            worst = worse(worst, part)
        if reference is per_update_calls:
            got = [t for _, t in (*leaves(k_sac), *leaves(k_disc), *ka.items())]
            want = [t for _, t in (*leaves(r_sac), *leaves(r_disc), *ra.items())]
            names = [n for n, _ in (*leaves(k_sac), *leaves(k_disc), *ka.items())]
            diff = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
            same[K] = not diff
            if diff:
                print(f"{what}: not bit-identical in {len(diff)} of {len(names)} tensors: "
                      f"{', '.join(diff[:12])}")
            if timed and K == 16:
                args = (sh, gh, clone(sac_st), clone(disc_st), batches, expert, noise)
                ms = device_ms(lambda: kblock_update(*args), n=20)
                paced_ms = median_ms(lambda: kblock_update(*args), n=20)
                per_ms = device_ms(lambda: per_update_calls(*args), n=5)
                plain_ms = median_ms(lambda: kblock_update_plain(*args), n=10)
                flops = K * sac_flops(S, A, 256, 256) + sum(
                    gail_flops(256, 64, disc_st, [expert["states"][k], expert["actions"][k],
                                                 expert["weights"][k], batches["states"][k],
                                                 batches["actions"][k], batches["weights"][k],
                                                 noise["eps_gp"][k]],
                               None if bce else noise["mix"][k]) for k in range(K))
                state = su.state_tensors(sac_st) + gu.state_tensors(disc_st)
                nbytes = 4 * (2 * numel(state) + numel(_batch_operands(batches, expert, noise))
                              + 3 * 256 + 2)
                out = (ms, paced_ms, per_ms, plain_ms, *bound_ms(flops, nbytes))
    return worst, same, out


def rowsum_bound(nx, ny, D, fused):
    """A pair: the cross product, d2, two scaled exps (one operation each),
    the weighted sum; the fused reward adds the nx x nx self sum, the means
    and the weight sums. Each input read and the output written once."""
    pairs = nx * ny + (nx * nx if fused else 0)
    flops = pairs * (2 * D + 10) + 2 * (nx + ny) * D + (2 * (nx + ny) + 3 * nx if fused else 0)
    return bound_ms(flops, 4 * (nx * D + ny * D + ny + 2 + nx + (nx if fused else 0)))


def check_rowsum(dev):
    """One row sum (centred outside) and GMMIL's fused reward against their
    plain versions; times and the bound at each size. Returns
    {(entry, nx, ny, D): (err, ms, paced_ms, plain_ms, bound, by)}."""
    import torch
    from iltpu_torch.ops import build
    from iltpu_torch.ops import gaussian_rowsum as gr
    from iltpu_torch.ops.pairwise import centre

    g = torch.Generator(device=dev).manual_seed(5)
    lib = gr._bind(build.load("gaussian_rowsum"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {}
    for nx, ny, D in ((256, 256, 7), (256, 256, 15), (256, 10001, 7)):
        x = torch.randn(nx, D, generator=g, device=dev)
        y = 1.5 * torch.randn(ny, D, generator=g, device=dev) + 0.3
        w = 1 + torch.rand(ny, generator=g, device=dev)
        wx = 1 + torch.rand(nx, generator=g, device=dev)
        g1, g2 = torch.full((1,), 0.8, device=dev), torch.full((1,), 3.1, device=dev)
        wn = w / w.sum()
        xc, yc = centre(x, y)
        for entry, got, want, kernel, plain in (
            ("gaussian_rowsum", gr.gaussian_rowsum(x, y, wn, g1, g2),
             gr.gaussian_rowsum_plain(x, y, wn, g1, g2),
             lambda: gr.launch(lib, xc, yc, wn, g1, g2, stream),
             lambda: gr.rowsums_plain(xc, yc, wn, g1, g2)),
            ("gmmil_witness_reward", gr.gmmil_witness_reward(x, y, wx, w, g1, g2),
             gr.gmmil_witness_reward_plain(x, y, wx, w, g1, g2),
             lambda: gr.launch_reward(lib, x, y, wx, w, g1, g2, stream),
             lambda: gr.gmmil_witness_reward_plain(x, y, wx, w, g1, g2)),
        ):
            err = compare(f"{entry} {nx}x{ny} D={D}", [("out", got)], [("out", want)], (1e-5, 1e-6))
            ms, paced_ms, plain_ms = device_ms(kernel), median_ms(kernel), median_ms(plain)
            bound, by = rowsum_bound(nx, ny, D, entry == "gmmil_witness_reward")
            results[(entry, nx, ny, D)] = (err[0], ms, paced_ms, plain_ms, bound, by)
            print(f"kernel {entry} {nx}x{ny} D={D}: max_abs_err {err[0]:.3g}, max_rel_err "
                  f"{err[1]:.3g}, {ms:.4f} ms on the device ({paced_ms:.4f} ms host-paced; plain "
                  f"{plain_ms:.4f} ms, bound {bound:.6f} ms by {by})")
    single = results[("gaussian_rowsum", 256, 10001, 7)]
    if single[1] >= single[3]:
        raise AssertionError(f"gaussian_rowsum 256x10001: {single[1]:.4f} ms on the device, not "
                             f"faster than its plain version's {single[3]:.4f} ms")
    return results


GMMIL_ARGS = ["algorithm=GMMIL", "training.disc_pallas=false", "training.fused_update_scan=false"]


def check_against_cpu(dev, extra=()):
    """transition_core on the card (kernels) against the CPU (plain), 3
    iterations x 8 updates; returns the worst error and the launches the
    card's run made."""
    import torch
    from iltpu_torch import convert
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    args = [a for a in TRAINER_ARGS if not a.startswith(("num_envs", "steps", "memory"))]
    args += ["num_envs=4", "steps=300", "memory.size=1000", "training.batch_size=16",
             f"output_dir={os.path.join(REPO, 'outputs', 'chip_smoke')}", *extra]
    out = os.path.join(REPO, "outputs", "chip_smoke")
    gpu = Trainer(load_config(args), out_dir=out)
    cpu = Trainer(load_config(args + ["platform=cpu"]), out_dir=out)
    gmmil = gpu.algorithm == "GMMIL"
    convert.load_sac_tree_(cpu.sac, convert.sac_tree(gpu.sac))
    if not gmmil:
        convert.load_disc_tree_(cpu.disc_state, convert.disc_tree(gpu.disc_state))
    g = torch.Generator().manual_seed(11)
    S, A, n = cpu.state_size, cpu.action_size, 4
    worst = (0.0, 0.0)
    before = counts()
    for it in range(3):
        data = [torch.randn(n, S, generator=g), torch.tanh(torch.randn(n, A, generator=g)),
                torch.randn(n, generator=g), torch.randn(n, S, generator=g),
                (torch.rand(n, generator=g) < 0.3).float(), torch.zeros(n)]
        noise = cpu.draw_noise(8)
        for key in ("replay", "expert"):  # raw integers, reduced modulo the limit
            noise[key] = torch.randint(0, 2**62, (8 * 16,), generator=g)
        c_aux = cpu.transition_core(it * n, *data, 8, noise=noise)
        g_aux = gpu.transition_core(it * n, *[x.to(dev) for x in data], 8,
                                    noise={k: v.to(dev) for k, v in noise.items()})
        name = f"transition_core {' '.join(extra) or 'GAIL'} iteration {it}"
        if gmmil:
            disc = compare(f"{name} gmmil", gmmil_leaves(gpu.disc_state),
                           gmmil_leaves(cpu.disc_state), TOL_CHAIN)
        else:
            disc = compare(f"{name} disc", leaves(gpu.disc_state), leaves(cpu.disc_state),
                           TOL_CHAIN, gpu.disc_state, cpu.disc_state)
        for part in (
            compare(f"{name} sac", leaves(gpu.sac), leaves(cpu.sac), TOL_CHAIN, gpu.sac, cpu.sac),
            disc,
            compare(f"{name} aux", g_aux.items(), c_aux.items(), TOL_CHAIN),
        ):
            worst = worse(worst, part)
    return worst, {k: v - before[k] for k, v in counts().items()}


def gmmil_leaves(st):
    return [("gamma_1", st.gamma_1), ("gamma_2", st.gamma_2), ("initialized", st.initialized.float())]


def wrappers():
    """Every kernel wrapper with a launch counter."""
    from iltpu_torch.ops.gail_update import gail_update
    from iltpu_torch.ops.gaussian_rowsum import gaussian_rowsum, gmmil_witness_reward
    from iltpu_torch.ops.kblock_update import kblock_update
    from iltpu_torch.ops.sac_update import sac_update

    return sac_update, gail_update, kblock_update, gaussian_rowsum, gmmil_witness_reward


def counts():
    return {f.__name__: f.launches for f in wrappers()}


def reset_counts():
    for f in wrappers():
        f.launches = 0


def launches_of(**nonzero):
    """The counter of every wrapper, 0 unless given."""
    return {f.__name__: nonzero.get(f.__name__, 0) for f in wrappers()}


def schedule(cfg, K):
    """(updates in iterations K divides, the other updates), as the host
    loop counts them (n_updates of each iteration)."""
    t = cfg.training
    blocked = other = done = 0
    for new_step in range(cfg.num_envs, cfg.steps + cfg.num_envs, cfg.num_envs):
        if new_step >= t.start:
            target = (new_step - t.start) // t.interval + 1
            n, done = target - done, target
            if n and K > 1 and n % K == 0:
                blocked += n
            else:
                other += n
    return blocked, other


def run_trainer(name, extra, expect):
    """One full-width trainer run through its normal entry, counters set to
    0 just before and read just after; `expect(trainer)` gives the counts
    it must show. Returns (counts, steady env-steps/s)."""
    import numpy as np
    import torch
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    out_dir = os.path.join(REPO, "outputs", "chip_smoke", name)
    trainer = Trainer(load_config(TRAINER_ARGS + list(extra) + [f"output_dir={out_dir}"]),
                      out_dir=out_dir)
    reset_counts()
    t0 = time.time()
    score = trainer.run()
    wall = time.time() - t0
    launches = counts()
    n = trainer.updates_done
    want = expect(trainer)
    if launches != want or n == 0:
        raise AssertionError(f"{name}: launch counters {launches} != {want} ({n} updates)")
    m = trainer.metrics
    if not np.isfinite(score) or not all(np.isfinite(r).all() for r in m["test_returns"]):
        raise AssertionError(f"{name}: non-finite score {score} or returns {m['test_returns']}")
    state = [*leaves(trainer.sac)]
    state += gmmil_leaves(trainer.disc_state) if trainer.algorithm == "GMMIL" else [*leaves(trainer.disc_state)]
    for path, t in state:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite trainer state {path}")
    marks = m["steady_marks"]
    windows = [(b[0] - a[0]) / (b[1] - a[1]) for a, b in zip(marks, marks[1:])]
    steady = m["steady_env_steps"] / m["steady_time"]
    print(f"trainer {name}: {trainer.step_done} env steps, {n} updates, {launches}, {wall:.2f} s "
          f"wall, score {score:.4f}, eval returns {[round(r, 3) for r in m['test_returns'][-1]]}")
    print(f"trainer {name}: steady {steady:.1f} env-steps/s (windows {[round(w, 1) for w in windows]})")
    return launches, steady


def ptxas_report(log):
    """The `-Xptxas -v` register lines of a build log, and every function
    with spills."""
    out, fn = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        elif "Used" in line:
            out.append(line.split(":", 1)[1].strip())
        elif fn and re.search(r"[1-9]\d* bytes spill (stores|loads)", line):
            out.append(f"{fn[:80]}: {line.strip()}")
    return "; ".join(out)


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(REPO, "iltpu_torch")):
        fail(f"the iltpu_torch package is not beside {__file__}: run from a checkout")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}, {torch.cuda.device_count()} visible, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # 2. build
    from iltpu_torch.ops import build
    from iltpu_torch.ops import kblock_update as kb
    from iltpu_torch.ops import sac_update as su

    from iltpu_torch.ops import gail_update as gu

    secs = build.build_all()
    print(f"build: {', '.join(build.NAMES)} in {secs:.2f} s (one nvcc each, in parallel)")
    for name in build.NAMES:
        print(f"build {name}: {ptxas_report(build.build_log(name))}")
    for S, A in ((5, 2), (12, 3)):
        print(f"build gail_update: S={S} A={A}: {gu.smem_bytes(256, S + A, 64)} bytes of dynamic "
              f"shared memory (batch 256, width 64)")
        for name, (per_sm, sms, smem) in (
            ("sac_update", su.grid(build.load("sac_update"), 256, S, A, 256)),
            ("kblock_update", kb.grid(build.load("kblock_update"), 256, S, A, 256, 64)),
        ):
            print(f"build {name}: S={S} A={A}: {per_sm} co-resident block(s) of 512 threads per "
                  f"SM x {sms} SMs = a cooperative grid of {per_sm * sms}, {smem} bytes of "
                  f"dynamic shared memory a block")

    # 3. kernels against their plain versions
    results = {}
    def timing(t):
        return (f"{t[0]:.4f} ms on the device ({t[1]:.4f} ms host-paced; plain {t[2]:.4f} ms, "
                f"bound {t[3]:.5f} ms by {t[4]})")

    for S, A, where in ((5, 2, "pointmass"), (12, 3, "hopper")):
        err, times = (0.0, 0.0), None
        for min_alpha in (0.0, 0.05):
            e, t = check_sac(S, A, min_alpha, dev)
            err = worse(err, e)
            times = times or t
        results[("sac", where)] = (err[0], *times, *sac_bound_ms(S, A, 256, 256))
        print(f"kernel sac_update {where} S={S} A={A}: max_abs_err {err[0]:.3g}, max_rel_err "
              f"{err[1]:.3g}, {timing(results[('sac', where)][1:])}")
        err, times = (0.0, 0.0), None
        for bce in (True, False):
            e, t, case = check_gail(S, A, bce, dev)
            err = worse(err, e)
            if bce:  # the bench configuration is the main path's
                times = (*t, *gail_bound_ms(S, A, 256, 64, case))
        results[("gail", where)] = (err[0], *times)
        print(f"kernel gail_update {where} S={S} A={A}: max_abs_err {err[0]:.3g}, max_rel_err "
              f"{err[1]:.3g}, {timing(times)}")
    for S, A, B, Hd, bce, case in GAIL_VARIANTS:
        err, _, _ = check_gail(S, A, bce, dev, B=B, Hd=Hd, timed=False, **case)
        print(f"kernel gail_update variant S={S} A={A} B={B} Hd={Hd} {'BCE' if bce else 'Mixup'} "
              f"{case}: {gu.smem_bytes(B, S + A, Hd)} bytes of shared memory, max_abs_err "
              f"{err[0]:.3g}, max_rel_err {err[1]:.3g}")
    # a batch past the GEMM's whole-depth panels: the ring of 128-deep chunks
    err, _ = check_sac(5, 2, 0.0, dev, B=1024, timed=False)
    print(f"kernel sac_update pointmass B=1024 (chunked weight-gradient depth): max_abs_err "
          f"{err[0]:.3g}, max_rel_err {err[1]:.3g}")
    torch.cuda.synchronize()

    # 3b. the K-blocked kernel
    for S, A, where in ((5, 2, "pointmass"), (12, 3, "hopper")):
        err, identical, timed = (0.0, 0.0), {}, None
        for bce in (True, False):
            for min_alpha in (0.0, 0.05):
                e, same, out = check_kblock(S, A, bce, min_alpha, dev, timed=bce and not min_alpha)
                err = worse(err, e)
                for K, v in same.items():
                    identical.setdefault(K, []).append(v)
                timed = timed or out
        ms, paced_ms, per_ms, plain_ms, bound, by = timed
        results[("kblock", where)] = (err[0], ms, paced_ms, plain_ms, bound, by)
        print(f"kernel kblock_update {where} S={S} A={A}: max_abs_err {err[0]:.3g}, max_rel_err "
              f"{err[1]:.3g}, bit-identical to K per-update calls in "
              + ", ".join(f"{sum(v)} of {len(v)} configurations at K={K}" for K, v in identical.items())
              + f"; K=16: {ms:.4f} ms a launch on the device ({paced_ms:.4f} ms host-paced), "
              f"{ms / 16:.4f} ms a micro-update (16 per-update calls {per_ms:.4f} ms on the device, "
              f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms by {by})")
        broken = {K: len(v) - sum(v) for K, v in identical.items() if not all(v)}
        if broken:
            raise AssertionError(f"kblock_update {where}: not bit-identical to K per-update calls "
                                 f"in {broken} configurations")

    # 3c. the row-sum kernel
    rowsum = check_rowsum(dev)
    # GMMIL's path launches the kernel through the fused reward
    results[("rowsum", "pointmass")] = rowsum[("gmmil_witness_reward", 256, 256, 7)]
    torch.cuda.synchronize()

    # 4. the whole update path against the CPU, on each of the three paths
    for extra, want in (
        ((), launches_of(sac_update=24, gail_update=24)),
        (("training.update_block=4",), launches_of(kblock_update=6)),
        (tuple(GMMIL_ARGS), launches_of(sac_update=24, gmmil_witness_reward=24)),
    ):
        err, launched = check_against_cpu(dev, extra)
        if launched != want:
            raise AssertionError(f"reference {extra}: launches {launched} != {want}")
        print(f"reference: transition_core {' '.join(extra) or 'GAIL'} on the card vs the CPU, "
              f"3 x 8 updates: max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}, launches {launched}")

    # 5. the trainer, through its normal entry, on each path
    def per_update(t):
        return launches_of(sac_update=t.updates_done, gail_update=t.updates_done)

    def blocked(t):
        k, rest = schedule(t.cfg, 16)
        return launches_of(sac_update=rest, gail_update=rest, kblock_update=k // 16)

    def gmmil(t):
        return launches_of(sac_update=t.updates_done, gmmil_witness_reward=t.updates_done)

    launches, rates = {}, {}
    for name, extra, expect, kernels in (
        ("gail", (), per_update, ("sac_update", "gail_update")),
        ("gail_kblock16", ("training.update_block=16",), blocked, ("kblock_update",)),
        ("gmmil", tuple(GMMIL_ARGS), gmmil, ("gaussian_rowsum", "gmmil_witness_reward")),
    ):
        counted, rates[name] = run_trainer(name, extra, expect)
        launches.update({k: counted[k] for k in kernels})
    # the row-sum kernel's launches on its path: both of its entries
    launches["gaussian_rowsum"] += launches.pop("gmmil_witness_reward")
    print("trainer steady env-steps/s: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f" on {smi}")

    # the kernels line: main-path shapes (pointmass), launches from each kernel's path
    rows = []
    for name, key, replaces in (
        ("sac_update", "sac", "iltpu/ops/pallas_sac.py:564"),
        ("gail_update", "gail", "iltpu/ops/pallas_gail.py:319"),
        ("kblock_update", "kblock", "iltpu/ops/pallas_fused_block.py:241"),
        ("gaussian_rowsum", "rowsum", "iltpu/ops/pallas_pairwise.py:101"),
    ):
        err, ms, paced_ms, plain_ms, bound, by = results[(key, "pointmass")]
        rows.append({
            "name": name, "route": "cuda", "source": f"iltpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": ms, "host_paced_ms": paced_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None,
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
