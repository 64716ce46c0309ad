"""The port's tests that need a CUDA card (marked `cuda`; each skips without
one): PWIL's transport kernel and the GAIL step's wide variant against
their plain versions, the K-blocked kernel with the wide GAIL step against
per-update calls bit for bit, the wrappers' bound launch tables against
fresh ones bit for bit, SAC's later chunks on ant's rows against a
float64 run, the SAC step's bits pinned by digests, its plan's GEMM rounds
pinned, and a chunk of the
on-device loop replayed from CUDA graphs against the same chunk run eagerly. This file imports neither JAX nor iltpu, so it also runs where
JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import hashlib

import pytest
import torch

from iltpu_torch.config import load_config
from iltpu_torch.ops import gail_update as gu
from iltpu_torch.ops.pwil_transport import pwil_transport, pwil_transport_plain
from iltpu_torch.rewards import GAILDiscriminator
from iltpu_torch.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda():
    """The card, or a skip (decided when the test runs, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (pools, atoms, features, episode length T, grid, atom mass in units of
# 1/N): grid puts atoms and queries on the integers 0..grid-1 (exact ties);
# a mass below 1 makes a row take more than 32 atoms (continuation passes),
# below the agent's weight in total it empties the pools.
PWIL_CASES = {
    "shared": (64, 500, 7, 50, None, 1.0),
    "cluster_100k": (4, 100000, 15, 50, None, 1.0),
    "ties": (64, 3000, 3, 20, 3, 1.0),
    "ties_cluster": (8, 40000, 4, 200, 3, 1.0),
    "k_overflow": (64, 20000, 15, 1000, None, 0.05),
    "ragged_cluster": (20, 30001, 15, 1000, None, 1.0),
    "exhausted": (16, 600, 7, 1000, None, 0.0006),
    "d64_cluster": (2, 30000, 64, 200, None, 1.0),
    "d120_ant": (64, 5000, 120, 1000, None, 0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PWIL_CASES))
def test_pwil_kernel_matches_plain(cuda, case):
    """Bit-equal pools and close rewards over three steps: one CTA a pool,
    clusters of CTAs a pool, ties, more than 32 atoms a row, a cluster no
    slice divides, pools that run out, 64 features and ant's 120 with more
    than 32 atoms a row."""
    P, N, d, T, grid, mass = PWIL_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(N)
    if grid:
        atoms = torch.randint(0, grid, (N, d), generator=g, device=cuda).float()
        queries = torch.randint(0, grid, (P, d), generator=g, device=cuda).float()
    else:
        atoms = torch.randn(N, d, generator=g, device=cuda)
        queries = torch.randn(P, d, generator=g, device=cuda)
    offsets = torch.arange(P + 1, dtype=torch.int32, device=cuda)
    reset = torch.rand(P, generator=g, device=cuda) < 0.1
    kw = dict(atom_weight=mass / N, agent_weight=1.0 / T - 1e-6, bandwidth=3.0, scale=5.0)
    kp = torch.full((P, N), mass / N, device=cuda)
    pp = kp.clone()
    for _ in range(3):
        got = pwil_transport(atoms, kp, queries, offsets, reset, **kw)
        want = pwil_transport_plain(atoms, pp, queries, offsets, reset, **kw)
        assert torch.equal(kp, pp)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_pwil_kernel_segments_match_plain(cuda):
    """One launch over segments of 1 to 12 rows on clusters of CTAs, pools
    reset after random rows inside a segment: bit-equal pools and close
    rewards against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    N, d, R = 30000, 15, 40
    atoms = torch.randn(N, d, generator=g, device=cuda)
    queries = torch.randn(R, d, generator=g, device=cuda)
    offsets = torch.tensor([0, 12, 13, 25, 40], dtype=torch.int32, device=cuda)
    reset = torch.rand(R, generator=g, device=cuda) < 0.3
    kw = dict(atom_weight=1.0 / N, agent_weight=1.0 / 40 - 1e-6, bandwidth=3.0, scale=5.0)
    kp = torch.full((4, N), 1.0 / N, device=cuda)
    pp = kp.clone()
    got = pwil_transport(atoms, kp, queries, offsets, reset, **kw)
    want = pwil_transport_plain(atoms, pp, queries, offsets, reset, **kw)
    assert torch.equal(kp, pp)
    torch.testing.assert_close(got, want, **TOL)


# (batch, state, action, width): ant's 120 inputs, width 128 at batch 1024 on
# hopper's 15 and ant's 120, and ragged batches (segments and chunks that end
# mid-chunk): all on the wide variant's cluster
WIDE_SHAPES = {"ant": (64, 112, 8, 64), "hopper_1024x128": (1024, 12, 3, 128),
               "ant_1024x128": (1024, 112, 8, 128), "ant_ragged_1000x128": (1000, 112, 8, 128),
               "ant_ragged_33": (33, 112, 8, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
@pytest.mark.parametrize("loss", ["BCE", "Mixup"])
def test_gail_wide_variant_matches_plain(cuda, shape, loss):
    """One step of the routed (wide) variant against the plain version at
    the one-step tolerance: the state, the loss and the rewards."""
    B, S, A, Hd = WIDE_SHAPES[shape]
    assert gu.variant(B, S + A, Hd) == "wide"
    g = torch.Generator(device=cuda).manual_seed(B + S)
    h = gu.GAILHyper(1.0, 3e-5, 10.0, "AIRL", loss, 0.01)
    st = GAILDiscriminator(S, A, hidden_size=Hd, spectral_norm=True, device=cuda).init(g)
    r = lambda *shape: torch.randn(*shape, generator=g, device=cuda)
    u = lambda n: torch.rand(n, generator=g, device=cuda)
    batch = [r(B, S), torch.tanh(r(B, A)), 1 + u(B), r(B, S), torch.tanh(r(B, A)), 1 + u(B), u(B)]
    mix = u(B) if loss == "Mixup" else None
    plain = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in st.items()}
    got = gu.gail_update(h, st, *batch, mix)
    want = gu.gail_update_plain(h, plain, *batch, mix)
    for a, b in zip([*gu.state_tensors(st), *got], [*gu.state_tensors(plain), *want]):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["BCE", "Mixup"])
def test_kblock_wide_gail_equals_per_update_calls(cuda, loss):
    """The K-blocked kernel at ant's (256, 120, 64), K = 16, whose GAIL step
    is the wide variant on a few of its blocks (their partial sums through
    global memory), bit for bit against 16 calls of the per-update kernels
    (the wide step on its cluster, through distributed shared memory)."""
    import chip_smoke as cs
    from iltpu_torch.ops.kblock_update import kblock_update

    assert gu.variant(256, 120, 64) == "wide"
    sh, gh, sac_st, disc_st, batches, expert, noise = cs.kblock_case(112, 8, 16, loss == "BCE", 0.0,
                                                                      cuda)
    k_sac, k_disc, r_sac, r_disc = (cs.clone(x) for x in (sac_st, disc_st, sac_st, disc_st))
    got = kblock_update(sh, gh, k_sac, k_disc, batches, expert, noise)
    want = cs.per_update_calls(sh, gh, r_sac, r_disc, batches, expert, noise)
    for (name, a), (_, b) in zip([*cs.leaves(k_sac), *cs.leaves(k_disc), *got.items()],
                                 [*cs.leaves(r_sac), *cs.leaves(r_disc), *want.items()]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["BCE", "Mixup"])
def test_bound_tables_give_the_bits_of_fresh_binds(cuda, loss, monkeypatch):
    """Eight GAIL -> SAC per-update calls at hopper's widths on one pair of
    states bind each wrapper's launch table once; the same calls on a copy,
    with fresh tables before every call (each call then checks and packs
    every operand), give the same bits. A leaf swapped for a copy binds
    again, and the launch reads the new leaf."""
    import chip_smoke as cs
    from iltpu_torch.ops import operands
    from iltpu_torch.ops import sac_update as su

    sh, gh, sac_st, disc_st, batches, expert, noise = cs.kblock_case(12, 3, 8, loss == "BCE", 0.0,
                                                                      cuda)
    a_sac, a_disc, b_sac, b_disc = (cs.clone(x) for x in (sac_st, disc_st, sac_st, disc_st))
    binds = su.sac_update.binds, gu.gail_update.binds
    got = cs.per_update_calls(sh, gh, a_sac, a_disc, batches, expert, noise)
    assert (su.sac_update.binds, gu.gail_update.binds) == (binds[0] + 1, binds[1] + 1)
    bound = su.TABLE, gu.TABLE
    for k in range(8):
        monkeypatch.setattr(su, "TABLE", operands.Table())
        monkeypatch.setattr(gu, "TABLE", operands.Table())
        want = cs.per_update_calls(sh, gh, b_sac, b_disc, *(
            {key: v[k:k + 1] for key, v in d.items()} for d in (batches, expert, noise)))
    for (name, a), (_, b) in zip([*cs.leaves(a_sac), *cs.leaves(a_disc), *got.items()],
                                 [*cs.leaves(b_sac), *cs.leaves(b_disc), *want.items()]):
        assert torch.equal(a, b), name
    monkeypatch.setattr(su, "TABLE", bound[0])
    monkeypatch.setattr(gu, "TABLE", bound[1])
    a_sac["c"][2], a_disc["p"][0] = a_sac["c"][2].clone(), a_disc["p"][0].clone()
    binds = su.sac_update.binds, gu.gail_update.binds
    last = lambda d: {key: v[7:] for key, v in d.items()}
    got = cs.per_update_calls(sh, gh, a_sac, a_disc, last(batches), last(expert), last(noise))
    assert (su.sac_update.binds, gu.gail_update.binds) == (binds[0] + 1, binds[1] + 1)
    monkeypatch.setattr(su, "TABLE", operands.Table())
    monkeypatch.setattr(gu, "TABLE", operands.Table())
    want = cs.per_update_calls(sh, gh, b_sac, b_disc, last(batches), last(expert), last(noise))
    for (name, a), (_, b) in zip([*cs.leaves(a_sac), *cs.leaves(a_disc), *got.items()],
                                 [*cs.leaves(b_sac), *cs.leaves(b_disc), *want.items()]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_sac_ant_chunks_within_float64(cuda, tmp_path):
    """GAIL per update on ant's stepper rows (batch 16, full widths): the
    first chunk of 8 updates on the card against the CPU at the chain
    tolerance, then chunks 2 and 3, where the card's SAC state must lie
    at most max(1.0, the CPU's distance) x the chain tolerance from a
    float64 run (chip_smoke's phase 11; `check_against_cpu` raises past
    either)."""
    import chip_smoke as cs

    _, launched = cs.check_against_cpu(cuda, cs.native_env("ant"), rows=cs.native_rows("ant"),
                                       iterations=1, watched=2, out=str(tmp_path))
    assert launched["sac_update"] == 8 and launched["gail_update"] == 8


def _to(st, dev):
    """A state, batch or noise dict with its tensors on `dev`."""
    return {k: [t.to(dev) for t in v] if isinstance(v, list) else
            v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in st.items()}


class _KeptEmpty:
    """The torch module, keeping the tensors its `empty` makes: put in a
    wrapper's place of torch, it hands over the launch's scratch."""

    def __init__(self):
        self.made = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *args, **kwargs):
        self.made.append(torch.empty(*args, **kwargs))
        return self.made[-1]


def _launch_keeping_scratch(module, floats, call):
    """call() with `module`'s torch.empty kept; the launch's scratch of
    `floats` floats and call()'s result."""
    kept = _KeptEmpty()
    module.torch = kept
    try:
        out = call()
    finally:
        module.torch = torch
    return next(t for t in kept.made if t.numel() == floats), out


# (state, action, batch, min_alpha) of five SAC updates, or (state, action,
# K, batch) of one K-blocked launch, and the digest of their bits
SAC_BIT_CASES = {
    "hopper": (12, 3, 256, 0.0),
    "ant_1024": (112, 8, 1024, 0.0),  # batch past 256: the GEMM's chunked ring
    "pointmass": (5, 2, 256, 0.0),
    "pointmass_min_alpha": (5, 2, 256, 0.05),
    "kblock4_hopper": (12, 3, 4, 256),
    "kblock16_hopper": (12, 3, 16, 256),
    "kblock4_ant_1024": (112, 8, 4, 1024),
}
SAC_BIT_DIGESTS = {
    "hopper": "9ebcfe50dc4a7757650738a5aa3556ab1f0610117439fd969bde2986c1246d71",
    "ant_1024": "7bf8fa363dc9db954f56096bd9e8420ebe29357ac2c890f968ad123e37d99dff",
    "pointmass": "8a0dfff8febcc63c4fea012706cd99c2db4b8782fe6a13b51dd7a75194eb6eea",
    "pointmass_min_alpha": "d94ae4d55f3316d2c132c898788d90adb7b3920c5b2211f19f4f62a64faaffe3",
    "kblock4_hopper": "1396bcb855513a02d35bc535f2369a03fbb5e36565a82b49c2d8ea5303e63b6c",
    "kblock16_hopper": "05987df49bf35e7392e9fdc3af653a60ef86a5994f6a24471ff493fe449e23ac",
    "kblock4_ant_1024": "b9e2b51185ad74f46f7ad0b8ea74e8a51f042f63c0f63a391198a3a62aee051e",
}


def sac_bit_digest(case, dev):
    """sha256 over the bits of SAC_BIT_CASES[case] on the card: after each
    of five per-update launches (or the one K-blocked launch) every scratch
    buffer `iltpu_sac_buffer_names` names, where `iltpu_sac_buffers` puts
    it, and the aux outputs; then every leaf of the state. The inputs are
    made on the CPU from fixed seeds, so every build meets the same ones."""
    import ctypes

    import chip_smoke as cs
    from iltpu_torch import sac_drift
    from iltpu_torch.ops import build
    from iltpu_torch.ops import kblock_update as kb
    from iltpu_torch.ops import sac_update as su

    cpu, H = torch.device("cpu"), 256
    lib = build.load("sac_update")
    lib.iltpu_sac_buffer_names.restype = ctypes.c_char_p
    lib.iltpu_sac_buffers.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    digest = hashlib.sha256()
    feed = lambda t: digest.update(t.detach().cpu().contiguous().numpy().tobytes())

    def buffers(scratch, B, S, A):
        for off, n in sac_drift.layout(lib, B, S, A, H).values():
            feed(scratch[off:off + n])

    if case.startswith("kblock"):
        S, A, K, B = SAC_BIT_CASES[case]
        sh, gh, sac_st, disc_st, batches, expert, noise = (
            _to(x, dev) if isinstance(x, dict) else x
            for x in cs.kblock_case(S, A, K, True, 0.0, cpu, B=B))
        klib = kb._bind(build.load("kblock_update"))
        floats = klib.iltpu_kblock_scratch_floats(K, B, S, A, H, disc_st["p"][0].shape[1])
        scratch, aux = _launch_keeping_scratch(kb, floats, lambda: kb.kblock_update(
            sh, gh, sac_st, disc_st, batches, expert, noise))
        buffers(scratch, B, S, A)
        for k in sorted(aux):
            feed(aux[k])
        states = (sac_st, disc_st)
    else:
        S, A, B, min_alpha = SAC_BIT_CASES[case]
        h, st, steps = cs.sac_case(S, A, B, H, min_alpha, 1 + S + B, cpu)
        st = _to(st, dev)
        floats = su._bind(lib).iltpu_sac_scratch_floats(B, S, A, H)
        for batch, eps2, eps_new in steps:
            scratch, aux = _launch_keeping_scratch(su, floats, lambda: su.sac_update(
                h, st, _to(batch, dev), eps2.to(dev), eps_new.to(dev)))
            buffers(scratch, B, S, A)
            for k in sorted(aux):
                feed(aux[k])
        states = (st,)
    for st in states:
        for _, t in cs.leaves(st):
            feed(t)
    return digest.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SAC_BIT_CASES))
def test_sac_step_bits_are_pinned(cuda, case):
    """Five SAC updates at hopper's, ant's (batch 1024) and pointmass's
    shapes (min_alpha 0 and 0.05), and one K-blocked launch of 4 and one of
    16 at hopper's and one of 4 at ant's batch 1024: the state, the aux
    outputs and every scratch buffer hash to the digests that the same
    function gave on a build of the kernels before the narrow heads became
    row-owned (the last two: before the GEMM phases' tiles followed their
    shapes; an H100 with torch 2.11.0+cu128; another torch may draw other
    inputs)."""
    assert sac_bit_digest(case, cuda) == SAC_BIT_DIGESTS[case]


# (batch, state, action, blocks) and the GEMM phases' rounds of items over
# the blocks that the SAC step's plan reads there
SAC_PLAN_ROUNDS = {
    "hopper_132": ((256, 12, 3, 132), 13),
    "hopper_128": ((256, 12, 3, 128), 13),  # as many blocks as a K-blocked launch once gave SAC
    "ant_1024_132": ((1024, 112, 8, 132), 14),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SAC_PLAN_ROUNDS))
def test_sac_plan_rounds_are_pinned(cuda, case):
    """`sac_update.plan` reads 13 GEMM rounds at hopper's shapes on 132
    blocks and on 128, and 14 at ant's batch 1024 on 132, where one 32x32
    tile a block's item took 14, 16 and 46; the 21 phases and 640 row-owned
    items are as before."""
    from iltpu_torch.ops import build
    from iltpu_torch.ops import sac_update as su

    (B, S, A, blocks), rounds = SAC_PLAN_ROUNDS[case]
    plan = su.plan(build.load("sac_update"), B, S, A, 256, blocks)
    assert (plan["phases"], plan["row_items"], plan["gemm_rounds"]) == (21, 640, rounds)
    assert sum(r for r, p in zip(plan["rounds"], plan["picks"])
               if any(x[0].isdigit() for x in p)) == rounds


SMALL = [
    "env=pointmass", "env_backend=jax", "memory.size=1000", "imitation.trajectories=4",
    "training.batch_size=16", "reinforcement.actor.hidden_size=16",
    "reinforcement.critic.hidden_size=16", "evaluation.episodes=1",
    "training.on_device_loop=true", "num_envs=4", "steps=160", "training.start=0",
]
PATHS = {
    "gail_kblock4": ["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true",
                     "training.fused_update_scan=true", "training.update_block=4"],
    "pwil": ["algorithm=PWIL", "training.sac_pallas=true"],
    "adril": ["algorithm=AdRIL", "imitation.update_freq=40", "training.sac_pallas=true"],
    "gmmil": ["algorithm=GMMIL"],
    "sac_autograd": ["algorithm=SAC"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_graph_chunk_equals_eager_chunk(tmp_path, cuda, path):
    """A chunk replayed from graphs against the same chunk run eagerly from
    the same state and generator state, bit for bit."""
    from iltpu_torch.graphs import ChunkGraphs

    t = Trainer(load_config(SMALL + PATHS[path] + [f"output_dir={tmp_path}"]), out_dir=str(tmp_path))
    env_state = t.env.reset()
    graphs = ChunkGraphs(t, 4)
    graphs.run(env_state, 0, 4, 4)  # warm-up, capture, replays
    live = {**t.state_tensors(), **env_state["inner"], "t": env_state["t"], "obs": env_state["obs"]}
    before = ({k: v.clone() for k, v in live.items()}, t.gen.get_state())
    eager = [x.clone() for x in t.run_chunk(env_state, 16, 4, 4)[:2]]
    after_eager = {k: v.clone() for k, v in live.items()}, t.gen.get_state()
    for k, v in live.items():
        v.copy_(before[0][k])
    t.gen.set_state(before[1])
    replayed = graphs.run(env_state, 16, 4, 4)[:2]
    for x, y in zip(eager, replayed):
        assert torch.equal(x, y)
    for k, v in live.items():
        assert torch.equal(after_eager[0][k], v), k
    assert torch.equal(after_eager[1], t.gen.get_state())
