"""The port's plain SAC update (iltpu_torch/ops/sac_update.py, the CUDA
kernel's CPU twin with the same explicit formulas) against iltpu's fused
kernel in interpret mode (`sac_update_pallas`) and its autodiff update
(`SACLearner.update`), on the fixture of tests/test_pallas_sac.py. The
noise is iltpu's own draw for the key, handed to the port."""

import ctypes
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.models.actor import SoftActor
from iltpu.models.critic import TwinCritic
from iltpu.ops.pallas_sac import sac_update_pallas
from iltpu.updates.sac import SACLearner
from iltpu_torch import convert
from iltpu_torch.ops import operands
from iltpu_torch.ops import sac_update as su
from iltpu_torch.ops.sac_update import sac_update
from iltpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_torch_convert import assert_trees_close, jax_sac_tree, port_sac_state

torch.set_num_threads(1)

S, A, B = 7, 3, 32


def _batch(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "states": f32(rng.normal(size=(B, S))),
        "actions": f32(np.tanh(rng.normal(size=(B, A)))),
        "rewards": f32(rng.normal(size=B)),
        "next_states": f32(rng.normal(size=(B, S))),
        "terminals": f32(rng.uniform(size=B) < 0.1),
        "timeouts": np.zeros(B, np.float32),
        "weights": f32(1.0 + rng.uniform(size=B)),
        "absorbing": f32(rng.uniform(size=B) < 0.2),
        "step": np.zeros(B, np.float32),
    }


def _learner(min_alpha=0.0):
    return SACLearner(
        SoftActor(S, A, hidden_size=32, depth=2),
        TwinCritic(S, A, hidden_size=32, depth=2),
        learning_rate=3e-4, weight_decay=1e-2, discount=0.97,
        entropy_target=-2.0, polyak_factor=0.99, min_alpha=min_alpha,
    )


def _noise(key):
    k_next, k_new = jax.random.split(key)
    return (
        torch.from_numpy(np.array(jax.random.normal(k_next, (B, A), jnp.float32))),
        torch.from_numpy(np.array(jax.random.normal(k_new, (B, A), jnp.float32))),
    )


def _run(reference, learner, state, batch, keys):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tl, st = port_sac_state(learner, state)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for key in keys:
        if reference == "pallas":
            state, want = sac_update_pallas(learner, state, key, jb, interpret=True)
        else:
            state, want = learner.update(state, key, jb)
        got = sac_update(tl.hyper, st, tb, *_noise(key))
    return state, want, st, got


def _check(state, want, st, got, rtol, atol):
    assert_trees_close(convert.sac_tree(st), jax_sac_tree(state), rtol, atol, "state")
    for k in ("log_probs", "Q_values", "alpha"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k
        )


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_one_step(reference):
    learner = _learner()
    state = learner.init(jax.random.key(0))
    _check(*_run(reference, learner, state, _batch(1), [jax.random.key(42)]), 2e-5, 2e-6)


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_five_step_chain(reference):
    learner = _learner()
    state = learner.init(jax.random.key(0))
    keys = [jax.random.key(100 + i) for i in range(5)]
    _check(*_run(reference, learner, state, _batch(2), keys), 1e-4, 1e-5)


@pytest.mark.parametrize("reference", ["pallas", "xla"])
def test_min_alpha_floor(reference):
    """The floored alpha feeds the TD target, the actor's entropy term and
    the aux; the temperature gradient keeps the raw exp(log_alpha)."""
    learner = _learner(min_alpha=0.05)
    state = learner.init(jax.random.key(0)).replace(log_alpha=jnp.full((1,), -6.0))
    state, want, st, got = _run(reference, learner, state, _batch(3), [jax.random.key(43)])
    assert abs(float(got["alpha"]) - 0.05) < 1e-7
    _check(state, want, st, got, 2e-5, 2e-6)


def test_wrapper_takes_plain_only_on_cpu_and_refuses_mixed_devices():
    """CPU tensors run the plain version (no launch counted); operands on
    more than one device are refused, never silently moved."""
    learner = _learner()
    tl, st = port_sac_state(learner, learner.init(jax.random.key(0)))
    tb = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    eps2, eps_new = _noise(jax.random.key(5))
    before = sac_update.launches
    sac_update(tl.hyper, st, tb, eps2, eps_new)
    assert sac_update.launches == before
    tb["rewards"] = tb["rewards"].to("meta")
    with pytest.raises(ValueError, match="one device"):
        sac_update(tl.hyper, st, tb, eps2, eps_new)


# ------------------------------------------------ the bound launch table


def _bound_operands():
    """A port state, a batch, its noise and the three outputs, on the CPU."""
    learner = _learner()
    tl, st = port_sac_state(learner, learner.init(jax.random.key(0)))
    tb = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    eps2, eps_new = _noise(jax.random.key(7))
    return tl, st, tb, eps2, eps_new, [torch.empty(B), torch.empty(B), torch.empty(1)]


def _launch_pointers(st, tb, eps2, eps_new, outs):
    """The C entry's pointer array, listed here apart from the wrapper (as
    `sac::unpack` reads it): the actor, its two moments, the twin critic,
    its two moments and the target critic, six leaves each; the six (1,)
    scalars; the batch; the noise; the outputs."""
    state = [t for k in ("a", "am", "av", "c", "cm", "cv", "t") for t in st[k]]
    state += [st[k] for k in ("la", "lam", "lav", "ta", "tc", "tal")]
    batch = [tb[k] for k in ("states", "actions", "rewards", "next_states", "terminals",
                             "weights", "absorbing")]
    return [t.data_ptr() for t in state + batch + [eps2, eps_new] + outs]


def test_pack_binds_the_state_once_and_fills_the_rest_on_each_call():
    """The packed table is the pointer array `launch` built afresh on
    every call; a second call on the same leaves with a new batch rewrites
    only the batch's, the noise's and the outputs' pointers, and binds
    nothing."""
    _, st, tb, eps2, eps_new, outs = _bound_operands()
    table, before = operands.Table(), sac_update.binds
    got = su.pack(table, st, tb, eps2, eps_new, outs)
    assert sac_update.binds == before + 1
    assert list(got) == _launch_pointers(st, tb, eps2, eps_new, outs)
    tb2 = {k: v.clone() for k, v in tb.items()}
    eps2b, eps_newb = eps2.clone(), eps_new.clone()
    outs2 = [t.clone() for t in outs]
    again = su.pack(table, st, tb2, eps2b, eps_newb, outs2)
    assert sac_update.binds == before + 1 and again is got
    assert list(again) == _launch_pointers(st, tb2, eps2b, eps_newb, outs2)


def test_pack_binds_again_for_a_swapped_leaf_and_a_loaded_checkpoint(tmp_path):
    """A leaf swapped for another tensor, or a checkpoint loaded into a
    state of new tensors, changes the key: the table is checked and packed
    again. A checkpoint copied into the bound tensors, as the trainer's
    resume does, keeps them and binds nothing."""
    tl, st, tb, eps2, eps_new, outs = _bound_operands()
    table = operands.Table()
    su.pack(table, st, tb, eps2, eps_new, outs)
    before = sac_update.binds
    st["c"][2] = st["c"][2].clone()
    assert list(su.pack(table, st, tb, eps2, eps_new, outs)) == _launch_pointers(
        st, tb, eps2, eps_new, outs)
    assert sac_update.binds == before + 1
    save_checkpoint(str(tmp_path), convert.sac_tree(st))
    tree, _ = load_checkpoint(str(tmp_path), like=convert.sac_tree(st))
    convert.load_sac_tree_(st, tree)  # in place
    su.pack(table, st, tb, eps2, eps_new, outs)
    assert sac_update.binds == before + 1
    loaded = tl.init(torch.Generator().manual_seed(1))
    convert.load_sac_tree_(loaded, tree)
    assert list(su.pack(table, loaded, tb, eps2, eps_new, outs)) == _launch_pointers(
        loaded, tb, eps2, eps_new, outs)
    assert sac_update.binds == before + 2


BAD_OPERANDS = {
    "shape": lambda t: t[:, :-1],
    "dtype": lambda t: t.double(),
    "contiguity": lambda t: torch.stack([t, t], -1)[..., 0],
}


@pytest.mark.parametrize("fault", sorted(BAD_OPERANDS))
@pytest.mark.parametrize("operand", ["actions", "eps_new"])
def test_pack_refuses_a_bad_batch_operand_as_the_unbound_check_does(fault, operand):
    """On a bound table a wrong-shaped, wrong-dtype or non-contiguous batch
    operand or draw raises operands.check's ValueError, word for word."""
    _, st, tb, eps2, eps_new, outs = _bound_operands()
    table = operands.Table()
    su.pack(table, st, tb, eps2, eps_new, outs)
    if operand == "eps_new":
        eps_new = BAD_OPERANDS[fault](eps_new)
    else:
        tb[operand] = BAD_OPERANDS[fault](tb[operand])
    with pytest.raises(ValueError) as want:
        operands.check("sac_update", su.state_tensors(st) + su._tail(tb, eps2, eps_new),
                       su.state_shapes(S, A, 32) + su.batch_shapes(S, A, B))
    with pytest.raises(ValueError) as got:
        su.pack(table, st, tb, eps2, eps_new, outs)
    assert str(got.value) == str(want.value) and "operand" in str(got.value)


def test_wrapper_on_cpu_runs_the_plain_version_and_binds_nothing():
    """CPU operands take the plain version with its bits, no launch and no
    bind, and leave the wrapper's table as it was."""
    tl, st, tb, eps2, eps_new, _ = _bound_operands()
    plain = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in st.items()}
    launches, binds, key = sac_update.launches, sac_update.binds, su.TABLE.key
    got = sac_update(tl.hyper, st, tb, eps2, eps_new)
    want = su.sac_update_plain(tl.hyper, plain, tb, eps2, eps_new)
    assert (sac_update.launches, sac_update.binds, su.TABLE.key) == (launches, binds, key)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(a, b) for a, b in zip(su.state_tensors(st), su.state_tensors(plain)))


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "iltpu_torch",
                    "csrc")
CORE = os.path.join(CSRC, "sac_core.cuh")


def c_params(source, entry):
    """The parameters of the C entry `entry` as `csrc/<source>` defines
    it, in order: {name: the ctypes type of a pointer, int or float}."""
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    head = src[re.search(rf'extern "C" \w+ {entry}\(', src).end():]
    params = {}
    for param in head[:head.index(")")].split(","):
        decl, name = param.strip().rsplit(None, 1)
        params[name] = ctypes.c_void_p if "*" in decl else {"int": ctypes.c_int,
                                                             "float": ctypes.c_float}[decl]
    return params


class _Lib:
    """A library stand-in on which a wrapper's `_bind` sets its C signatures."""

    def __getattr__(self, name):
        if not name.startswith("iltpu_"):
            raise AttributeError(name)  # `_typed`: not yet bound
        setattr(self, name, types.SimpleNamespace())
        return getattr(self, name)


def bound_argtypes(bind, entry):
    """The argument types `bind` gives the C entry `entry`."""
    return getattr(bind(_Lib()), entry).argtypes


def test_entry_args_keep_the_c_entrys_order():
    """`entry_args` lays out the update's arguments as `iltpu_sac_update`
    declares them, and `scalars` the eight floats among them: the listing
    here, one distinct value a name, is the reference. `_bind` gives the
    entry the C types."""
    h = su.SACHyper(lr=0.5, weight_decay=0.25, alpha_lr=0.125, discount=0.96875,
                    entropy_target=-3.0, polyak=0.75, min_alpha=0.0625)
    scratch = torch.empty(4)
    want = {"ptr": "ptrs", "B": 32, "S": 7, "A": 3, "H": 16, "lr": 0.5, "wd": 0.25,
            "alpha_lr": 0.125, "discount": 0.96875, "entropy_target": -3.0, "polyak": 0.75,
            "polyak_c": 0.25, "min_alpha": 0.0625, "scratch": scratch.data_ptr()}
    sig = c_params("sac_update.cu", "iltpu_sac_update")
    assert list(sig) == [*want, "stream"]
    assert bound_argtypes(su._bind, "iltpu_sac_update") == list(sig.values())
    assert su.entry_args(h, "ptrs", (32, 7, 3, 16), scratch) == tuple(want.values())
    assert su.scalars(h) == tuple(want.values())[5:13]


def test_plan_entry_takes_the_blocks_and_gives_the_gemm_rounds():
    """`iltpu_sac_plan` takes the shape and the block count, then the
    places of the phases, row-owned items and GEMM rounds it counts and of
    its per-phase items, rounds and picks: the listing here is the
    reference, and `_bind` gives the entry those C types."""
    I, P = ctypes.c_int, ctypes.c_void_p
    want = {"B": I, "S": I, "A": I, "H": I, "blocks": I, "phases": P, "row_items": P,
            "gemm_rounds": P, "items": P, "rounds": P, "tiles": P}
    sig = c_params("sac_update.cu", "iltpu_sac_plan")
    assert list(sig.items()) == list(want.items())
    assert bound_argtypes(su._bind, "iltpu_sac_plan") == list(sig.values())


class _PlanEntry:
    """A stand-in for `iltpu_sac_plan` that writes a plan of three phases:
    two 32x32 GEMM jobs; a row-owned phase; a 64x64 GEMM job, a column sum
    of the block's threads and a 64x32 GEMM job."""

    def __call__(self, B, S, A, H, blocks, phases, row_items, gemm_rounds, items, rounds, tiles):
        self.args = (B, S, A, H, blocks)
        phases._obj.value, row_items._obj.value, gemm_rounds._obj.value = 3, 128, 3
        for i, (n, r, code) in enumerate(((128, 1, 1 + 8 * 1), (128, 1, 0),
                                          (193, 2, 4 + 8 * 6 + 64 * 2))):
            items[i], rounds[i], tiles[i] = n, r, code


def test_plan_reads_each_phase_of_the_entry():
    """`plan` hands the entry the shape and the block count, and reads its
    counts and each phase's items, rounds and picks (a base-8 digit a
    GEMM or column-sum job, the lowest first)."""
    lib = _Lib()
    lib.iltpu_sac_plan = entry = _PlanEntry()
    got = su.plan(lib, 256, 12, 3, 256, 129)
    assert entry.args == (256, 12, 3, 256, 129)
    assert got == {"phases": 3, "row_items": 128, "gemm_rounds": 3, "items": [128, 128, 193],
                   "rounds": [1, 1, 2],
                   "picks": [["32x32", "32x32"], [], ["64x64", "cols/block", "64x32"]]}


BUFFERS = ("x2 x xn ah1 ah2 ao bh1 bh2 bo lp2 td th1 th2 tq ch1 ch2 cq dq dz2 dz1 gc0 gc1 gc2 "
           "gc3 gc4 gc5 da dout adz2 adz1 ga0 ga1 ga2 ga3 ga4 ga5").split()


def _sac_step_source():
    """The body of `sac::sac_step` in the CUDA source."""
    with open(CORE) as f:
        src = f.read()
    body = src[src.index("void sac_step("):]
    return body[:body.index("\n}\n")]


def test_phase_timer_names_each_phase_of_the_sac_step():
    """profile_phases.PHASES has one name a phase of the kernel's update:
    one more than its barriers, counted in the source, the row-owned phases
    marked as such, and no name twice."""
    from iltpu_torch import profile_phases

    body = _sac_step_source()
    phases = profile_phases.PHASES
    assert len(phases) == body.count("ex.sync();") + 1
    assert sum(name.startswith("rows:") for name in phases) == body.count("ex.row_items(")
    assert len(set(phases)) == len(phases)


def test_buffer_names_keep_their_order_and_the_plain_trace_holds_each():
    """`sac::BUFFER_NAMES` keeps its 36 names in carve's order (the drift
    tool and the card test read the scratch by them), and the plain
    version's trace records every one of them."""
    with open(CORE) as f:
        src = f.read()
    decl = src[src.index("BUFFER_NAMES ="):]
    decl = decl[:decl.index(";")]
    assert "".join(re.findall(r'"([^"]*)"', decl)).split() == BUFFERS
    tl, st, tb, eps2, eps_new, _ = _bound_operands()
    trace = {}
    su.sac_update_plain(tl.hyper, st, tb, eps2, eps_new, trace)
    assert set(BUFFERS) <= set(trace)
