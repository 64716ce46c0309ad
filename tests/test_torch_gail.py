"""The port's plain GAIL discriminator step (iltpu_torch/ops/gail_update.py,
the CUDA kernel's CPU twin with the hand-derived penalty gradient) against
iltpu's fused kernel in interpret mode (`gail_update_pallas`, whose
gradients come from jax.grad traced in the kernel) and against
`adversarial_imitation_update` + `predict_reward`, over the grids of
tests/test_pallas_gail.py, chained 3 steps; and against iltpu's kernel at
the envs' input widths (walker2d's and halfcheetah's 18 + 6, ant's 112 + 8)
and discriminator widths 64 and 128, and at iltpu's tuned batch of 1024.
The draws are iltpu's own for each key, handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iltpu.models.actor import SoftActor
from iltpu.ops.pallas_gail import gail_update_pallas
from iltpu.rewards.gail import GAILDiscriminator
from iltpu.updates.adversarial import AdversarialConfig, adversarial_imitation_update
from iltpu_torch import convert
from iltpu_torch.ops import gail_update as gu
from iltpu_torch.ops import operands
from iltpu_torch.ops.gail_update import GAILHyper, gail_update
from iltpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_torch_convert import assert_trees_close, jax_disc_tree, port_disc_state
from test_torch_sac import bound_argtypes, c_params

torch.set_num_threads(1)

S, A, B = 7, 3, 32
LR, WD, GP = 3e-5, 10.0, 1.0


def _batch(seed, S=S, A=A, B=B):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "states": f32(rng.normal(size=(B, S))),
        "actions": f32(np.tanh(rng.normal(size=(B, A)))),
        "next_states": f32(rng.normal(size=(B, S))),
        "terminals": f32(rng.uniform(size=B) < 0.1),
        "weights": f32(1.0 + 0.5 * rng.uniform(size=B)),
    }


def _draws(key, loss_function, mixup_alpha, B=B):
    """adversarial_imitation_update's (k_mixup, k_gp) draws for `key`."""
    k_mixup, k_gp = jax.random.split(key)
    t = lambda x: torch.from_numpy(np.array(x, np.float32))
    mix = None
    if loss_function == "Mixup":
        mix = t(
            jax.random.uniform(k_mixup, (B,))
            if mixup_alpha == 1.0
            else jax.random.beta(k_mixup, mixup_alpha, mixup_alpha, (B,))
        )
    return t(jax.random.uniform(k_gp, (B,))), mix


def _compare(reference, spectral_norm, reward_function, gp, loss_function="BCE",
             entropy_bonus=0.0, mixup_alpha=1.0, key=42, S=S, A=A, Hd=64, B=B):
    disc = GAILDiscriminator(
        S, A, hidden_size=Hd, depth=1, spectral_norm=spectral_norm,
        reward_function=reward_function,
    )
    params = disc.init(jax.random.key(0))
    optim = optax.flatten(optax.adamw(LR, weight_decay=WD))
    opt = optim.init(params)
    actor = SoftActor(S, A, hidden_size=16, depth=2)
    actor_params = actor.init(jax.random.key(1))
    trans, expert = _batch(2, S, A, B), _batch(3, S, A, B)
    jt = {k: jnp.asarray(v) for k, v in trans.items()}
    je = {k: jnp.asarray(v) for k, v in expert.items()}
    cfg = AdversarialConfig(
        loss_function=loss_function, grad_penalty=gp, mixup_alpha=mixup_alpha,
        entropy_bonus=entropy_bonus,
    )
    _, st = port_disc_state(disc, params, opt)
    hyper = GAILHyper(gp, LR, WD, reward_function, loss_function, entropy_bonus)
    tt = {k: torch.from_numpy(v) for k, v in trans.items()}
    te = {k: torch.from_numpy(v) for k, v in expert.items()}

    for i in range(3):
        k = jax.random.fold_in(jax.random.key(key), i)
        if reference == "xla":
            params, opt, aux = adversarial_imitation_update(
                disc, actor, actor_params, params, opt, optim, jt, je, k, cfg,
            )
        else:
            params, opt, aux, want_r = gail_update_pallas(
                disc, params, opt, jt, je, k, grad_penalty=gp, learning_rate=LR,
                weight_decay=WD, loss_function=loss_function,
                mixup_alpha=mixup_alpha, entropy_bonus=entropy_bonus, interpret=True,
            )
        eps_gp, mix = _draws(k, loss_function, mixup_alpha, B)
        loss, got_r = gail_update(
            hyper, st, te["states"], te["actions"], te["weights"],
            tt["states"], tt["actions"], tt["weights"], eps_gp, mix,
        )
    if reference == "xla":
        want_r = disc.predict_reward(params, jt["states"], jt["actions"])

    tol = dict(rtol=2e-5, atol=2e-6)
    assert_trees_close(convert.disc_tree(st), jax_disc_tree(params, opt), what="state", **tol)
    np.testing.assert_allclose(loss.numpy()[0], np.asarray(aux["discriminator_loss"]), **tol)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **tol)


@pytest.mark.parametrize("reference", ["pallas", "xla"])
@pytest.mark.parametrize(
    "spectral_norm,reward_function,gp",
    [
        (True, "AIRL", GP),
        (False, "AIRL", GP),
        (True, "GAIL", GP),
        (False, "GAIL", GP),
        (True, "FAIRL", GP),
        (True, "AIRL", 0.0),  # no-penalty branch
    ],
)
def test_bce(reference, spectral_norm, reward_function, gp):
    _compare(reference, spectral_norm, reward_function, gp)


@pytest.mark.parametrize("reference", ["pallas", "xla"])
@pytest.mark.parametrize(
    "spectral_norm,reward_function,entropy_bonus,mixup_alpha",
    [
        (False, "AIRL", 0.0248, 1.0),  # the tuned GAIL@10 configuration
        (False, "GAIL", 0.0, 0.9),     # non-unit alpha: a real Beta draw
        (True, "AIRL", 0.1, 1.0),
    ],
)
def test_mixup(reference, spectral_norm, reward_function, entropy_bonus, mixup_alpha):
    _compare(reference, spectral_norm, reward_function, 0.436, "Mixup",
             entropy_bonus, mixup_alpha, key=43)


# the envs' discriminator inputs (S, A) x widths; (7, 3) at 64 is the grids' above
ENV_WIDTHS = [(7, 3, 128), (18, 6, 64), (18, 6, 128), (112, 8, 64), (112, 8, 128)]


@pytest.mark.parametrize("S_,A_,Hd", ENV_WIDTHS)
def test_bce_at_env_widths(S_, A_, Hd):
    """The bench configuration (spectral norm, AIRL, penalty 1) against
    iltpu's kernel at each env's input width: the card's tiled variants
    take the narrow inputs, its wide variant ant's."""
    _compare("pallas", True, "AIRL", GP, S=S_, A=A_, Hd=Hd)


@pytest.mark.parametrize("S_,A_,Hd", ENV_WIDTHS)
def test_mixup_at_env_widths(S_, A_, Hd):
    """The tuned GAIL@10 configuration (Mixup, entropy bonus) likewise."""
    _compare("pallas", False, "AIRL", 0.436, "Mixup", 0.0248, 1.0, key=43, S=S_, A=A_, Hd=Hd)


# iltpu's tuned batch (tuned.yaml's 1024) at the shapes the card's wide
# variant takes there: ant's 112 + 8 and hopper's 12 + 3 at width 128
TUNED_SHAPES = [(112, 8, 128), (12, 3, 128)]


@pytest.mark.parametrize("S_,A_,Hd", TUNED_SHAPES)
@pytest.mark.parametrize("loss_function", ["BCE", "Mixup"])
def test_at_tuned_batch(S_, A_, Hd, loss_function):
    """Batch 1024 against iltpu's kernel: the bench configuration (BCE) or
    the tuned GAIL@10 one (Mixup, entropy bonus), 3 steps."""
    if loss_function == "BCE":
        _compare("pallas", True, "AIRL", GP, S=S_, A=A_, Hd=Hd, B=1024)
    else:
        _compare("pallas", False, "AIRL", 0.436, "Mixup", 0.0248, 1.0, key=43, S=S_, A=A_, Hd=Hd,
                 B=1024)


def test_wrapper_refuses_mixed_devices_and_a_wrong_mix():
    disc = GAILDiscriminator(S, A, hidden_size=16, depth=1, spectral_norm=True)
    params = disc.init(jax.random.key(0))
    opt = optax.flatten(optax.adamw(LR, weight_decay=WD)).init(params)
    _, st = port_disc_state(disc, params, opt)
    b = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    args = [b["states"], b["actions"], b["weights"], b["states"], b["actions"], b["weights"],
            torch.rand(B)]
    bce = GAILHyper(GP, LR, WD, "AIRL", "BCE", 0.0)
    before = gail_update.launches
    loss, rewards = gail_update(bce, st, *args)
    assert gail_update.launches == before and rewards.shape == (B,)
    with pytest.raises(ValueError, match="Mixup"):
        gail_update(bce, st, *args, torch.rand(B))
    with pytest.raises(ValueError, match="Mixup"):
        gail_update(bce._replace(loss_function="Mixup"), st, *args)
    args[3] = args[3].to("meta")
    with pytest.raises(ValueError, match="one device"):
        gail_update(bce, st, *args)


# ------------------------------------------------ the bound launch table


def _bound_operands(spectral_norm=True, mixup=False):
    """A port discriminator state, the step's operands (Mixup draw last,
    or None) and its two outputs, on the CPU."""
    disc = GAILDiscriminator(S, A, hidden_size=16, depth=1, spectral_norm=spectral_norm)
    params = disc.init(jax.random.key(0))
    opt = optax.flatten(optax.adamw(LR, weight_decay=WD)).init(params)
    td, st = port_disc_state(disc, params, opt)
    b = {k: torch.from_numpy(v) for k, v in _batch(8).items()}
    e = {k: torch.from_numpy(v) for k, v in _batch(9).items()}
    args = [e["states"], e["actions"], e["weights"], b["states"], b["actions"], b["weights"],
            torch.rand(B), torch.rand(B) if mixup else None]
    return td, st, args, [torch.empty(1), torch.empty(B)]


def _launch_pointers(st, args, outs):
    """The C entry's pointer array, listed here apart from the wrapper (as
    `gail::unpack` reads it): W1, b1, W2, b2; u1, v1, u2, v2 (nulls
    without spectral norm); the AdamW moments m and v; the step clock; the
    batches' and draws', the Mixup draw's (null for BCE), the outputs'."""
    mix = args[7]
    ptrs = lambda ts: [t.data_ptr() for t in ts]
    state = ptrs(st["p"]) + (ptrs(st["sn"]) if st["sn"] else [0] * 4)
    state += ptrs(st["m"]) + ptrs(st["v"]) + [st["t"].data_ptr()]
    return state + ptrs(args[:7]) + [0 if mix is None else mix.data_ptr()] + ptrs(outs)


def _as_ints(table):
    return [p or 0 for p in table]  # ctypes reads a null c_void_p as None


@pytest.mark.parametrize("spectral_norm,mixup", [(True, False), (False, True)])
def test_pack_binds_the_state_once_and_fills_the_rest_on_each_call(spectral_norm, mixup):
    """The packed table is the pointer array the C entry took afresh on
    every call, nulls included; a second call on the same leaves with new
    batches rewrites only the tail, and binds nothing."""
    _, st, args, outs = _bound_operands(spectral_norm, mixup)
    table, before = operands.Table(), gail_update.binds
    got = gu.pack(table, st, *args, outs)
    assert gail_update.binds == before + 1
    assert _as_ints(got) == _launch_pointers(st, args, outs)
    args2 = [None if t is None else t.clone() for t in args]
    outs2 = [t.clone() for t in outs]
    again = gu.pack(table, st, *args2, outs2)
    assert gail_update.binds == before + 1 and again is got
    assert _as_ints(again) == _launch_pointers(st, args2, outs2)


def test_pack_binds_again_for_a_swapped_leaf_and_a_loaded_checkpoint(tmp_path):
    """A leaf swapped for another tensor, or a checkpoint loaded into a
    state of new tensors, changes the key and binds again; a checkpoint
    copied into the bound tensors binds nothing."""
    td, st, args, outs = _bound_operands()
    table = operands.Table()
    gu.pack(table, st, *args, outs)
    before = gail_update.binds
    st["sn"][1] = st["sn"][1].clone()
    assert _as_ints(gu.pack(table, st, *args, outs)) == _launch_pointers(st, args, outs)
    assert gail_update.binds == before + 1
    save_checkpoint(str(tmp_path), convert.disc_tree(st))
    tree, _ = load_checkpoint(str(tmp_path), like=convert.disc_tree(st))
    convert.load_disc_tree_(st, tree)  # in place
    gu.pack(table, st, *args, outs)
    assert gail_update.binds == before + 1
    loaded = td.init(torch.Generator().manual_seed(1))
    convert.load_disc_tree_(loaded, tree)
    assert _as_ints(gu.pack(table, loaded, *args, outs)) == _launch_pointers(loaded, args, outs)
    assert gail_update.binds == before + 2


BAD_OPERANDS = {
    "shape": lambda t: t[:-1],
    "dtype": lambda t: t.double(),
    "contiguity": lambda t: torch.stack([t, t], -1)[..., 0],
}


@pytest.mark.parametrize("fault", sorted(BAD_OPERANDS))
@pytest.mark.parametrize("operand", [1, 6])  # the expert actions, the penalty's draw
def test_pack_refuses_a_bad_batch_operand_as_the_unbound_check_does(fault, operand):
    """On a bound table a wrong-shaped, wrong-dtype or non-contiguous batch
    operand or draw raises the unbound call's ValueError, word for word."""
    _, st, args, outs = _bound_operands()
    table = operands.Table()
    gu.pack(table, st, *args, outs)
    args[operand] = BAD_OPERANDS[fault](args[operand])
    with pytest.raises(ValueError) as want:
        gu.pack(operands.Table(), st, *args, outs)
    with pytest.raises(ValueError) as got:
        gu.pack(table, st, *args, outs)
    assert str(got.value) == str(want.value) and "operand" in str(got.value)


@pytest.mark.parametrize("mixup", [False, True])
def test_wrapper_on_cpu_runs_the_plain_version_and_binds_nothing(mixup):
    """CPU operands take the plain version with its bits, no launch and no
    bind, and leave the wrapper's table as it was."""
    _, st, args, _ = _bound_operands(mixup=mixup)
    h = GAILHyper(GP, LR, WD, "AIRL", "Mixup" if mixup else "BCE", 0.0)
    plain = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in st.items()}
    launches, binds, key = gail_update.launches, gail_update.binds, gu.TABLE.key
    loss, rewards = gail_update(h, st, *args)
    want_loss, want_rewards = gu.gail_update_plain(h, plain, *args)
    assert (gail_update.launches, gail_update.binds, gu.TABLE.key) == (launches, binds, key)
    assert torch.equal(loss, want_loss) and torch.equal(rewards, want_rewards)
    assert all(torch.equal(a, b) for a, b in zip(gu.state_tensors(st), gu.state_tensors(plain)))


@pytest.mark.parametrize("spectral_norm,mixup,reward,code", [(True, False, "GAIL", 0),
                                                             (False, True, "FAIRL", 2)])
def test_entry_args_keep_the_c_entrys_order(spectral_norm, mixup, reward, code):
    """`entry_args` lays out the step's arguments as `iltpu_gail_update`
    declares them, with `options` and `scalars` among them: the listing
    here, one distinct value a name, is the reference (the reward codes as
    `gail_core.cuh` reads them: 0 GAIL, 1 AIRL, 2 FAIRL). `_bind` gives the
    entry the C types."""
    h = GAILHyper(grad_penalty=0.5, lr=0.25, weight_decay=0.125, reward_function=reward,
                  loss_function="Mixup" if mixup else "BCE", entropy_bonus=0.0625)
    _, st, args, _ = _bound_operands(spectral_norm, mixup)
    want = {"ptr": "ptrs", "B": B, "S": S, "A": A, "Hd": 16, "sn": int(spectral_norm),
            "bce": int(not mixup), "reward_fn": code, "gp": 0.5, "lr": 0.25, "wd": 0.125,
            "ent": 0.0625}
    sig = c_params("gail_update.cu", "iltpu_gail_update")
    assert list(sig) == [*want, "stream"]
    assert bound_argtypes(gu._bind, "iltpu_gail_update") == list(sig.values())
    assert gu.entry_args(h, st, args[7], "ptrs", B, S, A) == tuple(want.values())
    assert gu.options(h, st, args[7]) + gu.scalars(h) == tuple(want.values())[5:]
