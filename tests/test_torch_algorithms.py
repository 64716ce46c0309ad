"""The port's SAC-backbone algorithm pieces against iltpu's, from iltpu's
own draws: BC (`updates/bc.py`) with and without dropout masks; RED's
pretraining update, `set_sigma` and reward; AdRIL/SQIL's
`resample_and_relabel` (balanced and not); expert mixing; `replay_transfer`;
and DRIL's ensemble uncertainty, threshold and reward. One step at rtol 2e-5
/ atol 2e-6, chains of 5 at 1e-4 / 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from iltpu.data import replay as JR
from iltpu.models.actor import DRIL_ENSEMBLE_SIZE
from iltpu.models.actor import SoftActor as JActor
from iltpu.ops.pallas_sac import _adam_state
from iltpu.rewards.adril import init_relabeller as j_init_relabeller
from iltpu.rewards.adril import resample_and_relabel as j_relabel
from iltpu.rewards.mixing import mix_expert_agent_transitions as j_mix
from iltpu.rewards.red import REDDiscriminator as JRED
from iltpu.updates.bc import behavioural_cloning_update as j_bc
from iltpu.updates.red import target_estimation_update as j_red_update
from iltpu_torch import convert
from iltpu_torch.data import replay as TR
from iltpu_torch.models import SoftActor
from iltpu_torch.rewards import REDDiscriminator, init_relabeller, mix_expert_agent_transitions
from iltpu_torch.rewards import resample_and_relabel
from iltpu_torch.updates import behavioural_cloning_update, target_estimation_update
from test_torch_convert import assert_trees_close, np_tree

torch.set_num_threads(1)

S, A, B = 7, 3, 32
STEP = dict(rtol=2e-5, atol=2e-6)
CHAIN = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(seed, n=B, step_hi=100):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "step": f32(rng.integers(1, step_hi, size=n)),
        "states": f32(rng.normal(size=(n, S))),
        "actions": f32(np.tanh(1.5 * rng.normal(size=(n, A)))),
        "rewards": f32(rng.normal(size=n)),
        "next_states": f32(rng.normal(size=(n, S))),
        "terminals": f32(rng.uniform(size=n) < 0.1),
        "timeouts": np.zeros(n, np.float32),
        "weights": f32(1.0 + rng.uniform(size=n)),
        "absorbing": f32(rng.uniform(size=n) < 0.2),
    }


def jax_opt_tree(params, opt) -> dict:
    """An optax.flatten(adamw) state over an MLP's params -> the converter's tree."""
    _, unravel = ravel_pytree(params)
    ast = _adam_state(opt)
    return {"params": np_tree(params), "mu": np_tree(unravel(ast.mu)),
            "nu": np_tree(unravel(ast.nu)), "count": int(ast.count)}


def jax_masks(key, shapes, rates):
    """iltpu's keep-masks of one forward: layer k from fold_in(key, k)."""
    return [None if rate == 0 else torch.from_numpy(np.array(
        jax.random.bernoulli(jax.random.fold_in(key, k), 1.0 - rate, shape)))
        for k, (shape, rate) in enumerate(zip(shapes, rates))]


def _opt_state(net):
    p = net.leaves()
    return {"p": p, "m": [torch.zeros_like(x) for x in p], "v": [torch.zeros_like(x) for x in p],
            "t": torch.zeros(1)}


# ------------------------------------------------------------------ BC

@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "dropout"])
def test_bc_matches_iltpu(dropout):
    """DRIL's discriminator shape with dropout (tanh, 0.1 / 0.2); the SAC
    actor's without (depth 2, relu). A chain of 5 steps."""
    kw = dict(hidden_size=32, depth=1, activation="tanh", input_dropout=0.1, dropout=0.2) if dropout \
        else dict(hidden_size=32, depth=2, activation="relu")
    ja = JActor(S, A, **kw)
    params = ja.init(jax.random.key(0))
    optim = optax.flatten(optax.adamw(3e-4, weight_decay=0.1))
    opt = optim.init(params)
    ta = SoftActor(S, A, **kw)
    st = _opt_state(ta.net)
    convert.load_opt_tree_(st, jax_opt_tree(params, opt))
    batch = _batch(1)
    batch["actions"][0] = 1.0  # clamped into (-1, 1) before atanh
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    for i in range(5):
        key = jax.random.key(10 + i)
        params, opt, want = j_bc(ja, params, opt, optim, jb, rng=key, train_dropout=dropout)
        masks = jax_masks(key, [(B, S), (B, 32)], [0.1, 0.2]) if dropout else None
        got = behavioural_cloning_update(ta, st, tb, lr=3e-4, weight_decay=0.1, masks=masks,
                                         train_dropout=dropout)
        tol = STEP if i == 0 else CHAIN
        assert_trees_close(convert.opt_tree(st), jax_opt_tree(params, opt), what=f"step {i + 1}", **tol)
        np.testing.assert_allclose(float(got), float(want), **tol)


# ----------------------------------------------------------------- RED

@pytest.mark.parametrize("state_only,rates", [(False, (0.0, 0.0)), (True, (0.1, 0.2))],
                         ids=["state_action", "state_only-dropout"])
def test_red_update_sigma_and_reward(state_only, rates):
    kw = dict(state_only=state_only, hidden_size=32, depth=1, activation="relu",
              input_dropout=rates[0], dropout=rates[1])
    jr = JRED(S, A, **kw)
    red = jr.init(jax.random.key(0))
    optim = optax.flatten(optax.adamw(1e-3, weight_decay=0.01))
    opt = optim.init(red.predictor)
    tr = REDDiscriminator(S, A, **kw)
    st = tr.init(torch.Generator().manual_seed(0))

    def tree(red, opt):
        return {**jax_opt_tree(red.predictor, opt), "target": np_tree(red.target),
                "sigma_1": np.asarray(red.sigma_1), "sigma_set": bool(red.sigma_set)}

    convert.load_red_tree_(st, tree(red, opt))
    n = S if state_only else S + A
    batch = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    for i in range(5):
        key = jax.random.key(20 + i)
        red, opt, want = j_red_update(jr, red, opt, optim, jb, rng=key)
        got = target_estimation_update(tr, st, tb, lr=1e-3, weight_decay=0.01,
                                       masks=jax_masks(key, [(B, n), (B, 32)], rates))
        tol = STEP if i == 0 else CHAIN
        assert_trees_close(convert.red_tree(st), tree(red, opt), what=f"step {i + 1}", **tol)
        np.testing.assert_allclose(float(got), float(want), **tol)
    red = jr.set_sigma(red, jb["states"], jb["actions"])
    tr.set_sigma(st, tb["states"], tb["actions"])
    assert bool(st["sigma_set"])
    np.testing.assert_allclose(float(st["sigma_1"]), float(red.sigma_1), **CHAIN)
    other = _batch(3)
    np.testing.assert_allclose(
        tr.predict_reward(st, _t(other["states"]), _t(other["actions"])).numpy(),
        np.asarray(jr.predict_reward(red, jnp.asarray(other["states"]), jnp.asarray(other["actions"]))),
        **CHAIN)


def test_red_sigma_from_config_is_kept():
    tr = REDDiscriminator(S, A, reward_bandwidth_scale=5.0)
    st = tr.init(torch.Generator().manual_seed(0))
    b = _batch(4)
    tr.set_sigma(st, _t(b["states"]), _t(b["actions"]))
    assert float(st["sigma_1"]) == 5.0 and bool(st["sigma_set"])


# ------------------------------------------------ AdRIL/SQIL and mixing

@pytest.mark.parametrize("update_freq", [0, 25], ids=["SQIL", "AdRIL"])
@pytest.mark.parametrize("balanced", [True, False], ids=["balanced", "half"])
def test_resample_and_relabel_matches_iltpu(update_freq, balanced):
    """Three calls (the balanced flip alternates), policy steps on both
    sides of the round boundary."""
    jc, tc = j_init_relabeller(), init_relabeller()
    for i in range(3):
        policy, expert = _batch(30 + i, step_hi=120), _batch(40 + i)
        step = 90 + 10 * i
        jc, want = j_relabel(
            jc, {k: jnp.asarray(v) for k, v in policy.items()},
            {k: jnp.asarray(v) for k, v in expert.items()}, jnp.asarray(step, jnp.float32),
            jnp.asarray(7, jnp.int32), jnp.asarray(3, jnp.int32),
            update_freq=update_freq, balanced=balanced)
        tc, got = resample_and_relabel(
            tc, {k: _t(v) for k, v in policy.items()}, {k: _t(v) for k, v in expert.items()},
            step, torch.tensor(7), torch.tensor(3), update_freq=update_freq, balanced=balanced)
        assert bool(tc) == bool(jc.sample_expert)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"call {i} {k}")


def test_mixing_matches_iltpu():
    policy, expert = _batch(50), _batch(51)
    want = j_mix({k: jnp.asarray(v) for k, v in policy.items()},
                 {k: jnp.asarray(v) for k, v in expert.items()})
    got = mix_expert_agent_transitions({k: _t(v) for k, v in policy.items()},
                                       {k: _t(v) for k, v in expert.items()})
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# ------------------------------------------------------- replay_transfer

@pytest.mark.parametrize("n_src,size", [(30, 50), (70, 50)], ids=["fits-wraps", "larger"])
def test_replay_transfer_matches_iltpu(n_src, size):
    """Into a ring that already holds rows (the write head mid-ring), a
    source that wraps it, and one larger than it."""
    rng = np.random.default_rng(n_src)
    j, t = JR.replay_init(size, S, A, True), TR.replay_init(size, S, A, True)
    n = 12
    for it in range(3):
        d = {"step": np.full(n, it + 1, np.float32),
             "states": rng.normal(size=(n, S)).astype(np.float32),
             "actions": rng.normal(size=(n, A)).astype(np.float32),
             "rewards": rng.normal(size=n).astype(np.float32),
             "next_states": rng.normal(size=(n, S)).astype(np.float32),
             "terminals": (rng.uniform(size=n) < 0.3).astype(np.float32),
             "timeouts": (rng.uniform(size=n) < 0.2).astype(np.float32)}
        j = JR.replay_append_batch(j, *(jnp.asarray(v) for v in d.values()))
        TR.replay_append_batch(t, *(torch.from_numpy(v) for v in d.values()))
    src = {k: v for k, v in _batch(60, n_src).items() if k not in ("step", "absorbing")}
    src["weights"] = (2.0 + rng.uniform(size=n_src)).astype(np.float32)
    j = JR.replay_transfer(j, JR.replay_from_transitions(src, 4, True))
    TR.replay_transfer(t, TR.replay_from_transitions(src, 4, True))
    for c in TR.COLUMNS:
        np.testing.assert_array_equal(t.rows(c).numpy(), np.asarray(getattr(j, c)), err_msg=c)
    assert (int(t.idx), bool(t.full), int(t.num_trajectories)) == (
        int(j.idx), bool(j.full), int(j.num_trajectories))


# ------------------------------------------------------------ DRIL

def test_dril_uncertainty_threshold_and_reward():
    """iltpu's five members' masks (split(key, 5), fold_in per layer),
    stacked on a member axis for the port's one broadcast forward."""
    kw = dict(hidden_size=32, depth=1, activation="tanh", input_dropout=0.1, dropout=0.1)
    ja = JActor(S, A, **kw)
    params = ja.init(jax.random.key(0))
    ta = SoftActor(S, A, **kw)
    st = _opt_state(ta.net)
    convert.load_opt_tree_(st, jax_opt_tree(params, optax.flatten(optax.adamw(1e-3)).init(params)))
    b = _batch(70)
    s, a = jnp.asarray(b["states"]), jnp.asarray(b["actions"])

    def masks(key):
        per = [jax_masks(k, [(B, S), (B, 32)], [0.1, 0.1])
               for k in jax.random.split(key, DRIL_ENSEMBLE_SIZE)]
        return [torch.stack([m[layer] for m in per]) for layer in range(2)]

    key = jax.random.key(5)
    want_u = ja.action_uncertainty(params, key, s, a)
    got_u = ta.action_uncertainty(_t(b["states"]), _t(b["actions"]), masks(key))
    np.testing.assert_allclose(got_u.detach().numpy(), np.asarray(want_u), **STEP)
    want_q = ja.uncertainty_threshold(params, key, s, a, 0.98)
    got_q = ta.uncertainty_threshold(_t(b["states"]), _t(b["actions"]), 0.98, masks(key))
    np.testing.assert_allclose(float(got_q), float(want_q), **STEP)
    key2 = jax.random.key(6)
    threshold = float(jnp.median(ja.action_uncertainty(params, key2, s, a)))
    want_r = ja.dril_reward(params, key2, s, a, jnp.asarray(threshold))
    got_r = ta.dril_reward(_t(b["states"]), _t(b["actions"]), torch.tensor(threshold), masks(key2))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert 0 < int((got_r > 0).sum()) < B
