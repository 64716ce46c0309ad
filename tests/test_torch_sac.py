"""The port's plain SAC update (iltpu_torch/ops/sac_update.py, the CUDA
kernel's CPU twin with the same explicit formulas) against iltpu's fused
kernel in interpret mode (`sac_update_pallas`) and its autodiff update
(`SACLearner.update`), on the fixture of tests/test_pallas_sac.py. The
noise is iltpu's own draw for the key, handed to the port."""

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
from iltpu_torch.ops.sac_update import sac_update
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
