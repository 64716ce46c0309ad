"""The port's autograd SAC update (`iltpu_torch.updates.sac.SACLearner.update`,
the `training.sac_pallas=false` path) against iltpu's `SACLearner.update`
(min_alpha 0 and 0.05; depth 2 with relu and depth 3 with tanh), and against
the port's plain `sac_update` (the SAC kernel's CPU twin) on the same state.
The noise is iltpu's own draw for the key, handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.models.actor import SoftActor
from iltpu.models.critic import TwinCritic
from iltpu.updates.sac import SACLearner
from iltpu_torch import convert
from iltpu_torch.ops.sac_update import sac_update, sac_update_plain
from test_torch_convert import assert_trees_close, jax_sac_tree, port_sac_state
from test_torch_sac import B, S, A, _batch, _noise

torch.set_num_threads(1)

STEP_TOL = (2e-5, 2e-6)
CHAIN_TOL = (1e-4, 1e-5)


def _learner(depth, activation, min_alpha):
    return SACLearner(
        SoftActor(S, A, hidden_size=32, depth=depth, activation=activation),
        TwinCritic(S, A, hidden_size=32, depth=depth, activation=activation),
        learning_rate=3e-4, weight_decay=1e-2, discount=0.97,
        entropy_target=-2.0, polyak_factor=0.99, min_alpha=min_alpha,
    )


def _state(learner, min_alpha):
    state = learner.init(jax.random.key(0))
    if min_alpha:
        state = state.replace(log_alpha=jnp.full((1,), -6.0))  # the floor is active
    return state


def _check(state, want, st, got, tol, what):
    rtol, atol = tol
    assert_trees_close(convert.sac_tree(st), jax_sac_tree(state), rtol, atol, f"{what} state")
    for k in ("log_probs", "Q_values", "alpha", "critic_loss", "actor_loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


ARCHS = [(2, "relu"), (3, "tanh")]


@pytest.mark.parametrize("depth,activation", ARCHS, ids=["depth2-relu", "depth3-tanh"])
@pytest.mark.parametrize("min_alpha", [0.0, 0.05])
def test_matches_iltpu_one_step_and_chain(depth, activation, min_alpha):
    """One update at the step tolerance, then four more (a chain of 5) at
    the chain tolerance."""
    learner = _learner(depth, activation, min_alpha)
    state = _state(learner, min_alpha)
    update = jax.jit(learner.update)
    tl, st = port_sac_state(learner, state)
    batch = _batch(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(5):
        key = jax.random.key(200 + i)
        state, want = update(state, key, jb)
        got = tl.update(st, tb, *_noise(key))
        if i == 0:
            _check(state, want, st, got, STEP_TOL, "step 1")
    _check(state, want, st, got, CHAIN_TOL, "step 5")
    if min_alpha:
        assert abs(float(got["alpha"]) - min_alpha) < 1e-7


@pytest.mark.parametrize("min_alpha", [0.0, 0.05])
def test_matches_the_plain_kernel_twin(min_alpha):
    """The autograd update and `sac_update_plain` (hand-derived gradients)
    on copies of one state: one step, then a chain of 5."""
    learner = _learner(2, "relu", min_alpha)
    tl, st = port_sac_state(learner, _state(learner, min_alpha))
    st_plain = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in st.items()}
    tb = {k: torch.from_numpy(v) for k, v in _batch(12).items()}
    for i in range(5):
        eps2, eps_new = _noise(jax.random.key(300 + i))
        got = tl.update(st, tb, eps2, eps_new)
        want = sac_update_plain(tl.hyper, st_plain, tb, eps2, eps_new)
        rtol, atol = STEP_TOL if i == 0 else CHAIN_TOL
        assert_trees_close(convert.sac_tree(st), convert.sac_tree(st_plain), rtol, atol, f"step {i + 1}")
        for k in ("log_probs", "Q_values", "alpha"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


def test_updates_in_place_and_mixes_with_the_kernel_path():
    """The modules keep sharing the state's tensors across the autograd
    update, and the two paths can take turns on one state."""
    learner = _learner(2, "relu", 0.0)
    tl, st = port_sac_state(learner, _state(learner, 0.0))
    ids = [id(t) for t in st["a"] + st["c"]]
    tb = {k: torch.from_numpy(v) for k, v in _batch(13).items()}
    before = tl.actor.net.weights[0].detach().clone()
    for i in range(4):
        eps = _noise(jax.random.key(400 + i))
        tl.update(st, tb, *eps) if i % 2 == 0 else sac_update(tl.hyper, st, tb, *eps)
    assert [id(t) for t in st["a"] + st["c"]] == ids
    assert float(st["ta"][0]) == float(st["tc"][0]) == float(st["tal"][0]) == 4.0
    w = tl.actor.net.weights[0].detach()
    assert torch.equal(w, st["a"][0]) and not torch.equal(w, before)
    assert torch.equal(tl.critic.weights[1].detach(), st["c"][2])
