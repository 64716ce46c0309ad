"""iltpu <-> iltpu_torch state conversion, and the helpers the other
`test_torch_*` files use to hand iltpu's states to the port and compare
the results leaf by leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from iltpu.models.actor import SoftActor
from iltpu.models.critic import TwinCritic
from iltpu.ops.pallas_sac import _adam_state, _rebuild_opt_state
from iltpu.rewards.gail import GAILDiscriminator
from iltpu.updates.sac import SACLearner
from iltpu_torch import convert
from iltpu_torch.models import SoftActor as TSoftActor
from iltpu_torch.models import TwinCritic as TTwinCritic
from iltpu_torch.rewards import GAILDiscriminator as TGAILDiscriminator
from iltpu_torch.updates import SACLearner as TSACLearner

torch.set_num_threads(1)


def np_tree(t):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), t)


def jax_sac_tree(state) -> dict:
    """iltpu SACState -> the converter's numpy tree."""
    _, unravel_a = ravel_pytree(state.actor_params)
    _, unravel_c = ravel_pytree(state.critic_params)
    ast = _adam_state(state.actor_opt)
    cst = _adam_state(state.critic_opt)
    alst = _adam_state(state.alpha_opt)
    return {
        "actor_params": np_tree(state.actor_params),
        "critic_params": np_tree(state.critic_params),
        "target_critic_params": np_tree(state.target_critic_params),
        "log_alpha": np.asarray(state.log_alpha),
        "actor_mu": np_tree(unravel_a(ast.mu)),
        "actor_nu": np_tree(unravel_a(ast.nu)),
        "critic_mu": np_tree(unravel_c(cst.mu)),
        "critic_nu": np_tree(unravel_c(cst.nu)),
        "alpha_mu": np.asarray(alst.mu).reshape(1),
        "alpha_nu": np.asarray(alst.nu).reshape(1),
        "actor_count": int(ast.count),
        "critic_count": int(cst.count),
        "alpha_count": int(alst.count),
    }


def jax_disc_tree(params, opt_state) -> dict:
    _, unravel = ravel_pytree(params)
    ast = _adam_state(opt_state)
    return {
        "params": np_tree(params),
        "mu": np_tree(unravel(ast.mu)),
        "nu": np_tree(unravel(ast.nu)),
        "count": int(ast.count),
    }


def port_learner(learner: SACLearner) -> TSACLearner:
    """The port's learner with the same sizes and hyperparameters."""
    an, cn = learner.actor.net, learner.critic.critic.net
    S, A = learner.actor.state_size, learner.actor.action_size
    return TSACLearner(
        TSoftActor(S, A, an.hidden_size, an.depth, an.activation),
        TTwinCritic(S, A, cn.hidden_size, cn.depth, cn.activation),
        learning_rate=learner.lr,
        weight_decay=learner.weight_decay,
        discount=learner.discount,
        entropy_target=learner.entropy_target,
        polyak_factor=learner.polyak_factor,
        min_alpha=learner.min_alpha,
    )


def port_sac_state(learner: SACLearner, state):
    tl = port_learner(learner)
    st = tl.init(torch.Generator().manual_seed(0))
    convert.load_sac_tree_(st, jax_sac_tree(state))
    return tl, st


def port_disc_state(disc: GAILDiscriminator, params, opt_state):
    g = disc.g
    S_A = g.input_size
    td = TGAILDiscriminator(
        S_A - 1, 1, hidden_size=g.hidden_size, depth=g.depth,
        activation=g.activation, spectral_norm=g.spectral_norm,
        reward_function=disc.reward_function,
    )
    st = td.init(torch.Generator().manual_seed(0))
    convert.load_disc_tree_(st, jax_disc_tree(params, opt_state))
    return td, st


def assert_trees_close(got, want, rtol, atol, what=""):
    lg, tg = jax.tree.flatten_with_path(got)
    lw, tw = jax.tree.flatten_with_path(want)
    assert tg == tw, f"{what}: tree structures differ"
    for (path, g), (_, w) in zip(lg, lw):
        np.testing.assert_allclose(
            np.asarray(g, np.float64), np.asarray(w, np.float64),
            rtol=rtol, atol=atol, err_msg=f"{what} {jax.tree_util.keystr(path)}",
        )


def _sac_fixture():
    S, A = 7, 3
    learner = SACLearner(
        SoftActor(S, A, hidden_size=32, depth=2),
        TwinCritic(S, A, hidden_size=32, depth=2),
        learning_rate=3e-4, weight_decay=1e-2, discount=0.97,
        entropy_target=-2.0, polyak_factor=0.99,
    )
    state = learner.init(jax.random.key(0))
    # give the moments and counts non-trivial values so the round trip
    # checks every slot
    state = state.replace(
        actor_opt=jax.tree.map(lambda x: x + 0.5 if x.dtype == jnp.float32 else x + 3, state.actor_opt),
        log_alpha=jnp.full((1,), -0.7),
    )
    return learner, state


def test_sac_round_trip():
    learner, state = _sac_fixture()
    tree = jax_sac_tree(state)
    _, st = port_sac_state(learner, state)
    assert st["a"][0].shape == (7, 32) and st["c"][0].shape == (2, 10, 32)
    assert float(st["ta"][0]) == 3.0
    back = convert.sac_tree(st)
    assert_trees_close(back, tree, 0, 0, "sac")


@pytest.mark.parametrize("spectral_norm", [True, False])
def test_disc_round_trip_keeps_sn_moment_slots(spectral_norm):
    disc = GAILDiscriminator(7, 3, hidden_size=16, depth=1, spectral_norm=spectral_norm)
    params = disc.init(jax.random.key(0))
    opt = optax.flatten(optax.adamw(3e-5, weight_decay=10.0)).init(params)
    # the u/v moment slots are never moved by AdamW, but must survive
    _, unravel = ravel_pytree(params)
    ast = _adam_state(opt)
    mu = jax.tree.map(lambda x: x + 0.25, unravel(ast.mu))
    opt = _rebuild_opt_state(opt, jnp.asarray(5, jnp.int32), ravel_pytree(mu)[0], ast.nu)
    tree = jax_disc_tree(params, opt)
    _, st = port_disc_state(disc, params, opt)
    assert bool(st["sn"]) == spectral_norm
    assert float(st["t"][0]) == 5.0
    assert_trees_close(convert.disc_tree(st), tree, 0, 0, "disc")
