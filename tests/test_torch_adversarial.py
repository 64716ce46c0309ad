"""The port's autograd discriminator update
(`iltpu_torch.updates.adversarial.adversarial_imitation_update`, the
`training.disc_pallas=false` path) and the reward of the updated
discriminator, against iltpu's `adversarial_imitation_update` +
`GAILDiscriminator.predict_reward`: BCE, PUGAIL with and without a finite
margin, Mixup, penalty 0 and 1, the entropy bonus, spectral norm on and off,
depth 1 and 2. One step at rtol 2e-5 / atol 2e-6, a chain of 5 at 1e-4 /
1e-5; the draws are iltpu's own for each key."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iltpu.models.actor import SoftActor
from iltpu.rewards.gail import GAILDiscriminator
from iltpu.updates.adversarial import AdversarialConfig, adversarial_imitation_update
from iltpu_torch import convert
from iltpu_torch.ops.gail_update import GAILHyper, gail_update_plain
from iltpu_torch.updates.adversarial import AdversarialConfig as TConfig
from iltpu_torch.updates.adversarial import adversarial_imitation_update as t_update
from test_torch_convert import assert_trees_close, jax_disc_tree, port_disc_state
from test_torch_gail import B, _batch, _draws

torch.set_num_threads(1)

LR, WD = 3e-5, 10.0

CASES = {
    "bce_sn": dict(loss_function="BCE", grad_penalty=1.0, spectral_norm=True),
    "bce_no_sn_gp0": dict(loss_function="BCE", grad_penalty=0.0, spectral_norm=False),
    "bce_entropy": dict(loss_function="BCE", grad_penalty=1.0, spectral_norm=False, entropy_bonus=0.05),
    "pugail_margin": dict(loss_function="PUGAIL", grad_penalty=1.0, spectral_norm=True,
                          nonnegative_margin=0.05),
    "pugail_inf": dict(loss_function="PUGAIL", grad_penalty=0.0, spectral_norm=False,
                       pos_class_prior=0.6),
    "mixup_entropy": dict(loss_function="Mixup", grad_penalty=0.436, spectral_norm=False,
                          entropy_bonus=0.0248),
    "mixup_sn": dict(loss_function="Mixup", grad_penalty=1.0, spectral_norm=True),
    "bce_depth2_sn": dict(loss_function="BCE", grad_penalty=1.0, spectral_norm=True, depth=2),
}


def _setup(case, reward_function="AIRL"):
    c = dict(case)
    sn, depth = c.pop("spectral_norm"), c.pop("depth", 1)
    disc = GAILDiscriminator(7, 3, hidden_size=32, depth=depth, spectral_norm=sn,
                             reward_function=reward_function)
    params = disc.init(jax.random.key(0))
    optim = optax.flatten(optax.adamw(LR, weight_decay=WD))
    cfg = AdversarialConfig(**c)
    tcfg = TConfig(**c, learning_rate=LR, weight_decay=WD)
    return disc, params, optim, cfg, tcfg


@pytest.mark.parametrize("name", list(CASES))
def test_matches_iltpu(name):
    disc, params, optim, cfg, tcfg = _setup(CASES[name])
    opt = optim.init(params)
    actor = SoftActor(7, 3, hidden_size=16, depth=2)
    actor_params = actor.init(jax.random.key(1))
    td, st = port_disc_state(disc, params, opt)
    trans, expert = _batch(4), _batch(5)
    jt = {k: jnp.asarray(v) for k, v in trans.items()}
    je = {k: jnp.asarray(v) for k, v in expert.items()}
    tt = {k: torch.from_numpy(v) for k, v in trans.items()}
    te = {k: torch.from_numpy(v) for k, v in expert.items()}
    update = jax.jit(lambda p, o, k: adversarial_imitation_update(
        disc, actor, actor_params, p, o, optim, jt, je, k, cfg))
    for i in range(5):
        key = jax.random.fold_in(jax.random.key(77), i)
        params, opt, aux = update(params, opt, key)
        eps_gp, mix = _draws(key, cfg.loss_function, 1.0)
        loss = t_update(td, st, tt, te, tcfg, eps_gp, mix)
        rtol, atol = (2e-5, 2e-6) if i == 0 else (1e-4, 1e-5)
        what = f"{name} step {i + 1}"
        assert_trees_close(convert.disc_tree(st), jax_disc_tree(params, opt), rtol, atol, what)
        np.testing.assert_allclose(float(loss), float(aux["discriminator_loss"]), rtol=rtol,
                                   atol=atol, err_msg=what)
        np.testing.assert_allclose(
            td.predict_reward(tt["states"], tt["actions"]).detach().numpy(),
            np.asarray(disc.predict_reward(params, jt["states"], jt["actions"])),
            rtol=rtol, atol=atol, err_msg=f"{what} reward")


@pytest.mark.parametrize("loss_function", ["BCE", "Mixup"])
def test_matches_the_plain_kernel_twin(loss_function):
    """The autograd step and the GAIL kernel's plain version (hand-derived
    penalty gradient) on copies of one state, the bench and tuned
    configurations: one step, state and reward."""
    case = CASES["bce_sn"] if loss_function == "BCE" else CASES["mixup_entropy"]
    disc, params, optim, cfg, tcfg = _setup(case)
    td, st = port_disc_state(disc, params, optim.init(params))
    st_plain = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in st.items()}
    tt = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    te = {k: torch.from_numpy(v) for k, v in _batch(7).items()}
    eps_gp, mix = _draws(jax.random.key(9), loss_function, 1.0)
    loss = t_update(td, st, tt, te, tcfg, eps_gp, mix)
    hyper = GAILHyper(cfg.grad_penalty, LR, WD, "AIRL", loss_function, cfg.entropy_bonus)
    p_loss, p_rewards = gail_update_plain(hyper, st_plain, te["states"], te["actions"], te["weights"],
                                          tt["states"], tt["actions"], tt["weights"], eps_gp, mix)
    tol = dict(rtol=2e-5, atol=2e-6)
    assert_trees_close(convert.disc_tree(st), convert.disc_tree(st_plain), what="state", **tol)
    np.testing.assert_allclose(float(loss), float(p_loss[0]), **tol)
    np.testing.assert_allclose(td.predict_reward(tt["states"], tt["actions"]).detach().numpy(),
                               p_rewards.numpy(), **tol)


def test_refuses_a_wrong_mix():
    disc, params, optim, cfg, tcfg = _setup(CASES["bce_sn"])
    td, st = port_disc_state(disc, params, optim.init(params))
    tt = {k: torch.from_numpy(v) for k, v in _batch(8).items()}
    with pytest.raises(ValueError, match="Mixup"):
        t_update(td, st, tt, tt, tcfg, torch.rand(B), torch.rand(B))
    with pytest.raises(ValueError, match="Mixup"):
        t_update(td, st, tt, tt, tcfg._replace(loss_function="Mixup"), torch.rand(B))
