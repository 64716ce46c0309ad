"""The port's plain GAIL discriminator step (iltpu_torch/ops/gail_update.py,
the CUDA kernel's CPU twin with the hand-derived penalty gradient) against
iltpu's fused kernel in interpret mode (`gail_update_pallas`, whose
gradients come from jax.grad traced in the kernel) and against
`adversarial_imitation_update` + `predict_reward`, over the grids of
tests/test_pallas_gail.py, chained 3 steps. The draws are iltpu's own for
each key, handed to the port."""

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
from iltpu_torch.ops.gail_update import GAILHyper, gail_update
from test_torch_convert import assert_trees_close, jax_disc_tree, port_disc_state

torch.set_num_threads(1)

S, A, B = 7, 3, 32
LR, WD, GP = 3e-5, 10.0, 1.0


def _batch(seed):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    return {
        "states": f32(rng.normal(size=(B, S))),
        "actions": f32(np.tanh(rng.normal(size=(B, A)))),
        "next_states": f32(rng.normal(size=(B, S))),
        "terminals": f32(rng.uniform(size=B) < 0.1),
        "weights": f32(1.0 + 0.5 * rng.uniform(size=B)),
    }


def _draws(key, loss_function, mixup_alpha):
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
             entropy_bonus=0.0, mixup_alpha=1.0, key=42):
    disc = GAILDiscriminator(
        S, A, hidden_size=64, depth=1, spectral_norm=spectral_norm,
        reward_function=reward_function,
    )
    params = disc.init(jax.random.key(0))
    optim = optax.flatten(optax.adamw(LR, weight_decay=WD))
    opt = optim.init(params)
    actor = SoftActor(S, A, hidden_size=16, depth=2)
    actor_params = actor.init(jax.random.key(1))
    trans, expert = _batch(2), _batch(3)
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
        eps_gp, mix = _draws(k, loss_function, mixup_alpha)
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
