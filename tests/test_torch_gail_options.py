"""The GAIL input options in the port (`iltpu_torch/rewards/gail.py`,
`iltpu_torch/updates/adversarial.py`, the trainer's `update`) against
iltpu's: AIRL reward shaping (a depth-0 linear g and the shaping MLP h over
the state, with the discount), subtracting log pi (the actor's
log-probability at the update's pre-SAC params) and state-only input, alone
and combined; the discriminator logit and reward on converted params, the
autograd step under BCE, PUGAIL and Mixup with iltpu's draws handed over
(one step at rtol 2e-5 / atol 2e-6, a chain of 5 at 1e-4 / 1e-5), the
GAIL kernel's plain version at Mixup alpha 0.9, transition_core with shaping
+ log pi and with Mixup at alpha 0.5 (whose Beta draws are iltpu's), and the
port's own Beta sampler against scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.stats
import torch
from scipy.special import expit

from iltpu.config import load_config as jax_load_config
from iltpu.models.actor import SoftActor
from iltpu.rewards.gail import GAILDiscriminator
from iltpu.trainer import Trainer as JaxTrainer
from iltpu.updates.adversarial import AdversarialConfig, adversarial_imitation_update
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.models import SoftActor as TSoftActor
from iltpu_torch.models.distributions import beta_log_odds, beta_sample, log_gamma_sample
from iltpu_torch.models.fcnn import MLP as TMLP
from iltpu_torch.rewards import GAILDiscriminator as TGAILDiscriminator
from iltpu_torch.trainer import Trainer
from iltpu_torch.updates.adversarial import AdversarialConfig as TConfig
from iltpu_torch.updates.adversarial import adversarial_imitation_update as t_update
from test_torch_convert import assert_trees_close, jax_disc_tree, jax_sac_tree, np_tree
from test_torch_gail import A, S, _batch, _compare, _draws
from test_torch_trainer import BASE, COMMON, TUNEDLIKE, _iltpu_noise, _step_data

torch.set_num_threads(1)

LR, WD = 3e-5, 10.0
STEP, CHAIN = dict(rtol=2e-5, atol=2e-6), dict(rtol=1e-4, atol=1e-5)

# (state_only, reward_shaping, subtract_log_policy)
OPTIONS = {
    "shaping": (False, True, False),
    "log_pi": (False, False, True),
    "state_only": (True, False, False),
    "shaping_log_pi": (False, True, True),
    "state_only_shaping": (True, True, False),
    "state_only_log_pi": (True, False, True),
    "all": (True, True, True),
}


def _pair(option, spectral_norm=True, depth=1, reward_function="AIRL"):
    """iltpu's discriminator, its params and AdamW state, an actor and its
    params, and the port's twins on converted params."""
    state_only, shaping, log_pi = OPTIONS[option]
    kw = dict(state_only=state_only, reward_shaping=shaping, subtract_log_policy=log_pi,
              hidden_size=32, depth=depth, spectral_norm=spectral_norm, discount=0.97,
              reward_function=reward_function)
    disc = GAILDiscriminator(S, A, **kw)
    params = disc.init(jax.random.key(0))
    optim = optax.flatten(optax.adamw(LR, weight_decay=WD))
    opt = optim.init(params)
    td = TGAILDiscriminator(S, A, **kw)
    st = td.init(torch.Generator().manual_seed(0))
    convert.load_disc_tree_(st, jax_disc_tree(params, opt))
    actor = SoftActor(S, A, hidden_size=16, depth=2)
    actor_params = actor.init(jax.random.key(1))
    ta = TSoftActor(S, A, hidden_size=16, depth=2)
    convert._copy_(ta.net.leaves(), convert._layers(np_tree(actor_params)))
    return disc, params, optim, opt, td, st, actor, actor_params, ta


def _inputs(batch, disc, actor, actor_params, ta):
    """(iltpu's, the port's) logit inputs after state and action."""
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    lp_j = actor.log_prob(actor_params, j["states"], j["actions"]) if disc.subtract_log_policy else None
    lp_t = ta.log_prob(t["states"], t["actions"]) if disc.subtract_log_policy else None
    return ((j["states"], j["actions"], j["next_states"], j["terminals"], lp_j),
            (t["states"], t["actions"], t["next_states"], t["terminals"], lp_t))


@pytest.mark.parametrize("spectral_norm", [True, False])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_logit_and_reward_match_iltpu(option, spectral_norm):
    disc, params, _, _, td, st, actor, actor_params, ta = _pair(option, spectral_norm)
    jx, tx = _inputs(_batch(3), disc, actor, actor_params, ta)
    got = td.forward(tx[0], tx[1], st["p"], st["sn"], *tx[2:]).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(disc.forward(params, *jx)), **STEP)
    np.testing.assert_allclose(td.predict_reward(tx[0], tx[1], st, *tx[2:]).numpy(),
                               np.asarray(disc.predict_reward(params, *jx)), **STEP)


@pytest.mark.parametrize("spectral_norm", [True, False])
def test_depth0_mlp_matches_iltpu(spectral_norm):
    """The shaping head's g: a depth-0 MLP, one linear layer."""
    from iltpu.models.fcnn import MLP

    net = MLP(10, 32, 0, 1, spectral_norm=spectral_norm)
    params = net.init(jax.random.key(4))
    t = TMLP(10, 32, 0, 1, spectral_norm=spectral_norm)
    assert t.n_layers == 1 and t.dims == (10, 1)
    layers = params["layers"]
    convert._copy_(t.leaves(), convert._layers(np_tree(params)))
    if spectral_norm:
        convert._copy_(t.sn_vectors(), [np.asarray(layers[0][k]) for k in ("u", "v")])
    x = np.random.default_rng(0).normal(size=(6, 10)).astype(np.float32)
    np.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(net.apply(params, jnp.asarray(x))), **STEP)


UPDATES = [(o, loss, 1.0) for o in ("shaping", "log_pi", "state_only")
           for loss in ("BCE", "PUGAIL", "Mixup")]
UPDATES += [("all", "Mixup", 0.5), ("shaping_log_pi", "BCE", 1.0)]


@pytest.mark.parametrize("option,loss_function,alpha", UPDATES)
def test_update_matches_iltpu(option, loss_function, alpha):
    """One step and a chain of 5 of the autograd step, and the updated
    discriminator's reward, with iltpu's draws for each key."""
    disc, params, optim, opt, td, st, actor, actor_params, ta = _pair(option)
    kw = dict(loss_function=loss_function, grad_penalty=1.0, entropy_bonus=0.02,
              nonnegative_margin=0.05 if loss_function == "PUGAIL" else float("inf"))
    cfg = AdversarialConfig(mixup_alpha=alpha, **kw)
    tcfg = TConfig(learning_rate=LR, weight_decay=WD, **kw)
    trans, expert = _batch(4), _batch(5)
    jt = {k: jnp.asarray(v) for k, v in trans.items()}
    je = {k: jnp.asarray(v) for k, v in expert.items()}
    tt = {k: torch.from_numpy(v) for k, v in trans.items()}
    te = {k: torch.from_numpy(v) for k, v in expert.items()}
    update = jax.jit(lambda p, o, k: adversarial_imitation_update(
        disc, actor, actor_params, p, o, optim, jt, je, k, cfg))
    jx, tx = _inputs(trans, disc, actor, actor_params, ta)
    log_pi = ta.log_prob if disc.subtract_log_policy else None
    for i in range(5):
        key = jax.random.fold_in(jax.random.key(78), i)
        params, opt, aux = update(params, opt, key)
        eps_gp, mix = _draws(key, loss_function, alpha)
        loss = t_update(td, st, tt, te, tcfg, eps_gp, mix, log_pi)
        tol = STEP if i == 0 else CHAIN
        what = f"{option} {loss_function} step {i + 1}"
        assert_trees_close(convert.disc_tree(st), jax_disc_tree(params, opt), what=what, **tol)
        np.testing.assert_allclose(float(loss), float(aux["discriminator_loss"]), err_msg=what,
                                   **tol)
        np.testing.assert_allclose(td.predict_reward(tx[0], tx[1], st, *tx[2:]).numpy(),
                                   np.asarray(disc.predict_reward(params, *jx)),
                                   err_msg=f"{what} reward", **tol)


def test_update_refuses_a_missing_log_pi():
    _, _, _, _, td, st, _, _, ta = _pair("log_pi")
    tt = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    with pytest.raises(ValueError, match="log_pi"):
        t_update(td, st, tt, tt, TConfig(), torch.rand(tt["weights"].shape[0]))


def test_kernel_plain_version_at_mixup_alpha_09():
    """The GAIL kernel's plain version against iltpu's gail_update_pallas
    (interpret mode), with the Beta(0.9, 0.9) `mix` iltpu draws handed
    over, spectral norm, AIRL and the entropy bonus."""
    _compare("pallas", True, "AIRL", 1.0, "Mixup", 0.05, 0.9, key=44)


def _beta_noise(noise, base_key, step, n_updates, B, alpha):
    """iltpu's Mixup draws at `alpha` (jax.random.beta from each update's
    k_mixup, trainer.py:820-830) in place of `_iltpu_noise`'s uniforms."""
    def mix(i):
        k = jax.random.fold_in(jax.random.fold_in(base_key, 0x5AC + i), step)
        k_mixup = jax.random.split(jax.random.split(k, 6)[2])[0]
        return jax.random.beta(k_mixup, alpha, alpha, (B,))

    noise["mix"] = torch.from_numpy(np.array(jax.vmap(mix)(jnp.arange(n_updates))))
    return noise


CORES = {
    "shaping_log_pi": COMMON + ["algorithm=GAIL", "training.sac_pallas=true",
                                "imitation.discriminator.reward_shaping=true",
                                "imitation.discriminator.subtract_log_policy=true"],
    "state_only_autograd": COMMON + ["algorithm=GAIL", "imitation.state_only=true"],
    "mixup05_kernel": BASE + TUNEDLIKE + ["imitation.mixup_alpha=0.5"],
    "mixup05_kblock4": BASE + TUNEDLIKE + ["imitation.mixup_alpha=0.5", "training.update_block=4"],
}


@pytest.mark.parametrize("name", list(CORES))
def test_transition_core_matches_iltpu(tmp_path, name):
    """3 iterations x 8 updates of iltpu's transition_core (its update scan
    with the autograd step, the GAIL kernel or the K-blocked kernel) and the
    port's, from the same state, with iltpu's draws."""
    args = CORES[name]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    state = jt.state
    convert.load_sac_tree_(tt.sac, jax_sac_tree(state["sac"]))
    convert.load_disc_tree_(tt.disc_state, jax_disc_tree(state["disc"], state["disc_opt"]))
    S_, A_, n, B = jt.env.obs_size, jt.env.action_size, 4, 16
    alpha = float(tt.cfg.imitation.mixup_alpha)
    mixup = tt.cfg.imitation.loss_function == "Mixup"
    core = jax.jit(jt._transition_core, static_argnames=("n_updates",))
    for it in range(3):
        data = _step_data(jax.random.key(200 + it), n, S_, A_)
        base_key = jax.random.key(17 + it)
        step = it * n
        state, aux = core(
            state, base_key, jnp.asarray(step, jnp.int32), data["obs"], data["actions"],
            data["rewards"], data["next_obs"], data["terminals"], data["timeouts"], n_updates=8,
        )
        noise = _iltpu_noise(state, base_key, step, 8, B, A_, mixup)
        if mixup and alpha != 1.0:
            noise = _beta_noise(noise, base_key, step, 8, B, alpha)
        t = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
        taux = tt.transition_core(step, t["obs"], t["actions"], t["rewards"], t["next_obs"],
                                  t["terminals"], t["timeouts"], 8, noise=noise)
        what = f"{name} iteration {it}"
        assert_trees_close(convert.sac_tree(tt.sac), jax_sac_tree(state["sac"]), what=what, **CHAIN)
        assert_trees_close(convert.disc_tree(tt.disc_state),
                           jax_disc_tree(state["disc"], state["disc_opt"]), what=what, **CHAIN)
        for k, v in aux.items():
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(v), err_msg=f"{what} aux {k}",
                                       **CHAIN)


@pytest.mark.parametrize("alpha", [0.2, 0.5, 2.0])
def test_beta_sampler_against_scipy(alpha):
    """KS tests of the port's capture-safe samplers on a fixed seed: the
    Beta(alpha, alpha) log-odds against scipy's Beta CDF through the
    logistic map (in float64: float32 rounds the Beta mass within 2^-25 of
    1 to 1, about 2% of it at alpha 0.2; the KS statistic is the same
    through the monotone map), and one Gamma(alpha) against scipy's. The
    float32 draws are the sigmoid of the log-odds."""
    g = torch.Generator().manual_seed(5)
    z = beta_log_odds(alpha, (20000,), g).double().numpy()
    assert np.isfinite(z).all()
    ks = scipy.stats.kstest(z, lambda t: scipy.stats.beta(alpha, alpha).cdf(expit(t)))
    assert ks.pvalue > 0.01, ks
    gamma = np.exp(log_gamma_sample(alpha, (20000,), g).double().numpy())
    ks = scipy.stats.kstest(gamma, scipy.stats.gamma(alpha).cdf)
    assert ks.pvalue > 0.01, ks
    g.manual_seed(5)
    x = beta_sample(alpha, (20000,), g)
    np.testing.assert_array_equal(x.numpy(), torch.sigmoid(torch.from_numpy(z).float()).numpy())
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0


def test_mixup_alpha_one_keeps_the_uniform_draws(tmp_path):
    """At alpha 1 the Mixup draw is the generator's plain uniform, as
    before; at alpha 0.5 it is the Beta sampler's, from the same place in
    the sequence."""
    args = BASE + TUNEDLIKE + ["platform=cpu"]
    t = Trainer(load_config(args), out_dir=str(tmp_path))
    state = t.gen.get_state()
    noise = t.draw_noise(3)
    t.gen.set_state(state)
    torch.rand((3, 16), generator=t.gen)  # eps_gp
    torch.randn((3, 16, t.action_size), generator=t.gen)
    torch.randn((3, 16, t.action_size), generator=t.gen)
    assert torch.equal(noise["mix"], torch.rand((3, 16), generator=t.gen))
    t5 = Trainer(load_config(args + ["imitation.mixup_alpha=0.5"]), out_dir=str(tmp_path))
    t5.gen.set_state(state)
    noise5 = t5.draw_noise(3)
    t5.gen.set_state(state)
    for k in ("eps_gp", "eps2", "eps_new"):
        assert torch.equal(noise5[k], noise[k]), k
    skip = [torch.rand((3, 16), generator=t5.gen)] + [
        torch.randn((3, 16, t5.action_size), generator=t5.gen) for _ in range(2)]
    assert len(skip) == 3
    assert torch.equal(noise5["mix"], beta_sample(0.5, (3, 16), t5.gen))
    assert not torch.equal(noise5["mix"], noise["mix"])
