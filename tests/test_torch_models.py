"""The port's networks (iltpu_torch/models) against iltpu's on converted
parameters: MLP forwards (with and without spectral norm), the actor's
sample/log-prob with injected noise and greedy action, the twin critic,
Polyak, the power iteration, and init statistics (orthogonality, gains)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.models import distributions as JD
from iltpu.models.actor import SoftActor as JActor
from iltpu.models.critic import TwinCritic as JCritic
from iltpu.models.critic import polyak_update as j_polyak
from iltpu.models.fcnn import MLP as JMLP
from iltpu.models.fcnn import update_spectral_norm as j_update_sn
from iltpu_torch.models import MLP, SoftActor, TwinCritic, polyak_update
from iltpu_torch.models import distributions as D

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _load_mlp(m: MLP, params):
    with torch.no_grad():
        for k, layer in enumerate(params["layers"]):
            m.weights[k].copy_(_t(layer["w"]))
            m.biases[k].copy_(_t(layer["b"]))
            if m.spectral_norm:
                getattr(m, f"u{k}").copy_(_t(layer["u"]))
                getattr(m, f"v{k}").copy_(_t(layer["v"]))


@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("spectral_norm", [False, True])
def test_mlp_forward(activation, spectral_norm):
    jm = JMLP(6, 24, 2, 3, activation, spectral_norm=spectral_norm)
    params = jm.init(jax.random.key(0))
    x = np.random.default_rng(0).normal(size=(17, 6)).astype(np.float32)
    m = MLP(6, 24, 2, 3, activation, spectral_norm=spectral_norm)
    _load_mlp(m, params)
    with torch.no_grad():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(params, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_mlp_dropout_with_iltpus_masks(activation):
    """Input and hidden dropout (inverted scaling, the hidden mask between
    the linear map and the activation) with iltpu's masks, fold_in(rng, k)
    for layer k; without masks, the plain forward."""
    jm = JMLP(6, 24, 2, 3, activation, input_dropout=0.2, dropout=0.3)
    params = jm.init(jax.random.key(0))
    x = np.random.default_rng(1).normal(size=(17, 6)).astype(np.float32)
    m = MLP(6, 24, 2, 3, activation, input_dropout=0.2, dropout=0.3)
    _load_mlp(m, params)
    rng = jax.random.key(4)
    masks = [_t(jax.random.bernoulli(jax.random.fold_in(rng, k), keep, shape)).bool()
             for k, (keep, shape) in enumerate([(0.8, (17, 6)), (0.7, (17, 24)), (0.7, (17, 24))])]
    want = jm.apply(params, jnp.asarray(x), rng=rng, train=True)
    with torch.no_grad():
        np.testing.assert_allclose(m(_t(x), masks=masks).numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(m(_t(x)).numpy(), np.asarray(jm.apply(params, jnp.asarray(x))), **TOL)
        drawn = m.draw_masks(17, torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in drawn] == [(17, 6), (17, 24), (17, 24)]
    assert all(t.dtype == torch.bool for t in drawn)


def test_update_spectral_norm():
    jm = JMLP(9, 16, 1, 1, "relu", spectral_norm=True)
    params = jm.init(jax.random.key(3))
    # move the weights so the power iteration has work to do
    params = jax.tree.map(lambda x: x * 1.3 + 0.01, params)
    m = MLP(9, 16, 1, 1, "relu", spectral_norm=True)
    _load_mlp(m, params)
    m.update_spectral_norm()
    want = j_update_sn(params)
    for k, layer in enumerate(want["layers"]):
        np.testing.assert_allclose(getattr(m, f"u{k}").numpy(), np.asarray(layer["u"]), **TOL)
        np.testing.assert_allclose(getattr(m, f"v{k}").numpy(), np.asarray(layer["v"]), **TOL)


def test_actor_sample_log_prob_greedy():
    ja = JActor(7, 3, hidden_size=32, depth=2)
    params = ja.init(jax.random.key(0))
    a = SoftActor(7, 3, hidden_size=32, depth=2)
    _load_mlp(a.net, params)
    rng = np.random.default_rng(1)
    s = rng.normal(size=(20, 7)).astype(np.float32)
    key = jax.random.key(5)
    want_a, want_lp = ja.sample(params, key, jnp.asarray(s))
    mean, log_std = ja.dist(params, jnp.asarray(s))
    eps = (JD.sample_pretanh(key, mean, log_std) - mean) / jnp.exp(log_std)
    with torch.no_grad():
        got_a, got_lp = a.sample(_t(s), eps=_t(eps))
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=1e-4, atol=1e-4)
        act = np.tanh(rng.normal(size=(20, 3))).astype(np.float32)
        np.testing.assert_allclose(
            a.log_prob(_t(s), _t(act)).numpy(),
            np.asarray(ja.log_prob(params, jnp.asarray(s), jnp.asarray(act))),
            rtol=1e-4, atol=1e-4,
        )
        np.testing.assert_allclose(
            a.greedy_action(_t(s)).numpy(), np.asarray(ja.greedy_action(params, jnp.asarray(s))), **TOL
        )


def test_distribution_functions():
    rng = np.random.default_rng(2)
    mean = rng.normal(size=(9, 3)).astype(np.float32)
    log_std = rng.uniform(-3, 1, size=(9, 3)).astype(np.float32)
    z = rng.normal(size=(9, 3)).astype(np.float32) * 3
    np.testing.assert_allclose(
        D.log_prob_from_pretanh(_t(mean), _t(log_std), _t(z)).numpy(),
        np.asarray(JD.log_prob_from_pretanh(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(z))),
        **TOL,
    )
    x = np.linspace(-40, 40, 101).astype(np.float32)
    np.testing.assert_allclose(D.softplus(_t(x)).numpy(), np.asarray(jax.nn.softplus(x)), **TOL)


def test_twin_critic_and_polyak():
    jc = JCritic(5, 2, hidden_size=32, depth=2)
    params = jc.init(jax.random.key(0))
    c = TwinCritic(5, 2, hidden_size=32, depth=2)
    with torch.no_grad():
        for dst, layer_src in zip(c.leaves(), [x for l in params["layers"] for x in (l["w"], l["b"])]):
            dst.copy_(_t(layer_src))
    rng = np.random.default_rng(3)
    s, a = rng.normal(size=(11, 5)).astype(np.float32), rng.normal(size=(11, 2)).astype(np.float32)
    with torch.no_grad():
        q1, q2 = c(_t(s), _t(a))
    w1, w2 = jc.apply(params, jnp.asarray(s), jnp.asarray(a))
    np.testing.assert_allclose(q1.numpy(), np.asarray(w1), **TOL)
    np.testing.assert_allclose(q2.numpy(), np.asarray(w2), **TOL)
    online = jax.tree.map(lambda x: x + 1.0, params)
    target = [t.clone() for t in c.leaves()]
    polyak_update([t + 1.0 for t in c.leaves()], target, 0.99)
    want = j_polyak(online, params, 0.99)
    for got, w in zip(target, [x for l in want["layers"] for x in (l["w"], l["b"])]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("activation,gain", [("relu", 2**0.5), ("tanh", 5 / 3), ("sigmoid", 1.0)])
def test_init_statistics(activation, gain):
    """Orthogonal weights scaled by the activation's gain, final gain 1,
    zero biases, unit spectral-norm vectors; twin critics drawn apart."""
    m = MLP(40, 64, 2, 3, activation, spectral_norm=True)
    m.reset_parameters(torch.Generator().manual_seed(0))
    for k, w in enumerate(m.weights):
        g = gain if k < 2 else 1.0
        w = w.detach()
        gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
        np.testing.assert_allclose(gram.numpy(), g * g * np.eye(gram.shape[0]), atol=1e-5)
        assert float(m.biases[k].detach().abs().max()) == 0.0
        for vec in (getattr(m, f"u{k}"), getattr(m, f"v{k}")):
            assert abs(float(vec.norm()) - 1.0) < 1e-5
    c = TwinCritic(5, 2, hidden_size=16, depth=2)
    c.reset_parameters(torch.Generator().manual_seed(1))
    w = c.weights[1].detach()
    np.testing.assert_allclose((w[0].T @ w[0]).numpy(), 2.0 * np.eye(16), atol=1e-5)
    assert float((w[0] - w[1]).abs().max()) > 0.1
