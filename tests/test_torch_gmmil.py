"""The port's GMMIL path against iltpu's: the pairwise primitives
(iltpu_torch/ops/pairwise.py vs iltpu/ops/pairwise.py), the row sums and
the fused reward (iltpu_torch/ops/gaussian_rowsum.py, the plain twins of the
CUDA kernel's two entries, vs iltpu's Pallas kernel in interpret mode and
vs each other), `GMMILDiscriminator.predict_reward`
on its first and a later call, the trainer's `transition_core` against
iltpu's non-fused update scan, and short CLI runs on the CPU. Inputs are
made with numpy from a seed and handed to both."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.config import load_config as jax_load_config
from iltpu.ops import pairwise as jpw
from iltpu.ops.pallas_pairwise import fused_gaussian_rowsum
from iltpu.ops.pallas_pairwise import gmmil_witness_reward as jax_witness
from iltpu.rewards.gmmil import GMMILDiscriminator as JaxGMMIL
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.ops import pairwise as tpw
from iltpu_torch.ops.gaussian_rowsum import (
    gaussian_rowsum, gaussian_rowsum_plain, gmmil_witness_reward, gmmil_witness_reward_plain)
from iltpu_torch.rewards import GMMILDiscriminator
from iltpu_torch.trainer import Trainer
from test_torch_convert import assert_trees_close, jax_sac_tree
from test_torch_trainer import BASE, _iltpu_noise, _step_data

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 sums over a few features or rows taken in another order than XLA's
# on the CPU: a few ulps of values of order 1.
TOL = dict(rtol=1e-5, atol=1e-6)


def _rows(seed, n, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return np.asarray(scale * rng.normal(size=(n, d)) + 0.3, np.float32)


def _weights(seed, n):
    return np.asarray(1.0 + np.random.default_rng(seed).uniform(size=n), np.float32)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def test_squared_distance_and_weighted_similarity():
    x, y = _rows(0, 37, 7), _rows(1, 53, 7, 2.0)
    wx, wy = _weights(2, 37), _weights(3, 53)
    got = tpw.squared_distance(*_t(x, y))
    want = np.asarray(jpw.squared_distance(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    sim = tpw.weighted_similarity(got, *_t(wx, wy), torch.tensor(0.7))
    want_sim = jpw.weighted_similarity(jnp.asarray(want), jnp.asarray(wx), jnp.asarray(wy), 0.7)
    np.testing.assert_allclose(sim.numpy(), np.asarray(want_sim), **TOL)


@pytest.mark.parametrize("ties", [False, True])
def test_weighted_median(ties):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(24, 31)).astype(np.float32)
    if ties:  # few distinct values, so the stable order decides the pick
        x = np.round(x * 2) / 2
    w = rng.uniform(0.1, 2.0, size=x.shape).astype(np.float32)
    got = tpw.weighted_median(*_t(x, w))
    want = jpw.weighted_median(jnp.asarray(x), jnp.asarray(w))
    assert got.shape == () and float(got) == float(want)  # a value picked from x: exact


@pytest.mark.parametrize("nx,ny,d", [(37, 600, 7), (256, 256, 15), (5, 129, 3)])
def test_rowsum_matches_pallas_kernel(nx, ny, d):
    x, y = _rows(5, nx, d), _rows(6, ny, d, 1.5)
    w = _weights(7, ny) / ny
    g1, g2 = np.float32(0.8), np.float32(3.1)
    want = fused_gaussian_rowsum(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), jnp.asarray(g1),
                                 jnp.asarray(g2), interpret=True)
    args = _t(x, y, w, g1, g2)
    plain = gaussian_rowsum_plain(*args)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    before = gaussian_rowsum.launches
    np.testing.assert_array_equal(gaussian_rowsum(*args).numpy(), plain.numpy())
    assert gaussian_rowsum.launches == before  # CPU tensors: the plain version, no launch
    sa, esa = _rows(8, nx, d), _rows(9, ny, d)
    ws, ew = _weights(10, nx), _weights(11, ny)
    got = gmmil_witness_reward(*_t(sa, esa, ws, ew, g1, g2))
    want = jax_witness(*(jnp.asarray(v) for v in (sa, esa, ws, ew, g1, g2)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nx,ny,S,A,state_only", [
    (37, 600, 5, 2, False), (5, 129, 2, 1, False), (64, 256, 12, 3, False), (33, 70, 12, 3, True),
])
def test_fused_reward_matches_pallas_and_two_calls(nx, ny, S, A, state_only):
    """The fused entry's plain path (on CPU tensors) against iltpu's reward
    through its kernel in interpret mode, and against the reward composed
    from two calls of the single row-sum entry; the atoms are GMMIL's own
    (state-action, or states alone)."""
    td = GMMILDiscriminator(S, A, state_only=state_only)
    s, a = _t(_rows(60, nx, S), _rows(61, nx, A))
    es, ea = _t(_rows(62, ny, S, 1.5), _rows(63, ny, A, 1.5))
    sa, esa = td._atoms(s, a), td._atoms(es, ea)
    w, ew, g1, g2 = _t(_weights(64, nx), _weights(65, ny), np.float32(0.8), np.float32(3.1))
    before = gmmil_witness_reward.launches
    got = gmmil_witness_reward(sa, esa, w, ew, g1, g2)
    assert gmmil_witness_reward.launches == before  # CPU tensors: the plain version
    want = jax_witness(*(jnp.asarray(v.numpy()) for v in (sa, esa, w, ew, g1, g2)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    w_norm, ew_norm = w / w.sum(), ew / ew.sum()
    two_calls = w_norm * (gaussian_rowsum(sa, esa, ew_norm, g1, g2)
                          - gaussian_rowsum(sa, sa, w_norm, g1, g2))
    np.testing.assert_allclose(got.numpy(), two_calls.numpy(), **TOL)


def test_fused_reward_on_cpu_counts_no_launch_and_refuses_mixed_devices():
    sa, esa = _t(_rows(70, 16, 4), _rows(71, 24, 4))
    w, ew = _t(_weights(72, 16), _weights(73, 24))
    g1, g2 = torch.tensor(0.5), torch.tensor(2.0)
    before = gmmil_witness_reward.launches
    got = gmmil_witness_reward(sa, esa, w, ew, g1, g2)
    assert gmmil_witness_reward.launches == before and got.shape == (16,)
    assert torch.equal(got, gmmil_witness_reward_plain(sa, esa, w, ew, g1, g2))
    with pytest.raises(ValueError, match="one device"):
        gmmil_witness_reward(sa, esa, w, ew, g1.to("meta"), g2)


def test_rowsum_refuses_mixed_devices():
    x, y, w = _t(_rows(0, 8, 3), _rows(1, 9, 3), _weights(2, 9))
    with pytest.raises(ValueError, match="one device"):
        gaussian_rowsum(x, y, w, torch.tensor(1.0, device="meta"), torch.tensor(2.0))


@pytest.mark.parametrize("state_only", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_predict_reward_first_and_later_call(state_only, use_pallas):
    S, A, B = 7, 3, 32
    jd = JaxGMMIL(S, A, state_only=state_only, use_pallas=use_pallas)
    td = GMMILDiscriminator(S, A, state_only=state_only)
    jc, tc = jd.init(), td.init()
    assert not tc.settled and not bool(tc.initialized)
    for call in range(2):
        s, a, es, ea = (_rows(20 + 4 * call + i, B, n) for i, n in enumerate((S, A, S, A)))
        w, ew = _weights(30 + call, B), _weights(40 + call, B)
        jc, want = jd.predict_reward(jc, *(jnp.asarray(v) for v in (s, a, es, ea, w, ew)))
        tc, got = td.predict_reward(tc, *_t(s, a, es, ea, w, ew))
        what = f"call {call}"
        assert tc.settled and bool(tc.initialized)
        # the bandwidths are 1 / (a median picked from each side's distances)
        np.testing.assert_allclose(float(tc.gamma_1), float(jc.gamma_1), rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(float(tc.gamma_2), float(jc.gamma_2), rtol=1e-5, err_msg=what)
        # w_i (sim - self-sim), a difference of O(1 / B) terms: rewards of
        # order 1e-3, so atol sits 1e-4 below their scale
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7, err_msg=what)


def test_reward_is_zero_on_identical_batches():
    S, A, B = 5, 2, 64
    td = GMMILDiscriminator(S, A)
    s, a = _t(_rows(50, B, S), _rows(51, B, A))
    w = torch.from_numpy(_weights(52, B))
    carry, r = td.predict_reward(td.init(), s, a, s, a, w, w)
    assert torch.equal(r, torch.zeros(B))
    _, r = td.predict_reward(carry, s, a, s, a, w, w)
    assert torch.equal(r, torch.zeros(B))


GMMIL = [a for a in BASE if not a.startswith(("algorithm", "training.disc_pallas",
                                               "training.fused_update_scan"))]
GMMIL += ["algorithm=GMMIL", "training.disc_pallas=false", "training.fused_update_scan=false"]


def test_transition_core_matches_iltpu(tmp_path):
    """3 x 8 updates through iltpu's non-fused update scan (GMMIL reward ->
    the SAC kernel), from the first call's bandwidths on."""
    jt = JaxTrainer(jax_load_config(GMMIL), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(GMMIL + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    state = jt.state
    convert.load_sac_tree_(tt.sac, jax_sac_tree(state["sac"]))
    S, A, n, B = jt.env.obs_size, jt.env.action_size, 4, 16
    tol = dict(rtol=1e-4, atol=1e-5)  # the chain tolerance
    for it in range(3):
        data = _step_data(jax.random.key(100 + it), n, S, A)
        base_key = jax.random.key(7 + it)
        step = it * n
        state, aux = jt._transition_core(
            state, base_key, jnp.asarray(step, jnp.int32), data["obs"], data["actions"],
            data["rewards"], data["next_obs"], data["terminals"], data["timeouts"], n_updates=8,
        )
        noise = _iltpu_noise(state, base_key, step, 8, B, A, False)
        t = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
        taux = tt.transition_core(step, t["obs"], t["actions"], t["rewards"], t["next_obs"],
                                  t["terminals"], t["timeouts"], 8, noise=noise)
        what = f"iteration {it}"
        g = state["disc"]
        np.testing.assert_allclose(float(tt.disc_state.gamma_1), float(g.gamma_1), rtol=1e-5)
        np.testing.assert_allclose(float(tt.disc_state.gamma_2), float(g.gamma_2), rtol=1e-5)
        assert bool(tt.disc_state.initialized) and bool(g.initialized)
        assert_trees_close(convert.sac_tree(tt.sac), jax_sac_tree(state["sac"]), what=what, **tol)
        assert sorted(taux) == sorted(aux)
        for k, v in aux.items():
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(v), err_msg=f"{what} aux {k}", **tol)


def test_cli_short_run_on_cpu(tmp_path):
    args = [a for a in GMMIL if not a.startswith(("steps", "reinforcement"))] + [
        "steps=200", "evaluation.episodes=2", "check_time_usage=true",
        "reinforcement.actor.hidden_size=16", "reinforcement.critic.hidden_size=16",
        "platform=cpu", f"output_dir={tmp_path}",
    ]
    r = subprocess.run(
        [sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert np.isfinite(summary["mean_normalized_score"])
    for name in ("agent.pkl", "metrics.pkl", "config.json"):
        assert os.path.exists(os.path.join(summary["out_dir"], name))
    assert not os.path.exists(os.path.join(summary["out_dir"], "discriminator.pkl"))


@pytest.mark.parametrize("flag", ["training.fused_update_scan", "training.disc_pallas"])
def test_kernel_flags_iltpu_refuses_raise_value_error(tmp_path, flag):
    args = [a for a in GMMIL if not a.startswith(flag)] + [f"{flag}=true", "platform=cpu"]
    with pytest.raises(ValueError, match=flag):
        Trainer(load_config(args), out_dir=str(tmp_path))
    with pytest.raises(ValueError, match=flag):
        JaxTrainer(jax_load_config(args[:-1]), out_dir=str(tmp_path / "jax"))


@pytest.mark.parametrize("override,item", [
    ("imitation.bc_aux_loss=true", "Other algorithms"),
    ("imitation.mix_expert_data=mixed_batch", "Other algorithms"),
    ("reinforcement.actor.depth=3", "Autograd updates"),
    ("training.sac_pallas=false", "Autograd updates"),
])
def test_refuses_what_is_not_ported(tmp_path, override, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, '{item}'"):
        Trainer(load_config(GMMIL + [override, "platform=cpu"]), out_dir=str(tmp_path))
