"""The port's PWIL (iltpu_torch/rewards/pwil.py over
iltpu_torch/ops/pwil_transport.py, whose plain version runs on the CPU)
against iltpu's: the normalisation (population std, a constant feature),
`compute_reward` step by step across done-resets against iltpu's vmapped
PWIL step, the exhausted-pool guard, the expert relabelling against
iltpu's sequential scan, the transport's segments against one pool at a
time, inputs that stress the card's selection kernel (exact ties on an
integer grid, pools of tiny masses so a row takes more than 64 atoms,
pools that run out), a numpy "sorted walk" (the masked (distance, index)
list sorted, then walked) against iltpu's greedy loop, and short CLI runs. The pools must equal iltpu's exactly (they are
only ever min and subtract on float32 weights); the rewards carry the
distances' rounding: rtol 1e-5 / atol 1e-6. Inputs are made with numpy from
a seed and handed to both."""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.config import load_config as jax_load_config
from iltpu.rewards.pwil import PWILDiscriminator as JaxPWIL
from iltpu.rewards.pwil import PWILState as JaxPWILState
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.ops import build
from iltpu_torch.ops.pwil_transport import feature_major, pwil_transport, pwil_transport_plain
from iltpu_torch.rewards import PWILDiscriminator
from iltpu_torch.trainer import Trainer
from test_torch_trainer import COMMON

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-6)
PWIL = COMMON + ["algorithm=PWIL", "training.sac_pallas=true"]


def _expert(seed, n, S, A):
    rng = np.random.default_rng(seed)
    return (np.asarray(rng.normal(size=(n, S)) * 1.5 + 0.2, np.float32),
            np.asarray(np.tanh(rng.normal(size=(n, A))), np.float32))


def _pair(es, ea, **kw):
    S, A = es.shape[1], ea.shape[1]
    jd = JaxPWIL(S, A, expert_states=jnp.asarray(es), expert_actions=jnp.asarray(ea), **kw)
    td = PWILDiscriminator(S, A, expert_states=torch.from_numpy(es),
                           expert_actions=torch.from_numpy(ea), **kw)
    return jd, td


@pytest.mark.parametrize("state_only", [False, True])
def test_normalisation_matches_iltpu(state_only):
    """1/std with the mean subtracted, the population std, a feature of
    zero std at scale 1."""
    es, ea = _expert(0, 40, 5, 2)
    es[:, 3] = 0.75  # a constant feature
    jd, td = _pair(es, ea, state_only=state_only)
    assert float(td.data_scale[3]) == 1.0
    std = np.std(np.concatenate([es] if state_only else [es, ea], 1).astype(np.float64), 0)
    np.testing.assert_allclose(1.0 / td.data_scale.numpy()[std > 0], std[std > 0], rtol=1e-5)
    for name in ("data_scale", "data_offset", "expert_atoms"):
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                   err_msg=name, **TOL)
    assert td.reward_bandwidth == jd.reward_bandwidth


def test_compute_reward_matches_iltpu_pwil_step(tmp_path):
    """iltpu's vmapped step with its done-reset (trainer.py:495-510), 40
    steps of 4 envs from the same expert buffer, resets included."""
    jt = JaxTrainer(jax_load_config(PWIL), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(PWIL + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    np.testing.assert_allclose(tt.disc.expert_atoms.numpy(), np.asarray(jt.disc.expert_atoms), **TOL)
    pool = jt.state["disc"]
    convert.load_pwil_pools_(tt.disc_state, np.asarray(pool.expert_weights))
    S, A, n = jt.env.obs_size, jt.env.action_size, 4
    rng = np.random.default_rng(1)
    resets = 0
    for step in range(40):
        s = np.asarray(rng.normal(size=(n, S)), np.float32)
        a = np.asarray(np.tanh(rng.normal(size=(n, A))), np.float32)
        done = rng.uniform(size=n) < 0.08
        resets += int(done.sum())
        pool, want = jt._pwil_step(pool, jnp.asarray(s), jnp.asarray(a), jnp.asarray(done))
        _, got = tt.disc.compute_reward(tt.disc_state, torch.from_numpy(s), torch.from_numpy(a),
                                        torch.from_numpy(done))
        np.testing.assert_array_equal(convert.pwil_pools(tt.disc_state),
                                      np.asarray(pool.expert_weights), err_msg=f"step {step}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {step}", **TOL)
    assert resets > 0


def test_exhausted_pool_guard():
    """The loop stops when no atom has mass left: a pool holding less mass
    than the agent atom's is emptied, and an empty pool gives scale."""
    es, ea = _expert(2, 3, 4, 2)
    jd, td = _pair(es, ea, time_horizon=2)
    s, a = np.ones(4, np.float32), np.zeros(2, np.float32)
    for mass in (0.1, 0.0):
        jc = jd.init().replace(expert_weights=jnp.full(3, mass, jnp.float32))
        jc, want = jax.jit(jd.compute_reward)(jc, jnp.asarray(s), jnp.asarray(a))
        tc = td.init(1)
        tc.expert_weights.fill_(mass)
        _, got = td.compute_reward(tc, torch.from_numpy(s[None]), torch.from_numpy(a[None]))
        np.testing.assert_array_equal(tc.expert_weights[0].numpy(), np.asarray(jc.expert_weights))
        assert not bool((tc.expert_weights > 0).any())
        np.testing.assert_allclose(got.numpy(), [float(want)], **TOL)
    assert float(got[0]) == np.float32(td.reward_scale)


def test_expert_relabelling_matches_iltpu(tmp_path):
    """The rewards of iltpu's sequential scan over the expert rows, the pool
    reset at each trajectory's end (trainer.py:512-533), from one launch of
    one segment per trajectory; ends placed by hand, two in a row among
    them."""
    args = PWIL + ["imitation.mix_expert_data=prefill_memory"]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    expert = jt.state["expert"]
    n = int(expert.size)
    terminals = np.zeros(n, np.float32)
    terminals[[36, 80, 81, n // 2]] = 1.0
    timeouts = np.array(expert.timeouts)
    want = np.asarray(jt._pwil_relabel_expert(expert.replace(terminals=jnp.asarray(terminals))).rewards)
    got = tt.disc.relabel(tt.expert.rows("states"), tt.expert.rows("actions"),
                          torch.from_numpy(terminals), torch.from_numpy(timeouts))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_segments_equal_one_pool_at_a_time():
    """A launch over segments of different lengths gives each pool what it
    gets alone, row by row, and resets a pool after a flagged row."""
    rng = np.random.default_rng(3)
    N, d = 30, 6
    atoms = torch.from_numpy(np.asarray(rng.normal(size=(N, d)), np.float32))
    queries = torch.from_numpy(np.asarray(rng.normal(size=(17, d)), np.float32))
    offsets = torch.tensor([0, 5, 5, 12, 17], dtype=torch.int32)
    reset = torch.from_numpy(rng.uniform(size=17) < 0.2)
    kw = dict(atom_weight=1.0 / N, agent_weight=1.0 / 7 - 1e-6, bandwidth=2.0, scale=3.0)
    pools = torch.full((4, N), 1.0 / N)
    got = pwil_transport(atoms, pools, queries, offsets, reset, **kw)
    for p in range(4):
        pool = torch.full((1, N), 1.0 / N)
        for r in range(int(offsets[p]), int(offsets[p + 1])):
            want = pwil_transport_plain(atoms, pool, queries[r:r + 1], torch.tensor([0, 1], dtype=torch.int32),
                                        reset[r:r + 1], **kw)
            assert torch.equal(got[r:r + 1], want), (p, r)
        assert torch.equal(pools[p], pool[0]), p


def _stress(kind, seed=4, envs=6, n=300, S=4, A=2, steps=3):
    """Expert data, pools (envs, n), `steps` agent atoms per env and the
    episode length T for the inputs that stress the kernel's selection:
    - grid_ties: 3 state and 1 action features on the integers 0..2 (81
      points for 300 atoms), so atoms repeat and many distances are
      exactly equal; agents on the same grid, of
      1/20 each (15 atoms a row, ties among them);
    - drained: pools of tiny random masses (and some spent atoms), so an
      agent atom of 1/T takes about 100 of them, past two selections of 32;
    - exhausted: pools holding less mass than one agent atom, one of them
      empty from the start;
    - ant_drained: drained's pools over ant's 120-feature atoms (state 112,
      action 8), the card kernel's widest."""
    rng = np.random.default_rng(seed)
    if kind == "ant_drained":
        S, A = 112, 8
    if kind == "grid_ties":
        S, A = 3, 1
        es = rng.integers(0, 3, (n, S)).astype(np.float32)
        ea = rng.integers(0, 3, (n, A)).astype(np.float32)
        s = rng.integers(0, 3, (steps, envs, S)).astype(np.float32)
        a = rng.integers(0, 3, (steps, envs, A)).astype(np.float32)
        pools = np.full((envs, n), np.float32(1.0 / n), np.float32)
    else:
        es, ea = _expert(seed, n, S, A)
        s = np.asarray(rng.normal(size=(steps, envs, S)) * 1.5, np.float32)
        a = np.asarray(np.tanh(rng.normal(size=(steps, envs, A))), np.float32)
        if kind in ("drained", "ant_drained"):
            pools = np.asarray(rng.uniform(0, 2e-5, (envs, n)), np.float32)
            pools[rng.uniform(size=(envs, n)) < 0.2] = 0.0
        else:
            pools = np.full((envs, n), np.float32(5e-7), np.float32)
            pools[0] = 0.0
    return es, ea, s, a, pools, 20 if kind == "grid_ties" else 1000


def _distances(atoms, q):
    """The port's distances in float32 numpy: squared differences summed
    feature by feature, then the root."""
    acc = np.zeros(atoms.shape[0], np.float32)
    for k in range(atoms.shape[1]):
        t = atoms[:, k] - q[k]
        acc = acc + t * t
    return np.sqrt(acc)


def _greedy_loop(pool, dist, weight):
    """iltpu's while loop (iltpu/rewards/pwil.py:85-105) in float32 numpy:
    a masked argmin a round."""
    pool, w, cost = pool.copy(), np.float32(weight), np.float32(0.0)
    while w > 0 and (pool > 0).any():
        i = int(np.argmin(np.where(pool > 0, dist, np.float32(np.inf))))
        consume = min(w, pool[i])
        cost = cost + consume * dist[i]
        pool[i] = pool[i] - consume
        w = w - consume
    return pool, cost


def _sorted_walk(pool, dist, weight):
    """The identity the card's kernel rests on: sort the atoms with mass
    left by (distance, index) once, then walk them with the loop's
    arithmetic until the weight is spent."""
    pool, w, cost = pool.copy(), np.float32(weight), np.float32(0.0)
    alive = np.flatnonzero(pool > 0)
    for i in alive[np.lexsort((alive, dist[alive]))]:
        if not w > 0:
            break
        consume = min(w, pool[i])
        cost = cost + consume * dist[i]
        pool[i] = pool[i] - consume
        w = w - consume
    return pool, cost


@pytest.mark.parametrize("kind", ["grid_ties", "drained", "exhausted", "ant_drained"])
def test_stress_inputs_match_iltpu(kind):
    """compute_reward on the selection kernel's hard inputs, step by step
    against iltpu's jitted, vmapped one: pools equal, rewards close."""
    es, ea, s, a, pools, T = _stress(kind)
    jd, td = _pair(es, ea, time_horizon=T)
    jstep = jax.jit(jax.vmap(jd.compute_reward))
    jc = JaxPWILState(expert_weights=jnp.asarray(pools))
    tc = td.init(pools.shape[0])
    tc.expert_weights.copy_(torch.from_numpy(pools))
    for step in range(s.shape[0]):
        jc, want = jstep(jc, jnp.asarray(s[step]), jnp.asarray(a[step]))
        _, got = td.compute_reward(tc, torch.from_numpy(s[step]), torch.from_numpy(a[step]))
        np.testing.assert_array_equal(tc.expert_weights.numpy(), np.asarray(jc.expert_weights),
                                      err_msg=f"step {step}")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {step}", **TOL)
    if kind == "exhausted":
        assert not bool((tc.expert_weights > 0).any())
        assert float(got[0]) == np.float32(td.reward_scale)


@pytest.mark.parametrize("kind", ["grid_ties", "drained", "exhausted"])
def test_sorted_walk_equals_greedy_loop(kind):
    """One sort and a walk give iltpu's greedy loop bit for bit: the pools
    and the costs equal a float32 transcription of the loop, and the pools
    equal iltpu's jitted compute_reward. On these inputs a row takes up to
    ~100 atoms (drained) and every atom of its pool (exhausted)."""
    es, ea, s, a, pools, T = _stress(kind)
    jd, td = _pair(es, ea, time_horizon=T)
    jstep = jax.jit(jax.vmap(jd.compute_reward))
    atoms = td.expert_atoms.numpy()
    weight = np.float32(td.agent_weight)
    jc = JaxPWILState(expert_weights=jnp.asarray(pools))
    walked, taken = pools.copy(), 0
    for step in range(s.shape[0]):
        jc, want = jstep(jc, jnp.asarray(s[step]), jnp.asarray(a[step]))
        queries = td.normalise(torch.from_numpy(np.concatenate([s[step], a[step]], 1))).numpy()
        for e in range(pools.shape[0]):
            dist = _distances(atoms, queries[e])
            loop_pool, loop_cost = _greedy_loop(walked[e], dist, weight)
            walk_pool, walk_cost = _sorted_walk(walked[e], dist, weight)
            np.testing.assert_array_equal(walk_pool, loop_pool)
            assert walk_cost.tobytes() == loop_cost.tobytes(), (step, e)
            taken = max(taken, int((walk_pool != walked[e]).sum()))
            walked[e] = walk_pool
            reward = np.float32(td.reward_scale) * np.exp(np.float32(-td.reward_bandwidth) * walk_cost)
            np.testing.assert_allclose(reward, np.asarray(want)[e], **TOL)
        np.testing.assert_array_equal(walked, np.asarray(jc.expert_weights), err_msg=f"step {step}")
    assert taken > (64 if kind != "grid_ties" else 10)


def test_feature_major_copy_is_kept_until_the_atoms_change():
    """The kernel's (d, N) copy of the atoms: made once, kept on the tensor,
    made again after an in-place write."""
    atoms = torch.from_numpy(np.asarray(np.random.default_rng(5).normal(size=(9, 4)), np.float32))
    fm = feature_major(atoms)
    assert fm.shape == (4, 9) and fm.is_contiguous() and torch.equal(fm, atoms.t())
    assert feature_major(atoms) is fm
    atoms.mul_(2.0)
    assert torch.equal(feature_major(atoms), atoms.t())


def test_measuring_variant_builds_from_the_kernel_source():
    """The stamped variant includes the transport's source, so an edit to
    the kernel changes the variant's build key too."""
    names = [os.path.basename(p) for p in build._sources("pwil_phases")]
    assert names[:2] == ["pwil_phases.cu", "pwil_transport.cu"]
    assert [os.path.basename(p) for p in build._sources("pwil_transport")][0] == "pwil_transport.cu"
    assert "pwil_transport.cu" not in [os.path.basename(p) for p in build._sources("sac_update")]


@pytest.mark.parametrize("extra", [[], ["imitation.mix_expert_data=prefill_memory"],
                                   ["training.on_device_loop=true"]],
                         ids=["none", "prefill_memory", "on_device_loop"])
def test_cli_short_run_on_cpu(tmp_path, extra):
    args = [a for a in PWIL if not a.startswith(("steps", "num_envs", "reinforcement"))] + [
        "steps=240", "num_envs=2", "evaluation.episodes=2", "check_time_usage=true",
        "logging.interval=40",
        "reinforcement.actor.hidden_size=16", "reinforcement.critic.hidden_size=16",
        "platform=cpu", f"output_dir={tmp_path}", *extra]
    r = subprocess.run(
        [sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert np.isfinite(summary["mean_normalized_score"])
    out = summary["out_dir"]
    assert not os.path.exists(os.path.join(out, "discriminator"))
    with open(os.path.join(out, "metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    assert metrics["update_steps"] and np.isfinite(metrics["alphas"]).all()
    # the training return is the env's reward, not PWIL's (which is positive)
    assert metrics["train_returns"] and min(r[0] for r in metrics["train_returns"]) < 0
