"""The port's trainer (iltpu_torch/trainer.py) against iltpu's:
`transition_core` against iltpu's `_transition_core` in the setup of
tests/test_fused_scan.py (3 iterations x 8 updates, with iltpu's own draws
reproduced here from its key derivation and handed across) on the fused
GAIL path (per update and K-blocked with update_block=4) and on the
per-update body of the other algorithms (AdRIL, RED, DRIL with bc_aux_loss,
SAC's autograd update, GAIL's autograd update with expert mixing); short
runs through the CLI on the CPU (GAIL, and SAC, BC, SQIL, DRIL, RED); the
package imports neither JAX nor iltpu; what is not ported raises; and
without platform=cpu and without CUDA the entry point raises."""

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
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.trainer import Trainer
from test_torch_algorithms import jax_opt_tree
from test_torch_convert import assert_trees_close, jax_disc_tree, jax_sac_tree, np_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = [
    "algorithm=GAIL",
    "env=pointmass",
    "env_backend=jax",
    "steps=300",
    "training.start=64",
    "num_envs=4",
    "evaluation.interval=1000",
    "evaluation.episodes=1",
    "logging.interval=0",
    "memory.size=1000",
    "imitation.trajectories=4",
    "training.batch_size=16",
    "training.sac_pallas=true",
    "training.disc_pallas=true",
    "training.fused_update_scan=true",
    "reinforcement.actor.hidden_size=32",
    "reinforcement.critic.hidden_size=32",
]

TUNEDLIKE = [
    "imitation.loss_function=Mixup",
    "imitation.discriminator.reward_function=AIRL",
    "imitation.entropy_bonus=0.01",
]


def _step_data(key, n, S, A):
    ks = jax.random.split(key, 4)
    return dict(
        obs=jax.random.normal(ks[0], (n, S)),
        actions=jnp.tanh(jax.random.normal(ks[1], (n, A))),
        rewards=jax.random.normal(ks[2], (n,)),
        next_obs=jax.random.normal(ks[3], (n, S)),
        terminals=(jax.random.uniform(ks[2], (n,)) < 0.2).astype(jnp.float32),
        timeouts=jnp.zeros((n,), jnp.float32),
    )


def _iltpu_noise(state, base_key, step, n_updates, B, A, mixup, dril=None):
    """iltpu's per-iteration draws (trainer.py:767-785, 807-835); with
    `dril` = [(width, rate) per layer], also the keep-masks of DRIL's five
    members from each update's k_rew (update_fn's split(key, 6))."""
    keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.fold_in(base_key, 0x5AC + i), step)
    )(jnp.arange(n_updates))
    kp, ke = jax.random.split(jax.random.fold_in(base_key, step + 0xB17C))

    def raw(rs, k):
        limit = jnp.where(rs.full, rs.size - 1, jnp.maximum(rs.idx - 1, 1))
        return jax.random.randint(k, (n_updates * B,), 0, limit)

    def derive(k):
        _, _, k_disc, _, _, k_sac = jax.random.split(k, 6)
        k_mixup, k_gp = jax.random.split(k_disc)
        k_next, k_new = jax.random.split(k_sac)
        return {
            "eps_gp": jax.random.uniform(k_gp, (B,)),
            "eps2": jax.random.normal(k_next, (B, A), jnp.float32),
            "eps_new": jax.random.normal(k_new, (B, A), jnp.float32),
            "mix": jax.random.uniform(k_mixup, (B,)),
        }

    noise = dict(jax.vmap(derive)(keys))
    if not mixup:
        noise.pop("mix")
    if dril is not None:
        def members(k):
            k_rew = jax.random.split(k, 6)[3]
            return [jnp.stack([
                jax.random.bernoulli(jax.random.fold_in(km, layer), 1.0 - rate, (B, width))
                for km in jax.random.split(k_rew, 5)]) for layer, (width, rate) in enumerate(dril)]

        for layer, m in enumerate(jax.vmap(members)(keys)):
            if dril[layer][1] > 0:
                noise[f"dril_mask{layer}"] = m
    noise["replay"] = raw(state["replay"], kp)
    noise["expert"] = raw(state["expert"], ke)
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


@pytest.mark.parametrize(
    "extra,block",
    [((), 1), (TUNEDLIKE, 1), ((), 4), (TUNEDLIKE, 4)],
    ids=["bce_sn", "mixup_airl", "bce_sn-kblock4", "mixup_airl-kblock4"],
)
def test_transition_core_matches_iltpu(tmp_path, extra, block):
    """update_block=4 takes iltpu's K-blocked kernel (two launches of 4 per
    iteration) and the port's kblock_update."""
    args = BASE + list(extra) + [f"training.update_block={block}"]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    state = jt.state
    convert.load_sac_tree_(tt.sac, jax_sac_tree(state["sac"]))
    convert.load_disc_tree_(tt.disc_state, jax_disc_tree(state["disc"], state["disc_opt"]))
    for col in ("states", "actions", "next_states", "terminals", "weights"):
        np.testing.assert_array_equal(tt.expert.rows(col).numpy(), np.asarray(getattr(state["expert"], col)))
    S, A, n, B = jt.env.obs_size, jt.env.action_size, 4, 16

    for it in range(3):
        data = _step_data(jax.random.key(100 + it), n, S, A)
        base_key = jax.random.key(7 + it)
        step = it * n
        state, aux = jt._transition_core(
            state, base_key, jnp.asarray(step, jnp.int32), data["obs"], data["actions"],
            data["rewards"], data["next_obs"], data["terminals"], data["timeouts"], n_updates=8,
        )
        noise = _iltpu_noise(state, base_key, step, 8, B, A, bool(extra))
        t = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
        taux = tt.transition_core(
            step, t["obs"], t["actions"], t["rewards"], t["next_obs"], t["terminals"],
            t["timeouts"], 8, noise=noise,
        )
        tol = dict(rtol=1e-4, atol=1e-5)
        what = f"iteration {it}"
        for col in ("step", "states", "actions", "rewards", "next_states", "terminals", "timeouts", "weights"):
            np.testing.assert_array_equal(tt.replay.rows(col).numpy(), np.asarray(getattr(state["replay"], col)))
        assert int(tt.replay.idx) == int(state["replay"].idx)
        assert int(tt.replay.num_trajectories) == int(state["replay"].num_trajectories)
        assert_trees_close(convert.sac_tree(tt.sac), jax_sac_tree(state["sac"]), what=what, **tol)
        assert_trees_close(
            convert.disc_tree(tt.disc_state), jax_disc_tree(state["disc"], state["disc_opt"]),
            what=what, **tol,
        )
        for k, v in aux.items():
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(v), err_msg=f"{what} aux {k}", **tol)


COMMON = [a for a in BASE if not a.startswith(("algorithm", "training.sac", "training.disc",
                                               "training.fused"))]

# The per-update body of each algorithm: (overrides, the SAC path).
ALGORITHMS = {
    "adril": ["algorithm=AdRIL", "imitation.update_freq=6", "training.sac_pallas=true"],
    "red": ["algorithm=RED", "training.sac_pallas=false"],
    "dril_bc_aux": ["algorithm=DRIL", "training.sac_pallas=true"],
    "sac_autograd": ["algorithm=SAC"],
    "gail_autograd_mixed": ["algorithm=GAIL", "imitation.mix_expert_data=mixed_batch",
                            "training.sac_pallas=false"] + TUNEDLIKE,
}


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_transition_core_per_algorithm_matches_iltpu(tmp_path, name):
    """3 iterations x 8 updates through iltpu's non-fused update scan
    (`update_fn`) and the port's per-update body, from the same state."""
    args = COMMON + ALGORITHMS[name]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    state = jt.state
    convert.load_sac_tree_(tt.sac, jax_sac_tree(state["sac"]))
    S, A, n, B = jt.env.obs_size, jt.env.action_size, 4, 16
    expert = jt.expert
    dril = None
    if tt.algorithm == "DRIL":
        d = tt.disc.net
        dril = [(S, d.input_dropout)] + [(d.hidden_size, d.dropout)] * d.depth
        convert.load_opt_tree_(tt.disc_state, jax_opt_tree(state["disc"], state["disc_opt"]))
        u = jt.disc.action_uncertainty(state["disc"], jax.random.key(3), expert.states, expert.actions)
        state["dril_threshold"] = jnp.quantile(u, 0.5)
        tt.dril_threshold = torch.tensor(float(state["dril_threshold"]))
    elif tt.algorithm == "RED":
        red = state["disc"]
        convert.load_red_tree_(tt.disc_state, {
            **jax_opt_tree(red.predictor, state["disc_opt"]), "target": np_tree(red.target),
            "sigma_1": np.asarray(red.sigma_1), "sigma_set": bool(red.sigma_set)})
        state["disc"] = jt.disc.set_sigma(red, expert.states[:B], expert.actions[:B])
        tt.disc.set_sigma(tt.disc_state, tt.expert.rows("states")[:B], tt.expert.rows("actions")[:B])
        np.testing.assert_allclose(float(tt.disc_state["sigma_1"]), float(state["disc"].sigma_1),
                                   rtol=2e-5)
    elif tt.algorithm == "GAIL":
        convert.load_disc_tree_(tt.disc_state, jax_disc_tree(state["disc"], state["disc_opt"]))
    tol = dict(rtol=1e-4, atol=1e-5)  # the chain tolerance
    core = jax.jit(jt._transition_core, static_argnames=("n_updates",))  # traced once
    for it in range(3):
        data = _step_data(jax.random.key(100 + it), n, S, A)
        base_key = jax.random.key(7 + it)
        step = it * n
        state, aux = core(
            state, base_key, jnp.asarray(step, jnp.int32), data["obs"], data["actions"],
            data["rewards"], data["next_obs"], data["terminals"], data["timeouts"], n_updates=8,
        )
        noise = _iltpu_noise(state, base_key, step, 8, B, A,
                             tt.cfg.imitation.get("loss_function") == "Mixup", dril)
        if tt.algorithm != "GAIL":
            noise.pop("eps_gp")
        t = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
        taux = tt.transition_core(step, t["obs"], t["actions"], t["rewards"], t["next_obs"],
                                  t["terminals"], t["timeouts"], 8, noise=noise)
        what = f"{name} iteration {it}"
        assert_trees_close(convert.sac_tree(tt.sac), jax_sac_tree(state["sac"]), what=what, **tol)
        if tt.algorithm == "GAIL":
            assert_trees_close(convert.disc_tree(tt.disc_state),
                               jax_disc_tree(state["disc"], state["disc_opt"]), what=what, **tol)
        if tt.algorithm == "AdRIL":
            assert bool(tt.relabel) == bool(state["relabel"].sample_expert)
        assert sorted(taux) == sorted(aux), what
        for k, v in aux.items():
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(v), err_msg=f"{what} aux {k}", **tol)


CLI = BASE[:-2] + [
    "reinforcement.actor.hidden_size=16",
    "reinforcement.critic.hidden_size=16",
    "steps=200",
    "evaluation.episodes=2",
    "check_time_usage=true",
]


def _run(code, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_cli_short_run_on_cpu(tmp_path):
    args = CLI + ["platform=cpu", f"output_dir={tmp_path}"]
    r = subprocess.run(
        [sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert np.isfinite(summary["mean_normalized_score"])
    for name in ("agent.pkl", "discriminator.pkl", "metrics.pkl", "config.json"):
        assert os.path.exists(os.path.join(summary["out_dir"], name))


CLI_ALGORITHMS = {
    "SAC": ([], "no discriminator"),
    "BC": (["bc_pretraining.iterations=20"], "no discriminator"),
    "SQIL": (["training.sac_pallas=true"], "no discriminator"),
    "DRIL": (["imitation.pretraining.iterations=20", "training.sac_pallas=true"], "discriminator.pkl"),
    "RED": (["imitation.pretraining.iterations=20"], "discriminator.pkl"),
}


@pytest.mark.parametrize("alg", list(CLI_ALGORITHMS))
def test_cli_other_algorithms_on_cpu(tmp_path, alg):
    """The SAC default (autograd), BC's early exit, and SQIL, DRIL and RED
    through their pretraining and the loop."""
    extra, disc = CLI_ALGORITHMS[alg]
    args = [a for a in COMMON if not a.startswith(("steps", "reinforcement"))] + [
        f"algorithm={alg}", "steps=200", "evaluation.episodes=2", "check_time_usage=true",
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
    for name in ("agent.pkl", "metrics.pkl", "config.json"):
        assert os.path.exists(os.path.join(out, name))
    assert os.path.exists(os.path.join(out, "discriminator.pkl")) == (disc == "discriminator.pkl")
    with open(os.path.join(out, "metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    if alg == "BC":
        assert metrics["test_steps"] == [0] and "pre_training_time" in metrics
        assert metrics["update_steps"] == []
    else:
        assert metrics["update_steps"] and np.isfinite(metrics["alphas"]).all()


def test_port_imports_neither_jax_nor_iltpu(tmp_path):
    code = f"""
import importlib, pkgutil, sys
import iltpu_torch
for m in pkgutil.walk_packages(iltpu_torch.__path__, "iltpu_torch."):
    importlib.import_module(m.name)
from iltpu_torch.train import main
main({CLI + ['platform=cpu', f'output_dir={tmp_path}']!r})
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "iltpu", "yaml"))
assert not bad, bad
print("clean")
"""
    r = _run(code, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("clean")


def test_gpu_entry_point_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["platform=gpu"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(load_config(BASE + platform), out_dir=str(tmp_path))


@pytest.mark.parametrize("override,error,match", [
    ("algorithm=PWIL", NotImplementedError, "ROADMAP.md, 'Other algorithms'"),
    ("imitation.discriminator.reward_shaping=true", NotImplementedError, "ROADMAP.md, 'GAIL options'"),
    ("imitation.state_only=true", NotImplementedError, "ROADMAP.md, 'GAIL options'"),
    ("imitation.mixup_alpha=0.5", NotImplementedError, "ROADMAP.md, 'GAIL options'"),
    ("reinforcement.critic.depth=3", ValueError, "training.sac_pallas=true requires"),
    ("imitation.loss_function=PUGAIL", ValueError, "training.disc_pallas=true supports"),
])
def test_refuses_pwil_gail_options_and_kernel_shapes(tmp_path, override, error, match):
    """PWIL and the GAIL input options are not ported, on either update
    path; the kernel flags refuse what iltpu refuses, with its ValueError."""
    base = BASE if error is ValueError else COMMON + ["algorithm=GAIL"]
    args = base + TUNEDLIKE[:1] + [override, "platform=cpu"]
    with pytest.raises(error, match=match):
        Trainer(load_config(args), out_dir=str(tmp_path))
    if error is ValueError:
        with pytest.raises(ValueError):
            JaxTrainer(jax_load_config(args[:-1]), out_dir=str(tmp_path / "jax"))
