"""The port's trainer (iltpu_torch/trainer.py) against iltpu's:
`transition_core` against iltpu's `_transition_core` in the setup of
tests/test_fused_scan.py (3 iterations x 8 updates, with iltpu's own draws
reproduced here from its key derivation and handed across) on the fused
GAIL path (per update and K-blocked with update_block=4) and on the
per-update body of the other algorithms (AdRIL, RED, DRIL with bc_aux_loss,
SAC's autograd update, GAIL's autograd update with expert mixing, PWIL with
its pools and stored rewards); short
runs through the CLI on the CPU (GAIL, and SAC, BC, SQIL, DRIL, RED); the
package imports neither JAX nor iltpu; what is not ported raises; and
without platform=cpu and without CUDA the entry point raises."""

import importlib.util
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

# iltpu's main path at a small size: hopper on the C++ stepper, its expert data
HOPPER = ["env=hopper", "env_backend=native",
          f"expert_data.source={os.path.join(REPO, 'data', 'hopper_expert.npz')}"]


def hopper_hdf5() -> str:
    """data/d4rl/hopper_expert.hdf5 (D4RL's layout of data/hopper_expert.npz,
    written by h5py: data/d4rl/make_fixture.py), decoded from its committed
    text form by data/d4rl/fixture.py."""
    spec = importlib.util.spec_from_file_location(
        "d4rl_fixture", os.path.join(REPO, "data", "d4rl", "fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.unpack()

# ant: 112 + 8 = 120 discriminator inputs, the card's wide GAIL variant
ANT = ["env=ant", "env_backend=native",
       f"expert_data.source={os.path.join(REPO, 'data', 'ant_expert.npz')}"]


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
    [((), 1), (TUNEDLIKE, 1), ((), 4), (TUNEDLIKE, 4), (HOPPER, 1), (ANT, 1)],
    ids=["bce_sn", "mixup_airl", "bce_sn-kblock4", "mixup_airl-kblock4", "hopper_native",
         "ant_native"],
)
def test_transition_core_matches_iltpu(tmp_path, extra, block):
    """update_block=4 takes iltpu's K-blocked kernel (two launches of 4 per
    iteration) and the port's kblock_update; hopper_native is iltpu's main
    path (hopper's shapes, its expert data, the stepper built by each
    package); ant_native the same on ant (120 discriminator inputs)."""
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
        noise = _iltpu_noise(state, base_key, step, 8, B, A, extra == TUNEDLIKE)
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


def _same_view(got, want):
    return (got.shape == want.shape and got.stride() == want.stride()
            and got.data_ptr() == want.data_ptr() and torch.equal(got, want))


@pytest.mark.parametrize("extra", [(), TUNEDLIKE], ids=["bce_sn", "mixup_airl"])
def test_run_updates_hands_each_update_its_views_through_the_instance(tmp_path, extra,
                                                                    monkeypatch):
    """What the benchmark's harness rests on: `run_updates` calls
    `trainer.update` through the instance, once an update and in order, so
    an instance-level override sees every update until it deletes itself;
    each call gets dicts of `v[c]` of the iteration's batches, expert
    batches and draws (same values, shapes, strides and storage); and the
    state after the iteration is bit-identical to per-update `v[c]` calls
    of the class's `update` on a twin trainer. Chunks of 4 views, so the
    iteration's 6 updates take two."""
    import iltpu_torch.trainer as trainer_mod
    from iltpu_torch.utils.spans import Recorder

    monkeypatch.setattr(trainer_mod, "VIEW_CHUNK", 4)
    args = BASE + list(extra) + ["platform=cpu"]
    tt = Trainer(load_config(args), out_dir=str(tmp_path / "a"))
    twin = Trainer(load_config(args), out_dir=str(tmp_path / "b"))
    convert.load_sac_tree_(twin.sac, convert.sac_tree(tt.sac))
    convert.load_disc_tree_(twin.disc_state, convert.disc_tree(tt.disc_state))
    data = _step_data(jax.random.key(5), 4, tt.env.obs_size, tt.action_size)
    t = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    n = 6
    _, batches, expert_batches, draws = tt.front(
        0, t["obs"], t["actions"], t["rewards"], t["next_obs"], t["terminals"], t["timeouts"], n)
    seen = []

    def hook(step, tb, eb, nz):
        seen.append((tb, eb, nz))
        if len(seen) == 3:
            del tt.update  # as the harness does: the class's own method from here on
        return Trainer.update(tt, step, tb, eb, nz)

    tt.update = hook
    tt.spans = Recorder()
    tt.run_updates(0, batches, expert_batches, draws, n)
    assert len(seen) == 3 and "update" not in vars(tt)
    for c, got in enumerate(seen):
        for d, want in zip(got, (batches, expert_batches, draws)):
            assert list(d) == list(want) and type(d) is dict
            assert all(_same_view(d[k], v[c]) for k, v in want.items()), (c, list(want))
    assert [a for name, _, _, _, _, a in tt.spans.spans if name == "update"] == [1] * n
    with torch.no_grad():
        for c in range(n):
            Trainer.update(twin, 0, *({k: v[c].clone() for k, v in d.items()}
                                      for d in (batches, expert_batches, draws)))
    got, want = tt.state_tensors(), twin.state_tensors()
    for k in ("sac.", "disc."):
        keys = [name for name in want if name.startswith(k)]
        assert keys and all(torch.equal(got[name], want[name]) for name in keys), k


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
    "pwil": ["algorithm=PWIL", "training.sac_pallas=true"],
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
        if tt.algorithm == "PWIL":  # the pools exactly, the stored rewards in the ring
            np.testing.assert_array_equal(convert.pwil_pools(tt.disc_state),
                                          np.asarray(state["disc"].expert_weights), err_msg=what)
            np.testing.assert_allclose(tt.replay.rows("rewards").numpy(),
                                       np.asarray(state["replay"].rewards), err_msg=what, **tol)
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
    for name in ("agent", "discriminator", "metrics.pkl", "config.yaml"):
        assert os.path.exists(os.path.join(summary["out_dir"], name))


CLI_ALGORITHMS = {
    "SAC": ([], "no discriminator"),
    "BC": (["bc_pretraining.iterations=20"], "no discriminator"),
    "SQIL": (["training.sac_pallas=true"], "no discriminator"),
    "DRIL": (["imitation.pretraining.iterations=20", "training.sac_pallas=true"], "discriminator"),
    "RED": (["imitation.pretraining.iterations=20"], "discriminator"),
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
    for name in ("agent", "metrics.pkl", "config.yaml"):
        assert os.path.exists(os.path.join(out, name))
    assert os.path.exists(os.path.join(out, "discriminator")) == (disc == "discriminator")
    with open(os.path.join(out, "metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    if alg == "BC":
        assert metrics["test_steps"] == [0] and "pre_training_time" in metrics
        assert metrics["update_steps"] == []
    else:
        assert metrics["update_steps"] and np.isfinite(metrics["alphas"]).all()


def test_port_imports_neither_jax_nor_iltpu(tmp_path):
    """Every module of the port (train_all, sweep, analysis, parallel and its
    tensor-parallel layout named too), a plain CLI run, a hopper run on the
    C++ stepper (which imports neither MuJoCo's bindings nor gymnasium
    either) and the render script on its agent (the rollout ray cast and
    written as a GIF without PIL), a data-parallel one
    (a one-rank gloo group) and one under parallel.shard_params, a two-job
    `-m` run, and a pipelined run that checkpoints,
    resumed: beside an `agent_best/` that holds only iltpu's header.pkl (a
    pickled JAX treedef, never opened), and D4RL's HDF5 fixture read, neither
    JAX, iltpu, PyYAML, h5py, matplotlib nor PIL is imported."""
    best = tmp_path / "resume" / "agent_best"
    best.mkdir(parents=True)
    (best / "header.pkl").write_bytes(b"not a pickle the port may open")
    first = CLI + ["platform=cpu", f"output_dir={tmp_path / 'first'}", "training.pipeline=true",
                   "checkpointing.interval=100"]
    code = f"""
import glob, importlib, pkgutil, sys
import iltpu_torch
for m in pkgutil.walk_packages(iltpu_torch.__path__, "iltpu_torch."):
    importlib.import_module(m.name)
import iltpu_torch.analysis, iltpu_torch.parallel, iltpu_torch.parallel.tensor, iltpu_torch.sweep
import iltpu_torch.train_all
from iltpu_torch.train import main
from iltpu_torch.trainer import Trainer
from iltpu_torch.config import load_config
main({CLI + ['platform=cpu', f'output_dir={tmp_path}']!r})
main({[a for a in CLI if not a.startswith("env")] + HOPPER + ['platform=cpu',
                                                             f'output_dir={tmp_path / "hop"}']!r})
import torch
torch.set_num_threads(1)  # the frames' ray cast, beside the suite's other workers
hop = glob.glob({str(tmp_path / 'hop')!r} + "/*/*/")[0]
from iltpu_torch.render_rollout import main as render_main
render_main(["--env", "hopper", "--agent", hop + "agent", "--out", hop + "roll", "--max-frames", "3",
             "--hidden-size", "16", "--platform", "cpu"])
assert glob.glob(hop + "roll.npz") and glob.glob(hop + "roll.gif")
main({CLI + ['platform=cpu', 'training.fused_update_scan=false', 'training.sac_pallas=false',
             'training.disc_pallas=false', 'parallel.data_axis=data',
             f'output_dir={tmp_path / "dp"}']!r})
assert iltpu_torch.parallel.allreduce_mean_.launches > 0
main({CLI + ['platform=cpu', 'training.fused_update_scan=false', 'parallel.data_axis=data',
             'parallel.shard_params=true', f'output_dir={tmp_path / "tp"}']!r})
assert iltpu_torch.parallel.tensor.allgather_blocks.launches > 0
scores = main({['-m', 'seed=1,2'] + CLI + ['platform=cpu', f'output_dir={tmp_path / "multi"}']!r})
assert len(scores) == 2 and len(glob.glob({str(tmp_path / 'multi')!r} + "/multirun/*/?/config.yaml")) == 2
main({first!r})
ckpt = glob.glob({str(tmp_path / 'first')!r} + "/*/*/checkpoint")[0]
t = Trainer(load_config({CLI + ['platform=cpu', 'steps=300', 'training.pipeline=true']!r}
                        + ["checkpointing.resume=" + ckpt]), out_dir={str(tmp_path / 'resume')!r})
assert t.start_step == 200, t.start_step
t.run()
from iltpu_torch.data import load_d4rl_hdf5
assert len(load_d4rl_hdf5({hopper_hdf5()!r})["observations"]) == 19378
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "iltpu", "yaml", "mujoco", "gymnasium",
                                    "h5py", "matplotlib", "PIL"))
assert not bad, bad
print("clean")
"""
    r = _run(code, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("clean")
    assert (best / "header_torch.pkl").exists()


def test_gpu_entry_point_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["platform=gpu"]):
        for args in (BASE, BASE + HOPPER):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                Trainer(load_config(args + platform), out_dir=str(tmp_path))


# an HDF5 file that is not there (relative: no tmp_path in a parametrisation)
MISSING_HDF5 = "expert_data.source=hdf5 expert_data.path=no/such/d4rl.hdf5"


@pytest.mark.parametrize("override,error,match", [
    (MISSING_HDF5, FileNotFoundError, "d4rl.hdf5"),
    ("imitation.discriminator.reward_shaping=true", ValueError, "training.disc_pallas=true supports"),
    ("imitation.state_only=true", ValueError, "training.disc_pallas=true supports"),
    # renders now; the case keeps its id
    pytest.param("render=true env=hopper env_backend=native", None, None,
                 id="render=true env=hopper env_backend=native-NotImplementedError-ROADMAP.md, 'Render'"),
    ("reinforcement.critic.depth=3", ValueError, "training.sac_pallas=true requires"),
    ("imitation.loss_function=PUGAIL", ValueError, "training.disc_pallas=true supports"),
])
def test_refuses_pwil_gail_options_and_kernel_shapes(tmp_path, override, error, match):
    """Rendering a MuJoCo env is ported: the trainer renders its greedy
    rollout into rollout.npz and rollout.gif; D4RL's hdf5 expert data is,
    and an HDF5 file that is not there raises FileNotFoundError in both
    packages (iltpu's through h5py); the kernel flags refuse what iltpu
    refuses (the GAIL input options on the GAIL kernel among them), with its
    ValueError."""
    base = BASE if error is ValueError else COMMON + ["algorithm=GAIL"]
    args = base + TUNEDLIKE[:1] + override.split() + ["platform=cpu"]
    if error is None:
        from test_torch_render import rollout_files

        t = Trainer(load_config(args), out_dir=str(tmp_path))
        t._render()
        t.env.close()
        assert rollout_files(t.out_dir, t.prefix) >= 1
        return
    with pytest.raises(error, match=match):
        Trainer(load_config(args), out_dir=str(tmp_path))
    with pytest.raises(error):
        JaxTrainer(jax_load_config(args[:-1]), out_dir=str(tmp_path / "jax"))


def _pair(tmp_path, args):
    """iltpu's trainer and the port's on `args`, the port's SAC and GAIL
    state copied from iltpu's."""
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    convert.load_sac_tree_(tt.sac, jax_sac_tree(jt.state["sac"]))
    if tt.algorithm == "GAIL":
        convert.load_disc_tree_(tt.disc_state, jax_disc_tree(jt.state["disc"], jt.state["disc_opt"]))
    return jt, tt


def test_host_loop_on_hopper_matches_iltpu(tmp_path):
    """Three host-loop iterations on the stepper from given actions: iltpu's
    env step, packed block and `_post_step` (8 updates each) against the
    port's `act_env` with the same numpy actions (host acting's way in: no
    device actions) and its front and updates with iltpu's draws. The ring's
    rows are bit-equal, the block's columns are iltpu's packing, the state
    within 1e-4 / 1e-5."""
    jt, tt = _pair(tmp_path, BASE + HOPPER)
    state, N, B = jt.state, 4, 16
    S, A = jt.env.obs_size, jt.env.action_size
    obs = jt.env.reset(jt.cfg.seed)
    env_state = tt._reset_env()
    np.testing.assert_array_equal(env_state["obs"].numpy(), obs)
    rng = np.random.default_rng(6)
    tol = dict(rtol=1e-4, atol=1e-5)
    for it in range(3):
        step, base_key = it * N, jax.random.key(21 + it)
        actions = rng.uniform(-1, 1, (N, A)).astype(np.float32)
        next_obs, rewards, terminals, timeouts, obs_after = jt.env.step(actions)
        packed = np.concatenate([obs, actions, rewards[:, None], next_obs, terminals[:, None],
                                 timeouts[:, None], obs_after, np.full((N, 1), float(step))],
                                axis=1).astype(np.float32)
        state, aux, _ = jt._post_step(state, base_key, jnp.asarray(packed), n_updates=8)
        acted = tt.act_env(env_state, actions)
        out = acted[2]
        got = np.concatenate([acted[0], acted[1], out["reward"][:, None], out["next_obs"],
                              out["terminal"][:, None], out["timeout"][:, None],
                              env_state["obs"]], axis=1)
        np.testing.assert_array_equal(got, packed[:, :-1], err_msg=f"iteration {it} block")
        noise = _iltpu_noise(state, base_key, step, 8, B, A, False)
        taux = tt._updates_of(step, tt.front(step, acted[0], acted[1], out["reward"],
                                             out["next_obs"], out["terminal"], out["timeout"], 8,
                                             noise), 8)
        for col in ("step", "states", "actions", "rewards", "next_states", "terminals", "timeouts",
                    "weights"):
            np.testing.assert_array_equal(tt.replay.rows(col).numpy(),
                                          np.asarray(getattr(state["replay"], col)), err_msg=col)
        what = f"iteration {it}"
        assert_trees_close(convert.sac_tree(tt.sac), jax_sac_tree(state["sac"]), what=what, **tol)
        for k, v in aux.items():
            np.testing.assert_allclose(taux[k].numpy(), np.asarray(v), err_msg=f"{what} {k}", **tol)
        obs = obs_after


@pytest.mark.parametrize("on_host", ["true", "false"])
def test_evaluate_on_hopper_matches_iltpu(tmp_path, on_host):
    """`Trainer.evaluate` on the stepper from iltpu's actor parameters: the
    returns of iltpu's `evaluate` (`evaluate_policy` on its stepper, seeded
    seed + 7919), through the numpy actor or the device forward."""
    args = [a for a in COMMON if not a.startswith("evaluation.episodes")] + HOPPER + [
        "algorithm=SAC", "evaluation.episodes=3", f"evaluation.on_host={on_host}"]
    jt, tt = _pair(tmp_path, args)
    got, want = tt.evaluate(), jt.evaluate()
    assert len(got) == 3 and np.all(np.asarray(want) != 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cli_hopper_native_on_cpu(tmp_path):
    """iltpu's main path through the CLI at a small size on the stepper:
    iltpu's outputs, the D4RL-normalised scores of hopper and, with
    save_trajectories, gymnasium's greedy episodes."""
    args = [a for a in CLI if a != "env=pointmass" and not a.startswith("env_backend")] + HOPPER + [
        "training.pipeline=true", "save_trajectories=true", "platform=cpu",
        f"output_dir={tmp_path}"]
    r = subprocess.run(
        [sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    out = summary["out_dir"]
    for name in ("agent", "agent_best", "discriminator", "metrics.pkl", "config.yaml",
                 "trajectories.pkl"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    returns = np.asarray(metrics["test_returns"][-1])
    norm = (returns - -20.272305) / (3234.3 - -20.272305)
    np.testing.assert_allclose(metrics["test_returns_normalized"][-1], norm)
    assert summary["mean_normalized_score"] == pytest.approx(float(np.mean(norm)))
    assert metrics["train_returns"] and metrics["update_steps"] == []  # logging.interval=0
    with open(os.path.join(out, "trajectories.pkl"), "rb") as f:
        trajectories = pickle.load(f)
    assert len(trajectories) == 2 and trajectories[0]["states"].shape[1] == 12


@pytest.mark.parametrize("acting", ["on_device_loop", "host_acting"])
def test_mujoco_env_takes_the_host_loop(tmp_path, monkeypatch, acting):
    """training.on_device_loop=true on the stepper runs the host loop, as
    iltpu does (a MuJoCo step cannot be captured), and host acting samples
    from the env's numpy observations, never reading them from the device."""
    monkeypatch.setattr(Trainer, "_device_loop", lambda self: pytest.fail("the on-device loop ran"))
    args = [a for a in COMMON if not a.startswith("steps")] + HOPPER + [
        "algorithm=GAIL", "steps=120", f"training.{acting}=true", "platform=cpu"]
    t = Trainer(load_config(args), out_dir=str(tmp_path))
    starts = []
    real = t._reads

    def spy(reads, out, env_state=None):
        starts.append("host" in out)
        return real(reads, out, env_state)

    t._reads = spy
    t.run()
    assert t.step_done == 120 and t.updates_done == 120 - 64 + 1
    assert starts and all(starts)


@pytest.mark.parametrize("layout", ["data_axis", "shard_params"])
def test_data_parallel_on_hopper_matches_one_process(tmp_path, layout):
    """Two gloo ranks on the stepper (each steps the same envs from the same
    seed), data parallel and under the tensor-parallel layout, with host
    acting: the one-process run's score within 1e-4 / 1e-5."""
    args = [a for a in CLI if not a.startswith("env")] + HOPPER + [
        "training.fused_update_scan=false", "training.host_acting=true", "platform=cpu"]
    extra = ["parallel.data_axis=data", "parallel.num_devices=2"]
    if layout == "shard_params":
        extra.append("parallel.shard_params=true")
    scores = []
    for i, more in enumerate(([], extra)):
        r = subprocess.run(
            [sys.executable, "-m", "iltpu_torch.train", *args, *more, f"output_dir={tmp_path / str(i)}"],
            cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        scores.append(json.loads(r.stdout.strip().splitlines()[-1])["mean_normalized_score"])
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-4, atol=1e-5)


EXPERT_FILES = ["ant_expert", "ant_expert_v2", "halfcheetah_expert", "hopper_expert",
                "hopper_expert_v2", "walker2d_expert", "walker2d_expert_v2"]


@pytest.mark.parametrize("name", EXPERT_FILES)
def test_expert_data_at_each_env_width(tmp_path, name):
    """Each committed expert file through the port's and iltpu's trainers on
    its env's stepper (ant's 111 observations + the absorbing bit among
    them; the files that are not v2 with expert_data.terminals_to_timeouts):
    the expert buffers equal, row for row."""
    env = name.split("_expert")[0]
    args = [a for a in COMMON if not a.startswith(("env", "imitation.trajectories"))] + [
        "algorithm=SAC", f"env={env}", "env_backend=native", "imitation.trajectories=0",
        f"expert_data.source={os.path.join(REPO, 'data', name + '.npz')}",
        f"expert_data.terminals_to_timeouts={str('v2' not in name).lower()}"]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    width = {"ant": 112, "halfcheetah": 18, "hopper": 12, "walker2d": 18}[env]
    assert tt.state_size == jt.state_size == width
    expert = jt.state["expert"]
    for col in ("states", "actions", "rewards", "next_states", "terminals", "timeouts", "weights"):
        np.testing.assert_array_equal(tt.expert.rows(col).numpy(), np.asarray(getattr(expert, col)),
                                      err_msg=col)
    assert int(tt.expert.num_trajectories) == int(expert.num_trajectories)
    if "v2" not in name:  # every end a timeout: no absorbing rows
        assert not tt.expert.rows("terminals").any()


def test_d4rl_hdf5_fixture_matches_iltpu_and_the_npz():
    """data/d4rl/hopper_expert.hdf5 through the port's reader equals iltpu's
    h5py read exactly, and its values equal data/hopper_expert.npz's (the
    flags bool there, float32 in the npz; the floats bit-equal)."""
    pytest.importorskip("h5py")
    from iltpu.data.dataset import load_d4rl_hdf5 as jax_load
    from iltpu_torch.data import load_d4rl_hdf5
    from iltpu_torch.data.hdf5 import read_datasets

    path = hopper_hdf5()
    port, ref = load_d4rl_hdf5(path), jax_load(path)
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
        assert np.array_equal(port[k], ref[k]), k
    with np.load(os.path.join(REPO, "data", "hopper_expert.npz")) as npz:
        port.update(read_datasets(path, ["rewards"]))
        assert sorted(port) == sorted(npz.files)
        for k in npz.files:
            assert port[k].dtype == (bool if k in ("terminals", "timeouts") else np.float32), k
            if port[k].dtype == bool:
                np.testing.assert_array_equal(port[k], npz[k].astype(bool), err_msg=k)
                np.testing.assert_array_equal(port[k].astype(np.float32), npz[k], err_msg=k)
            else:
                assert port[k].tobytes() == npz[k].tobytes(), k


@pytest.mark.parametrize("to_timeouts", [True, False], ids=["terminals_to_timeouts", "as_stored"])
def test_expert_data_from_hdf5_matches_iltpu(tmp_path, to_timeouts):
    """expert_data.source=hdf5 on hopper's stepper: the port's and iltpu's
    trainers build equal expert buffers, column for column, and the port's
    equals its own buffer from the npz (build_expert_transitions casts the
    bool flags to float32)."""
    pytest.importorskip("h5py")
    args = [a for a in COMMON if not a.startswith(("env", "imitation.trajectories"))] + [
        "algorithm=SAC", "env=hopper", "env_backend=native", "imitation.trajectories=0",
        f"expert_data.terminals_to_timeouts={str(to_timeouts).lower()}"]
    hdf5 = ["expert_data.source=hdf5", f"expert_data.path={hopper_hdf5()}"]
    npz = [f"expert_data.source={os.path.join(REPO, 'data', 'hopper_expert.npz')}"]
    jt = JaxTrainer(jax_load_config(args + hdf5), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + hdf5 + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    tn = Trainer(load_config(args + npz + ["platform=cpu"]), out_dir=str(tmp_path / "npz"))
    expert = jt.state["expert"]
    for col in ("states", "actions", "rewards", "next_states", "terminals", "timeouts", "weights"):
        np.testing.assert_array_equal(tt.expert.rows(col).numpy(), np.asarray(getattr(expert, col)),
                                      err_msg=col)
        assert tt.expert.rows(col).numpy().tobytes() == tn.expert.rows(col).numpy().tobytes(), col
    assert int(tt.expert.num_trajectories) == int(expert.num_trajectories) == \
        int(tn.expert.num_trajectories)
