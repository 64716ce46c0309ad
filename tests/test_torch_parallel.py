"""Data parallel in the port (`iltpu_torch.parallel`, `parallel.data_axis`),
and the tensor-parallel layout (`parallel.shard_params`) over it, against
iltpu's mesh and against the port's own one-process run.

The ranks are jax-free processes (tests/torch_parallel_worker.py) in a gloo
group on the CPU, started twice for the module: one group of 2 ranks and
one of 4, each running every case of its world. The test process computes
the references: iltpu's `_transition_core` on the 8-device virtual mesh
(tests/conftest.py) for GAIL on the autograd path, AdRIL on the SAC kernel
and PWIL, with iltpu's draws handed across (`_iltpu_noise`), and the port's
one-process runs. Tolerance: the chain tolerance, rtol 1e-4 / atol 1e-5.
Under the layout the numbers must equal the same world's data-parallel run
bit for bit."""

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

import torch_parallel_worker as W
from iltpu.config import load_config as jax_load_config
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.parallel import DataMesh, param_shardings
from iltpu_torch.parallel.tensor import port_name
from iltpu_torch.trainer import Trainer
from iltpu_torch.utils.checkpoint import flatten
from iltpu_torch.updates import adversarial
from test_torch_convert import assert_trees_close, jax_disc_tree, jax_sac_tree
from test_torch_trainer import _iltpu_noise, _step_data

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
JOIN_SECONDS = 300


def spawn_ranks(root, world, jobs):
    """Run the worker's `world` ranks on `jobs`; each rank is waited for at
    most JOIN_SECONDS, a hung one is killed and fails the module."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=W.REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, root, str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=JOIN_SECONDS)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} done" in out, f"rank {r} of {world}:\n{out[-4000:]}"
    return root


def result(root, job, rank=0):
    with np.load(os.path.join(root, f"{job}.rank{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def iteration(flat, it, what):
    pre = f"it{it}/{what}/"
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


def assert_flat_close(got, want, what):
    assert sorted(got) == sorted(want), f"{what}: keys differ"
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   err_msg=f"{what} {k}", **TOL)


# ------------------------------------------------------------ references


def iltpu_reference(name, root, shard=False):
    """iltpu's _transition_core on the 8-device mesh (with `shard`, under
    its parallel.shard_params layout), 3 iterations x 8 updates at batch
    16, from iltpu's initial state; the port trainer's inputs (that state
    in its layout, the env steps, iltpu's draws; the same with `shard`) to
    <name>.inputs.npz. Returns (the port trainer, iltpu's states and aux
    after each iteration)."""
    args = W.COMMON[:-1] + W.ILTPU_CASES[name] + ["parallel.data_axis=data"]
    args += ["parallel.shard_params=true"] if shard else []
    jt = JaxTrainer(jax_load_config(args), out_dir=os.path.join(root, f"{name}.{shard}.jax"))
    assert jt.mesh is not None and jt.mesh.devices.size == 8
    tt = Trainer(load_config(W.COMMON + W.ILTPU_CASES[name]), out_dir=os.path.join(root, f"{name}.torch"))
    state = jt.state
    convert.load_sac_tree_(tt.sac, jax_sac_tree(state["sac"]))
    if tt.algorithm == "GAIL":
        convert.load_disc_tree_(tt.disc_state, jax_disc_tree(state["disc"], state["disc_opt"]))
    inputs = {f"state/{k}": v for k, v in W.state_arrays(tt).items()}
    S, A, n, B = jt.env.obs_size, jt.env.action_size, 4, 16
    core = jax.jit(jt._transition_core, static_argnames=("n_updates",))
    want = []
    for it in range(W.ITERS):
        data = _step_data(jax.random.key(100 + it), n, S, A)
        base_key = jax.random.key(7 + it)
        state, aux = core(state, base_key, jnp.asarray(it * n, jnp.int32), data["obs"],
                          data["actions"], data["rewards"], data["next_obs"], data["terminals"],
                          data["timeouts"], n_updates=W.UPDATES)
        noise = _iltpu_noise(state, base_key, it * n, W.UPDATES, B, A, False)
        if tt.algorithm != "GAIL":
            noise.pop("eps_gp")
        inputs.update({f"it{it}/data/{k}": np.array(v) for k, v in data.items()})
        inputs.update({f"it{it}/noise/{k}": v.numpy() for k, v in noise.items()})
        want.append((jax.tree.map(np.array, state), {k: np.array(v) for k, v in aux.items()}))
    np.savez(os.path.join(root, f"{name}.inputs.npz"), **inputs)
    return tt, want


SHARD_ILTPU = ("gail_autograd", "adril_sac_kernel")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every reference, then the 2-rank and the 4-rank groups."""
    root = str(tmp_path_factory.mktemp("parallel"))
    two, four = os.path.join(root, "world2"), os.path.join(root, "world4")
    os.makedirs(two)
    iltpu = {name: iltpu_reference(name, two) for name in W.ILTPU_CASES}
    iltpu_shard = {name: iltpu_reference(name, two, shard=True)[1] for name in SHARD_ILTPU}
    singles = {name: W.self_trainer(name, os.path.join(root, f"single.{name}"))
               for name in W.SELF_CASES}
    single = {name: W.drive(t, name) for name, t in singles.items()}
    plain = W.self_trainer("gail_autograd", os.path.join(root, "plain_ckpt"))
    W.run_core(plain)
    plain._checkpoint(W.ITERS * plain.cfg.num_envs, W.ITERS * W.UPDATES)
    resumed = W.dryrun(os.path.join(root, "single_dryrun"), 0)
    single_dryrun = {**W.state_arrays(resumed), "start_step": np.asarray(resumed.start_step)}
    jobs = [{"id": "primitives", "kind": "primitives"}]
    jobs += [{"id": f"self_{n}", "kind": "self", "name": n} for n in W.SELF_CASES]
    jobs += [{"id": f"shard_{n}", "kind": "shard", "name": n} for n in W.SHARD_CASES]
    spawn_ranks(two, 2, jobs + [{"id": "multihost", "kind": "multihost"}]
                + [{"id": f"iltpu_{n}", "kind": "iltpu", "name": n} for n in W.ILTPU_CASES]
                + [{"id": f"shard_iltpu_{n}", "kind": "iltpu", "name": n, "shard": True}
                   for n in SHARD_ILTPU]
                + [{"id": "shard_ckpt", "kind": "shard_ckpt",
                    "plain": os.path.join(root, "plain_ckpt", "checkpoint")},
                   {"id": "dryrun", "kind": "dryrun"}])
    spawn_ranks(four, 4, jobs + [{"id": "refusals", "kind": "refusals"},
                                 {"id": "mesh_bound", "kind": "mesh_bound"}])
    return {"root": root, 2: two, 4: four, "iltpu": iltpu, "iltpu_shard": iltpu_shard,
            "single": single, "singles": singles, "plain": W.whole_arrays(plain),
            "single_dryrun": single_dryrun}


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("world", [2, 4])
def test_primitives(runs, world):
    """shard_batch's shapes (a scalar untouched), one collective for three
    tensors (one torch.distributed.all_reduce of their flat buffer), their
    means, allgather_rows in rank order, and a mean-loss
    gradient equal to one process's (test_parallel's problem) at rtol 1e-6."""
    want_grad = W.mean_loss_grad(*W.grad_problem())
    for rank in range(world):
        got = result(runs[world], "primitives", rank)
        assert got["shape/states"].tolist() == [16 // world, 4]
        assert got["shape/rewards"].tolist() == [16 // world]
        assert got["shape/scalar"].tolist() == []
        assert int(got["collectives"]) == 1
        assert got["issued"].tolist() == [[12]]  # one all-reduce of the flat buffer of 6 + 5 + 1
        mean_rank = (world - 1) / 2
        np.testing.assert_allclose(got["mean/0"], np.full((3, 2), mean_rank), rtol=1e-6)
        np.testing.assert_allclose(got["mean/1"], np.full(5, 2 * mean_rank), rtol=1e-6)
        np.testing.assert_array_equal(got["mean/2"], np.ones(()))
        np.testing.assert_array_equal(got["gathered"], np.arange(16.0).reshape(16, 1))
        np.testing.assert_allclose(got["grad"], want_grad, rtol=1e-6)


def test_mesh_spans_every_host(runs):
    """Under NCCL a mesh holds every rank of the group, not this host's
    cards: four ranks on two hosts of two cards each (mocked) make a mesh
    of 4 with num_devices null; a local rank with no card of its own, and
    more devices than ranks (iltpu's AssertionError), are refused."""
    for rank in range(4):
        got = result(runs[4], "mesh_bound", rank)
        assert int(got["null"]) == 4
        assert str(got["past_cards"]) == (
            "ValueError: local rank 2 has no card of its own: this host has 2")
        assert str(got["too_many"]) == "AssertionError: requested 8 devices, have 4"


def test_multihost_two_processes(runs):
    """The counterpart of test_multihost's worker: two processes through
    initialize_multihost all-reduce a sharded mean-loss gradient to 1.5 a
    column; process_allreduce_mean too."""
    for rank in range(2):
        info = result(runs[2], "init", rank)
        assert {k: int(v) for k, v in info.items()} == {
            "process_index": rank, "process_count": 2, "local_devices": 1, "global_devices": 2}
        got = result(runs[2], "multihost", rank)
        np.testing.assert_allclose(got["grad"], np.full((4, 1), 1.5), rtol=1e-6)
        np.testing.assert_allclose(got["scalar_mean"], 1.5)
        np.testing.assert_allclose(got["array_mean"], np.full(3, 1.0))


@pytest.mark.parametrize("name", list(W.ILTPU_CASES))
def test_slice_matches_iltpu_mesh(runs, name):
    """Two ranks' transition_core against iltpu's on its 8-device mesh:
    rank 0's SAC (and GAIL's discriminator) trees, the ring, AdRIL's flip,
    PWIL's pools and the aux, every iteration; rank 1 equals rank 0 bit for
    bit; two all-reduces an update on the autograd SAC path (one more for
    the discriminator step), none on the SAC kernel."""
    tt, want = runs["iltpu"][name]
    assert_matches_iltpu(tt, want, [result(runs[2], f"iltpu_{name}", r) for r in range(2)], name)


def assert_matches_iltpu(tt, want, got, name):
    """`test_slice_matches_iltpu_mesh`'s checks of the ranks' results `got`
    against iltpu's `want`, through the port trainer `tt`."""
    for k in got[0]:
        np.testing.assert_array_equal(got[1][k], got[0][k], err_msg=f"rank 1 {k}")
    per_update = {"gail_autograd": 3, "adril_sac_kernel": 0, "pwil": 2}[name]
    assert int(got[0]["collectives"]) == W.ITERS * W.UPDATES * per_update
    for it, (state, aux) in enumerate(want):
        what = f"{name} iteration {it}"
        W.load_state(tt, iteration(got[0], it, "state"))
        assert_trees_close(convert.sac_tree(tt.sac), jax_sac_tree(state["sac"]), what=what, **TOL)
        if tt.algorithm == "GAIL":
            assert_trees_close(convert.disc_tree(tt.disc_state),
                               jax_disc_tree(state["disc"], state["disc_opt"]), what=what, **TOL)
        for col in ("step", "states", "actions", "next_states", "terminals", "timeouts", "weights"):
            np.testing.assert_array_equal(tt.replay.rows(col).numpy(),
                                          np.asarray(getattr(state["replay"], col)), err_msg=what)
        np.testing.assert_allclose(tt.replay.rows("rewards").numpy(),
                                   np.asarray(state["replay"].rewards), err_msg=what, **TOL)
        assert int(tt.replay.idx) == int(state["replay"].idx)
        if tt.algorithm == "AdRIL":
            assert bool(tt.relabel) == bool(state["relabel"].sample_expert), what
        if tt.algorithm == "PWIL":
            np.testing.assert_array_equal(convert.pwil_pools(tt.disc_state),
                                          np.asarray(state["disc"].expert_weights), err_msg=what)
        taux = iteration(got[0], it, "aux")
        assert sorted(taux) == sorted(aux), what
        for k, v in aux.items():
            np.testing.assert_allclose(taux[k], v, err_msg=f"{what} aux {k}", **TOL)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(W.SELF_CASES))
def test_data_parallel_matches_one_process(runs, name, world):
    """The same transition_core (the trainer's own draws, DRIL and RED
    pretrained replicated first) at 2 and 4 ranks against one process:
    every state tensor and the aux of the whole batch, each iteration; every
    rank equal to rank 0 bit for bit; the all-reduces an update."""
    got = [result(runs[world], f"self_{name}", r) for r in range(world)]
    for r in range(1, world):
        for k in got[0]:
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=f"rank {r} {k}")
    assert int(got[0]["collectives"]) == W.ITERS * W.UPDATES * W.SELF_CASES[name][1]
    want = runs["single"][name]
    for it in range(W.ITERS):
        for what in ("state", "aux"):
            assert_flat_close(iteration(got[0], it, what), iteration(want, it, what),
                              f"{name} at {world} ranks, iteration {it} {what}")


def test_pugail_clamp_binds_on_the_whole_batch(runs, monkeypatch):
    """The nn-PUGAIL case exercises the clamp: with margin 0 the policy
    term's value is below the margin in some of the one-process run's
    updates and not in others, so the 2- and 4-rank matches above cover
    both branches."""
    t = W.self_trainer("pugail", os.path.join(runs["root"], "pugail_probe"))
    clamped, clamp_min = [], adversarial._clamp_min

    def spy(x, value, lo):
        clamped.append(bool(value < lo))
        return clamp_min(x, value, lo)

    monkeypatch.setattr(adversarial, "_clamp_min", spy)
    W.run_core(t)
    assert len(clamped) == W.ITERS * W.UPDATES and any(clamped) and not all(clamped), clamped


def test_dryrun_gail_two_ranks_checkpoint_resume(runs):
    """__graft_entry__'s dryrun GAIL at 2 ranks (on-device loop, an
    evaluation, a checkpoint at 64 steps, a resume to 128): the resumed
    state equals one process's, only rank 0 wrote files, metrics.pkl
    equals the one-process run's, and rank 1's metrics equal rank 0's."""
    got, want = result(runs[2], "dryrun", 0), runs["single_dryrun"]
    assert int(got["start_step"]) == int(want["start_step"]) > 0  # the first chunk end past 64
    assert_flat_close(got, want, "dryrun resumed state")
    dry, single = os.path.join(runs[2], "dryrun"), os.path.join(runs["root"], "single_dryrun", "rank0")
    assert not os.path.exists(os.path.join(dry, "rank1"))
    for d in ("first", "resumed"):
        assert sorted(os.listdir(os.path.join(dry, "rank0", d))) == sorted(
            os.listdir(os.path.join(single, d)))
    with open(os.path.join(dry, "rank0", "resumed", "metrics.pkl"), "rb") as f:
        metrics = pickle.load(f)
    with open(os.path.join(single, "resumed", "metrics.pkl"), "rb") as f:
        want = pickle.load(f)
    assert sorted(metrics) == sorted(want) and len(metrics["test_steps"]) >= 2
    for k, v in want.items():
        if k.endswith("steps"):
            assert metrics[k] == v, k
        else:
            assert len(metrics[k]) == len(v), k
            for a, b in zip(metrics[k], v):
                np.testing.assert_allclose(a, b, err_msg=k, **TOL)
    ranks = []
    for r in range(2):
        with open(os.path.join(runs[2], f"dryrun.metrics.rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    assert ranks[0] == ranks[1]


def test_refusals(runs, tmp_path):
    """batch_size=30 at 4 ranks fails iltpu's AssertionError (as iltpu's
    does on its mesh, tests/test_parallel.py); GAIL with
    parallel.shard_params builds at 4 ranks, its actor's weights among the
    sharded leaves; fused_update_scan keeps iltpu's ValueError."""
    for rank in range(4):
        got = result(runs[4], "refusals", rank)
        msg = str(got["assertion"])
        assert msg == "batch_size 30 must divide the 4-device data mesh", msg
        assert {"sac.a[0]", "sac.a[2]", "disc.p[0]"} <= set(got["shard_leaves"].tolist())
    dp = ["parallel.data_axis=data", "platform=cpu"]
    fused = ["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true",
             "training.fused_update_scan=true"]
    with pytest.raises(ValueError, match="single-device"):
        Trainer(load_config(W.COMMON + fused + dp), out_dir=str(tmp_path))


def test_cli_spawns_its_ranks(tmp_path):
    """`python -m iltpu_torch.train parallel.data_axis=data
    parallel.num_devices=2 platform=cpu ...` starts two ranks itself: one
    JSON line, one run directory with iltpu's outputs."""
    args = [a for a in W.COMMON if not a.startswith(("steps", "reinforcement"))] + [
        "algorithm=GAIL", "steps=200", "evaluation.episodes=2", "check_time_usage=true",
        "logging.interval=40", "reinforcement.actor.hidden_size=16",
        "reinforcement.critic.hidden_size=16", "parallel.data_axis=data", "parallel.num_devices=2",
        f"output_dir={tmp_path}"]
    r = subprocess.run([sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=W.REPO, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=JOIN_SECONDS)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["mean_normalized_score"]), r.stdout
    runs_made = os.listdir(os.path.join(tmp_path, "GAIL_pointmass"))
    assert [os.path.join(tmp_path, "GAIL_pointmass", d) for d in runs_made] == [lines[0]["out_dir"]]
    for name in ("agent", "discriminator", "agent_best", "metrics.pkl", "config.yaml"):
        assert os.path.exists(os.path.join(lines[0]["out_dir"], name))


# ------------------------------------------ the tensor-parallel layout


def front_gathers(names, per_iteration=True):
    """The gathers a front makes: the sampled rows of the sharded ring
    columns (one), and PWIL's pools where they are sharded."""
    rows = int(per_iteration and any(n.startswith("replay.") for n in names))
    return rows + int("disc.expert_weights[0]" in names)


def expected_gathers(name, names):
    """The all-gathers of a SHARD case's chain: an update unit's one, a
    front's (`front_gathers`), and on the on-device loop an act's one."""
    if name == "device_loop":  # 4 iterations without updates, then ITERS x 2 iterations
        return (4 * (1 + front_gathers(names, False))
                + W.ITERS * 2 * (1 + front_gathers(names) + W.UPDATES // 2))
    units = W.UPDATES // (4 if name == "kblock4" else 1)
    return W.ITERS * (front_gathers(names) + units)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(W.SHARD_CASES))
def test_shard_params_matches_data_parallel(runs, name, world):
    """Under parallel.shard_params every iteration's whole state (the
    leaves gathered) and aux equal the same world's data-parallel run bit
    for bit, and one process's within the chain tolerance; every rank's
    whole state equals rank 0's; the all-reduces are data parallel's, and
    the all-gathers one an update unit plus the fronts' and acts'."""
    got = [result(runs[world], f"shard_{name}", r) for r in range(world)]
    want = result(runs[world], f"self_{name}")
    chain = [k for k in want if k.startswith("it")]
    for r in range(world):
        for k in chain:
            np.testing.assert_array_equal(got[r][k], want[k], err_msg=f"rank {r} {k}")
    assert int(got[0]["collectives"]) == int(want["collectives"])
    names = got[0]["layout/names"].tolist()
    assert int(got[0]["gathers"]) == expected_gathers(name, names), names
    for it in range(W.ITERS):
        for what in ("state", "aux"):
            assert_flat_close(iteration(got[0], it, what), iteration(runs["single"][name], it, what),
                              f"{name} at {world} ranks under the layout, iteration {it} {what}")


def expected_layout(t, world, rank=0):
    """{port name: this rank's columns} by iltpu's rule on the one-process
    trainer `t`'s train_state_tree."""
    tree = convert.train_state_tree(t)
    specs, paths = flatten(param_shardings(DataMesh(None, rank, world, "data", None), tree))
    return {port_name(p, t.disc): c for p, c in zip(paths, specs) if c is not None}


@pytest.mark.parametrize("world", [2, 4])
def test_state_of_record(runs, world):
    """Each rank's state of record after the chain: exactly the leaves
    iltpu's rule shards (on the one-process trainer's state) hold the
    rank's column block, equal to that block of the rank's whole tensor
    bit for bit and of one process's within the chain tolerance, and
    concatenating to the whole across the ranks; every other tensor is
    whole; the expert ring's sharded columns hold their blocks; the
    parameters' whole tensors hold no storage between works."""
    last = f"it{W.ITERS - 1}/state/"
    for name in W.SHARD_CASES:
        t = runs["singles"][name]
        single = iteration(runs["single"][name], W.ITERS - 1, "state")
        got = [result(runs[world], f"shard_{name}", r) for r in range(world)]
        for r, g in enumerate(got):
            assert int(g["released"]) == 0, name
            layout = expected_layout(t, world, r)
            names = g["layout/names"].tolist()
            assert names == sorted(layout), (name, names)
            cols = dict(zip(names, (slice(a, b) for a, b in g["layout/cols"].tolist())))
            assert cols == layout, name
            for k, v in single.items():
                rec, whole = g[f"record/{k}"], g[last + k]
                if k in cols:
                    assert rec.shape == whole.shape[:-1] + (whole.shape[-1] // world,), (name, k)
                    np.testing.assert_array_equal(rec, whole[..., cols[k]], err_msg=f"{name} {k}")
                    np.testing.assert_allclose(rec, v[..., cols[k]], err_msg=f"{name} {k}", **TOL)
                else:
                    np.testing.assert_array_equal(rec, whole, err_msg=f"{name} {k}")
            for col in W.COLUMNS:
                k = f"expert.{col}[0]"
                want = getattr(t.expert, col).numpy()
                np.testing.assert_array_equal(g[f"expert/{col}"], want[..., cols[k]] if k in cols else want)
        for k in got[0]["layout/names"].tolist():
            if k.startswith("expert."):
                continue
            np.testing.assert_array_equal(
                np.concatenate([g[f"record/{k}"] for g in got], -1), got[0][last + k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_greedy_matches_replicated(runs, world):
    """The port of iltpu's test_param_shardings_shard_weight_last_axis: the
    sharded actor's greedy forward (its weights gathered) equals a
    replicated actor's with the same parameters, on every rank."""
    obs = torch.from_numpy(np.random.default_rng(5).normal(size=(6, 5)).astype(np.float32))
    t = runs["singles"]["gail_kernels"]
    for r in range(world):
        got = result(runs[world], "shard_gail_kernels", r)
        W.load_state(t, iteration(got, W.ITERS - 1, "state"))
        np.testing.assert_array_equal(got["greedy"], t.actor.greedy_action(obs).detach().numpy())


@pytest.mark.parametrize("name", SHARD_ILTPU)
def test_shard_params_matches_iltpu_mesh(runs, name):
    """Two ranks under the layout against iltpu's transition_core with
    parallel.shard_params on its 8-device mesh (the checks of
    test_slice_matches_iltpu_mesh), and against the same two ranks' data
    parallel bit for bit."""
    tt, _ = runs["iltpu"][name]
    got = [result(runs[2], f"shard_iltpu_{name}", r) for r in range(2)]
    plain = result(runs[2], f"iltpu_{name}")
    for k, v in plain.items():
        if k != "gathers":
            np.testing.assert_array_equal(got[0][k], v, err_msg=k)
    chain = [{k: v for k, v in g.items() if not k.startswith(("layout/", "expert/", "gathers"))}
             for g in got]
    assert_matches_iltpu(tt, runs["iltpu_shard"][name], chain, name)


@pytest.mark.parametrize("direction", ["sharded_to_plain", "plain_to_sharded"])
def test_checkpoints_across_layouts(runs, tmp_path, direction):
    """A checkpoint written by two ranks under the layout (rank 0 gathers
    and writes) resumes in one process without it, and one written by one
    process resumes under the layout at two ranks (each keeps its blocks),
    with equal state."""
    got = result(runs[2], "shard_ckpt", 0)
    part = lambda pre: {k[len(pre):]: v for k, v in got.items() if k.startswith(pre)}
    if direction == "sharded_to_plain":
        ckpt = os.path.join(runs[2], "ckpt.rank0", "written", "checkpoint")
        t = Trainer(load_config(W.COMMON + W.SELF_CASES["gail_autograd"][0]
                                + [f"checkpointing.resume={ckpt}"]), out_dir=str(tmp_path))
        assert_flat_equal(W.state_arrays(t), part("written/"), direction)
        return
    assert_flat_equal(part("resumed/"), runs["plain"], direction)
    names = got["layout/names"].tolist()
    assert names, "nothing sharded"
    cols = dict(zip(names, (slice(a, b) for a, b in got["layout/cols"].tolist())))
    record = part("resumed_record/")
    for k, v in runs["plain"].items():
        np.testing.assert_array_equal(record[k], v[..., cols[k]] if k in cols else v, err_msg=k)


def assert_flat_equal(got, want, what):
    assert sorted(got) == sorted(want), f"{what}: keys differ"
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def test_cli_shard_params_two_ranks(tmp_path):
    """The port of iltpu's test_trainer_shard_params_update_runs: `python -m
    iltpu_torch.train parallel.data_axis=data parallel.shard_params=true
    parallel.num_devices=2 platform=cpu ...` (GAIL on pointmass) gives one
    JSON line with a finite score and one run directory with iltpu's
    outputs."""
    args = [a for a in W.COMMON if not a.startswith(("steps", "reinforcement"))] + [
        "algorithm=GAIL", "steps=200", "training.start=100", "training.batch_size=32",
        "evaluation.interval=150", "evaluation.episodes=2", "logging.interval=50",
        "reinforcement.actor.hidden_size=16", "reinforcement.critic.hidden_size=16",
        "parallel.data_axis=data", "parallel.shard_params=true", "parallel.num_devices=2",
        f"output_dir={tmp_path}"]
    r = subprocess.run([sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=W.REPO, OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=JOIN_SECONDS)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1 and np.isfinite(lines[0]["mean_normalized_score"]), r.stdout
    runs_made = os.listdir(os.path.join(tmp_path, "GAIL_pointmass"))
    assert [os.path.join(tmp_path, "GAIL_pointmass", d) for d in runs_made] == [lines[0]["out_dir"]]
    for name in ("agent", "discriminator", "agent_best", "metrics.pkl", "config.yaml"):
        assert os.path.exists(os.path.join(lines[0]["out_dir"], name))
