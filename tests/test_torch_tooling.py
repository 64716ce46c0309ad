"""The port's run tooling against iltpu's, on the CPU: the Bayesian sweep
(`iltpu_torch.sweep` against `iltpu.sweep`, each over its own
search_space.yaml through its own reader), the seed-sweep aggregation
(`iltpu_torch.analysis` against `iltpu.analysis`, on run directories the
port's trainer wrote), the CLI's `-m` multirun (`iltpu_torch.train` against
the root `train.py`), `train_all` (against the root `train_all.py`), the
trainer's profiler window (its steps against iltpu's `jax.profiler`
window, a Chrome trace, metrics unchanged by it), the refusals that remain
and the kernel build's per-process logs."""

import glob
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import iltpu.trainer
import train as jax_train_cli
import train_all as jax_train_all
from iltpu.analysis import collect_seed_sweep as jax_collect
from iltpu.analysis import iqm as jax_iqm
from iltpu.analysis import stratified_bootstrap_ci as jax_ci
from iltpu.config import CONF_DIR as JAX_CONF_DIR
from iltpu.config import load_config as jax_load_config
from iltpu.sweep import BayesOpt as JaxBayesOpt
from iltpu.sweep import space_from_config as jax_space
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch import train as torch_train_cli
from iltpu_torch import train_all as torch_train_all
from iltpu_torch.analysis import collect_seed_sweep, iqm, stratified_bootstrap_ci
from iltpu_torch.config import CONF_DIR, load_config
from iltpu_torch.config.yaml_subset import loads
from iltpu_torch.sweep import BayesOpt, space_from_config
from iltpu_torch.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = [
    "algorithm=GAIL", "env=pointmass", "env_backend=jax", "steps=200", "training.start=64",
    "num_envs=4", "memory.size=1000", "imitation.trajectories=4", "training.batch_size=16",
    "training.sac_pallas=true", "training.disc_pallas=true", "training.fused_update_scan=true",
    "reinforcement.actor.hidden_size=16", "reinforcement.critic.hidden_size=16",
    "evaluation.episodes=2", "logging.interval=0",
]


def _spaces():
    with open(os.path.join(CONF_DIR, "search_space.yaml")) as f:
        port = loads(f.read())
    with open(os.path.join(JAX_CONF_DIR, "search_space.yaml")) as f:
        ref = yaml.safe_load(f)
    return port, ref


def _objective(params):
    """A deterministic score of a trial's params."""
    x = 0.0
    for k, v in sorted(params.items()):
        x += (sum(map(ord, k)) % 7 + 1) * (float(v) if not isinstance(v, str) else len(v))
    return float(np.sin(x))


# ------------------------------------------------------------ the sweep


@pytest.mark.parametrize("alg", ["AdRIL", "BC", "DRIL", "GAIL", "GMMIL", "PWIL", "RED", "SAC"])
def test_bayesopt_asks_equal_iltpus(alg):
    """The same seed, space and told values give the same trials (params
    and method, exactly), stops and best trial."""
    port, ref = _spaces()
    kw = dict(total_trials=9, sobol_trials=3, early_stop_epochs=4, seed=3, minimize=False)
    a, b = BayesOpt(space=space_from_config(port[alg]), **kw), JaxBayesOpt(
        space=jax_space(ref[alg]), **kw)
    steps = 0
    while not b.should_stop:
        assert not a.should_stop
        ta, tb = a.ask(), b.ask()
        assert (ta.index, ta.params, ta.method) == (tb.index, tb.params, tb.method)
        a.tell(ta, _objective(ta.params))
        b.tell(tb, _objective(tb.params))
        steps += 1
    assert a.should_stop and steps >= 4
    assert [t.method for t in b.trials].count("gp-ei") >= 1
    best_a, best_b = a.best_trial(), b.best_trial()
    assert (best_a.index, best_a.params, best_a.value) == (best_b.index, best_b.params, best_b.value)


# --------------------------------------------------------- aggregation


@pytest.mark.parametrize("shape,axis", [((13,), None), ((6, 5), None), ((6, 5), 1), ((4, 3, 7), 0)])
def test_iqm_equals_iltpus(shape, axis):
    x = np.random.default_rng(len(shape)).normal(size=shape)
    assert np.array_equal(iqm(x, axis=axis), jax_iqm(x, axis=axis))


@pytest.mark.parametrize("shape,seed", [((10, 4), 1), ((5,), 2), ((3, 2), 0)])
def test_stratified_bootstrap_ci_equals_iltpus(shape, seed):
    scores = np.random.default_rng(seed).normal(1.0, 0.2, size=shape)
    assert stratified_bootstrap_ci(scores, reps=2000, seed=seed) == jax_ci(
        scores, reps=2000, seed=seed)


@pytest.fixture(scope="module")
def cli_multirun(tmp_path_factory):
    """A real two-seed `python -m iltpu_torch.train -m` run on the CPU."""
    tmp = tmp_path_factory.mktemp("multirun")
    args = ["-m", "seed=1,2", *TINY, "platform=cpu", "check_time_usage=true",
            f"output_dir={tmp}"]
    r = subprocess.run([sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp),
                       env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    (root,) = glob.glob(str(tmp / "multirun" / "*"))
    return root, args


def test_cli_multirun_writes_iltpus_layout(cli_multirun):
    root, args = cli_multirun
    assert sorted(os.listdir(root)) == ["0", "1", "multirun.yaml"]
    with open(os.path.join(root, "multirun.yaml")) as f:
        record = yaml.safe_load(f)
    assert record["jobs"] == [" ".join([f"seed={s}", *args[2:]]) for s in (1, 2)]
    assert len(record["scores"]) == 2 and np.isfinite(record["scores"]).all()
    for i, seed in enumerate((1, 2)):
        d = os.path.join(root, str(i))
        for name in ("metrics.pkl", "agent", "discriminator"):
            assert os.path.exists(os.path.join(d, name))
        with open(os.path.join(d, "config.yaml")) as f:
            cfg = yaml.safe_load(f)
        job = [f"seed={seed}", *args[2:]]
        assert cfg == dict(jax_load_config(job)) == dict(load_config(job))


def test_collect_seed_sweep_equals_iltpus(cli_multirun):
    """On run directories the port's trainer wrote: explicit ones, and the
    `<ALG>_<env>/*` layout globbed."""
    root, _ = cli_multirun
    dirs = [os.path.join(root, "0"), os.path.join(root, "1")]
    got = collect_seed_sweep("", "GAIL", ["pointmass"], run_dirs_by_env={"pointmass": dirs})
    want = jax_collect("", "GAIL", ["pointmass"], run_dirs_by_env={"pointmass": dirs})
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2] and got[1].shape == (2, 1, 1)
    final = got[1][..., -1]
    assert stratified_bootstrap_ci(final, iqm, reps=2000) == jax_ci(final, jax_iqm, reps=2000)


def test_collect_seed_sweep_globs_like_iltpu(tmp_path, cli_multirun):
    root, _ = cli_multirun
    for i, env in ((0, "pointmass"), (1, "pointmass"), (0, "pendulum")):
        dst = tmp_path / f"GAIL_{env}" / f"run{i}"
        dst.mkdir(parents=True)
        with open(os.path.join(root, str(i), "metrics.pkl"), "rb") as src:
            (dst / "metrics.pkl").write_bytes(src.read())
    got = collect_seed_sweep(str(tmp_path), "GAIL", ["pointmass", "pendulum"])
    want = jax_collect(str(tmp_path), "GAIL", ["pointmass", "pendulum"])
    assert np.array_equal(got[1], want[1]) and got[2] == want[2] and got[1].shape == (1, 2, 1)


# ------------------------------------------------------------ multirun

MULTIRUN_CASES = [
    ["seed=1,2,3", "algorithm=GAIL,PWIL", "env=hopper"],
    ["hidden=[64,64]", "seed=1,2"],
    ["algorithm=BC", "env=hopper"],
    ["a={x: 1, y: 2}", "b=1,2", "c=3"],
    ["training.learning_rate=1e-4,3e-4", "imitation.trajectories=5,10", "seed=0,1"],
    ["--tuned", "seed=1,2"],
    ["flag", "x=", "y=a,b"],
]


@pytest.mark.parametrize("args", MULTIRUN_CASES, ids=[" ".join(a) for a in MULTIRUN_CASES])
def test_expand_multirun_equals_iltpus(args):
    assert torch_train_cli.expand_multirun(args) == jax_train_cli.expand_multirun(args)


@pytest.mark.parametrize("tuned", [False, True])
def test_multirun_equals_iltpus(tmp_path, monkeypatch, tuned):
    """With the trainer monkeypatched: the same job order, directory layout,
    multirun.yaml and config.yaml contents as iltpu's."""
    calls = {}

    def fake(side):
        def train(cfg, out_dir):
            calls.setdefault(side, []).append((cfg["seed"], os.path.relpath(out_dir, tmp_path / side)))
            return float(cfg["seed"]) / 4 + cfg["imitation"]["trajectories"]
        return train

    monkeypatch.setattr(iltpu.trainer, "train", fake("jax"))
    import iltpu_torch.trainer

    monkeypatch.setattr(iltpu_torch.trainer, "train", fake("torch"))
    args = ["-m", "algorithm=GAIL", "env=pointmass", "seed=3,1", "imitation.trajectories=5,10"]
    args += ["--tuned"] if tuned else []
    layouts = {}
    for side, main in (("jax", jax_train_cli.main), ("torch", torch_train_cli.main)):
        scores = main(args + [f"output_dir={tmp_path / side}"])
        (root,) = glob.glob(str(tmp_path / side / "multirun" / "*"))
        files = sorted(os.path.relpath(p, root) for p in glob.glob(root + "/**", recursive=True))
        with open(os.path.join(root, "multirun.yaml")) as f:
            record = yaml.safe_load(f)
        configs = []
        for i in range(4):
            with open(os.path.join(root, str(i), "config.yaml")) as f:
                configs.append(yaml.safe_load(f))
        layouts[side] = (scores, files, record, configs)
        for i, (_, rel) in enumerate(calls[side]):
            assert rel.endswith(os.path.join("multirun", os.path.basename(root), str(i)))
    assert [c[0] for c in calls["torch"]] == [c[0] for c in calls["jax"]] == [3, 3, 1, 1]
    port, ref = layouts["torch"], layouts["jax"]
    assert port[0] == ref[0] and port[1] == ref[1]
    assert port[2]["scores"] == ref[2]["scores"]
    assert port[2]["jobs"] == [j.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
                               for j in ref[2]["jobs"]]
    for a, b in zip(port[3], ref[3]):
        assert a == dict(b, output_dir=str(tmp_path / "torch"))


# ----------------------------------------------------------- train_all


def _fake_run_one(packed):
    env, overrides, _ = packed
    params = dict(o.split("=", 1) for o in overrides if not o.startswith("seed="))
    return _objective(params) + {"pointmass": 0.0, "pendulum": -0.25}[env]


@pytest.mark.parametrize("flags", [
    ["algorithm=GAIL", "--sweep", "5", "--sobol", "2"],
    ["algorithm=SAC", "--sweep", "6", "--early-stop", "1"],
    ["algorithm=PWIL", "--sweep", "4", "--sobol", "3", "--early-stop", "9"],
])
def test_train_all_sweep_equals_iltpus(tmp_path, monkeypatch, capsys, flags):
    """--serial sweeps with a fake objective: the same sweep.jsonl records
    (every key; the random seed is in no record) and best-trial line."""
    monkeypatch.setattr(jax_train_all, "_run_one", _fake_run_one)
    monkeypatch.setattr(torch_train_all, "_run_one", _fake_run_one)
    out = {}
    for side, mod in (("jax", jax_train_all), ("torch", torch_train_all)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        best = mod.main(flags + ["--serial", "--envs", "pointmass,pendulum"])
        printed = capsys.readouterr().out.strip().splitlines()
        alg = flags[0].split("=")[1]
        with open(f"outputs/all_{alg}/sweep.jsonl") as f:
            rows = [json.loads(line) for line in f]
        dirs = sorted(os.listdir(f"outputs/all_{alg}"))
        out[side] = (best, rows, json.loads(printed[-1]), dirs)
    assert out["torch"] == out["jax"]
    assert all(r["min_score"] == min(r["per_env"].values()) for r in out["torch"][1])


def test_train_all_single_trial_equals_iltpus(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(jax_train_all, "_run_one", _fake_run_one)
    monkeypatch.setattr(torch_train_all, "_run_one", _fake_run_one)
    lines = []
    for side, mod in (("jax", jax_train_all), ("torch", torch_train_all)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        mod.main(["algorithm=SAC", "x=1", "--serial", "--envs", "pendulum,pointmass"])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        lines.append((rec.pop("seed") >= 0, rec, os.listdir("outputs/all_SAC")))
    assert lines[0] == lines[1]


def test_train_all_cli_serial_sweep_on_cpu(tmp_path):
    """`python -m iltpu_torch.train_all ... --serial --envs pointmass --sweep
    3 --sobol 2` trains for real; its trials are iltpu's optimiser's."""
    args = [a for a in TINY if not a.startswith(("training.", "algorithm"))] + [
        "algorithm=GAIL", "platform=cpu", "check_time_usage=true"]
    r = subprocess.run(
        [sys.executable, "-m", "iltpu_torch.train_all", *args, "--serial", "--envs", "pointmass",
         "--sweep", "3", "--sobol", "2"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "outputs" / "all_GAIL" / "sweep.jsonl") as f:
        rows = [json.loads(line) for line in f]
    _, ref = _spaces()
    opt = JaxBayesOpt(space=jax_space(ref["GAIL"]), total_trials=3, sobol_trials=2)
    for row in rows:
        t = opt.ask()
        assert (row["trial"], row["method"], row["params"]) == (t.index, t.method, t.params)
        assert row["per_env"] == {"pointmass": row["min_score"]} and np.isfinite(row["min_score"])
        opt.tell(t, row["min_score"])
        assert os.path.exists(tmp_path / "outputs" / "all_GAIL" / f"trial_{t.index:03d}" /
                              "pointmass" / "metrics.pkl")
    assert len(rows) == 3
    best = json.loads(r.stdout.strip().splitlines()[-1])
    assert best["best_trial"] == opt.best_trial().index


def test_run_trial_real_training_on_cpu(tmp_path):
    score, per_env = torch_train_all.run_trial(
        ["seed=0", *TINY, "platform=cpu"], str(tmp_path), serial=True, envs=["pointmass"])
    assert np.isfinite(score) and per_env == {"pointmass": score}
    assert os.path.exists(tmp_path / "pointmass" / "metrics.pkl")


def test_run_trial_pool_equals_serial_and_raises(tmp_path):
    """The forkserver pool gives what the serial loop gives (no updates:
    acting and evaluation only), and a worker's exception propagates."""
    base = ["seed=5", *TINY, "platform=cpu", "training.start=100000", "steps=40"]
    envs = ["pointmass", "pendulum"]
    pooled = torch_train_all.run_trial(base, str(tmp_path / "pool"), serial=False, envs=envs)
    serial = torch_train_all.run_trial(base, str(tmp_path / "serial"), serial=True, envs=envs)
    assert pooled == serial
    with pytest.raises(NotImplementedError, match="'hopper' has no array version"):
        torch_train_all.run_trial(base, str(tmp_path / "bad"), serial=False, envs=["hopper"])


# ---------------------------------------------------- the profiler window

WINDOWS = [  # (num_envs, steps, profiling.start_step, profiling.steps)
    (4, 64, 8, 12),
    (4, 64, 9, 3),
    (4, 64, 40, 1000),
    (4, 64, 100, 8),
    (4, 64, 0, 0),
    (8, 64, 12, 20),
    (8, 64, 0, 8),
    (8, 40, 16, 100),
]


def _record_window(trainer, env, cls_patch, monkeypatch, trace_dir):
    """Run each WINDOWS case on `trainer`'s host loop; the env steps done
    when the window opened and closed."""
    out = []
    for N, steps, start, n in WINDOWS:
        if trainer.cfg.num_envs != N:
            continue
        events = []
        count = [0]
        step = env.step

        def counted(*a, _step=step):
            count[0] += 1
            return _step(*a)

        monkeypatch.setattr(env, "step", counted)
        cls_patch(lambda kind: events.append((kind, count[0] * N)))
        trainer.cfg["profiling"] = {"trace_dir": trace_dir, "start_step": start, "steps": n}
        trainer.cfg["steps"] = steps
        trainer._host_loop()
        monkeypatch.setattr(env, "step", step)
        out.append(((N, steps, start, n), events))
    return out


@pytest.mark.parametrize("N", [4, 8])
def test_profiler_window_steps_equal_iltpus(tmp_path, monkeypatch, N):
    args = ["algorithm=SAC", "env=pointmass", "env_backend=jax", f"num_envs={N}",
            "training.start=100000", "evaluation.interval=100000", "logging.interval=0",
            "memory.size=1000", "imitation.trajectories=2", "training.batch_size=16",
            "reinforcement.actor.hidden_size=16", "reinforcement.critic.hidden_size=16"]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))

    def patch_jax(record):
        monkeypatch.setattr(jax.profiler, "start_trace", lambda d: record("start"))
        monkeypatch.setattr(jax.profiler, "stop_trace", lambda: record("stop"))

    want = _record_window(jt, jt.env, patch_jax, monkeypatch, str(tmp_path / "trace"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))

    def patch_torch(record):
        class Fake:
            def __init__(self, activities):
                assert activities == [torch.profiler.ProfilerActivity.CPU]

            def start(self):
                record("start")

            def stop(self):
                record("stop")

            def export_chrome_trace(self, path):
                pass

        monkeypatch.setattr(torch.profiler, "profile", Fake)

    got = _record_window(tt, tt.env, patch_torch, monkeypatch, str(tmp_path / "trace"))
    assert got == want and any(events for _, events in got)


@pytest.mark.parametrize("mode", ["plain", "training.pipeline=true", "training.host_acting=true"])
def test_profiler_window_writes_a_trace_and_leaves_metrics(tmp_path, mode):
    """On the CPU the window writes a Chrome trace that parses, with the
    host loop's spans in it beside the operators; the run's metrics.pkl and
    agent equal those of the same run without one."""
    args = TINY + ["platform=cpu", "evaluation.interval=100", "logging.interval=40"]
    args += [] if mode == "plain" else [mode]
    runs = {}
    for name, extra in (("without", []), ("with", [f"profiling.trace_dir={tmp_path / 'trace'}",
                                                     "profiling.start_step=100",
                                                     "profiling.steps=20"])):
        t = Trainer(load_config(args + extra), out_dir=str(tmp_path / name))
        t.run()
        with open(tmp_path / name / "metrics.pkl", "rb") as f:
            runs[name] = (pickle.load(f), [p.clone() for p in t.sac["a"]], t.profiler.path)
    assert runs["with"][0] == runs["without"][0] and runs["with"][0]["update_steps"]
    assert all(torch.equal(a, b) for a, b in zip(runs["with"][1], runs["without"][1]))
    path = runs["with"][2]
    assert runs["without"][2] is None and os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"iteration", "front", "updates", "update"} <= spans, spans


def test_device_loop_has_no_window(tmp_path):
    """As iltpu's `_device_loop`: a trace_dir is accepted and no window opens."""
    t = Trainer(load_config(TINY + ["platform=cpu", "training.on_device_loop=true",
                                    f"profiling.trace_dir={tmp_path / 'trace'}",
                                    "profiling.start_step=0"]), out_dir=str(tmp_path))
    t.run()
    assert not os.path.exists(tmp_path / "trace") and not hasattr(t, "profiler")


# ------------------------------------------------------------ refusals


def test_unknown_expert_source_fails_as_iltpus(tmp_path):
    args = TINY + ["expert_data.source=bogus"]
    with pytest.raises(AssertionError, match="unknown expert_data.source bogus"):
        Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path))
    with pytest.raises(AssertionError, match="unknown expert_data.source bogus"):
        JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))


# ------------------------------------------------------ the kernel build

FAKE_NVCC = """#!/bin/sh
# a stand-in for nvcc: logs, waits, then writes its -o file or fails
echo "fake build by $$"
sleep 1
[ -n "$FAIL" ] && { echo "error: fake failure $$"; exit 1; }
while [ "$#" -gt 0 ]; do [ "$1" = "-o" ] && { echo lib > "$2"; }; shift; done
"""


def _builds(tmp_path, where, n=2, **env):
    """n processes building gail_update at once under tmp_path/where with
    a fake nvcc; their (return code, stdout, stderr)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    code = (f"import iltpu_torch.ops.build as b; b.BUILD_DIR = {str(tmp_path / where)!r}; "
            "b.build_all(('gail_update',)); print(b.build_log('gail_update'))")
    env = dict(os.environ, PYTHONPATH=REPO, NVCC=str(nvcc), **env)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(n)]
    outs = [p.communicate(timeout=60) for p in procs]
    return [(p.returncode, *o) for p, o in zip(procs, outs)]


def test_concurrent_builds_keep_their_own_logs(tmp_path):
    """Two processes building one library at once: each logs apart, and
    the library and one build.log appear, which `build_log` reads."""
    done = _builds(tmp_path, "build")
    assert all(rc == 0 and "fake build by" in out for rc, out, _ in done), done
    (lib_dir,) = glob.glob(str(tmp_path / "build" / "gail_update-*"))
    assert sorted(os.listdir(lib_dir)) == ["build.log", "libgail_update.so"]


def test_concurrent_failed_builds_report_their_own_logs(tmp_path):
    """Two failing builds at once: each error carries its own nvcc's log."""
    pids = []
    for rc, _, err in _builds(tmp_path, "failed", FAIL="1"):
        assert rc != 0 and "nvcc failed to build gail_update" in err
        mine = [ln.split()[-1] for ln in err.splitlines() if "fake " in ln]
        assert len(mine) == 2 and mine[0] == mine[1], err[-2000:]
        pids.append(mine[0])
    assert pids[0] != pids[1]
