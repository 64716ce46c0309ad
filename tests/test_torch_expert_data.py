"""The port's expert-data generator (`iltpu_torch.generate_expert_data`)
against iltpu's `scripts/generate_expert_data.py`, on the CPU at small
sizes: `--from-checkpoint` on the C++ stepper from the same numpy actor
parameters (made from a seed, laid out by `convert.agent_tree`, written by
each package's `save_checkpoint`) gives bit-equal columns and the same
printed lines in every rollout mode; the composed config is iltpu's; and
the training path runs on the port alone, in a process that never imports
JAX or iltpu, its file loading through both packages' expert loaders to
equal transitions."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import iltpu.config
import iltpu.utils.checkpoint as jax_checkpoint
from iltpu.data import build_expert_transitions as jax_transitions
from iltpu_torch import convert
from iltpu_torch import generate_expert_data as port
from iltpu_torch.config import load_config
from iltpu_torch.data import build_expert_transitions
from iltpu_torch.models import SoftActor, TwinCritic
from iltpu_torch.updates import SACLearner
from iltpu_torch.utils.checkpoint import save_checkpoint
from scripts import generate_expert_data as script
from test_torch_config import _same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOPPER_S, HOPPER_A = 11, 3


def agent_tree(in_dim, action_size, seed, hidden=32):
    """`convert.agent_tree` of a SAC state whose actor leaves are numpy
    draws from `seed` (W ~ N(0, 1 / fan_in))."""
    learner = SACLearner(SoftActor(in_dim, action_size, hidden, 2, "relu"),
                         TwinCritic(in_dim, action_size, hidden, 2, "relu"))
    st = learner.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in st["a"]:
            w = rng.standard_normal(tuple(t.shape)) / np.sqrt(t.shape[0])
            t.copy_(torch.from_numpy(w.astype(np.float32)))
    return convert.agent_tree(st)


def checkpoints(tmp_path, trees):
    """Each tree written by both packages: (iltpu's dirs, the port's dirs)."""
    jax_dirs, port_dirs = [], []
    for i, tree in enumerate(trees):
        jax_checkpoint.save_checkpoint(str(tmp_path / f"jax_{i}"), tree)
        save_checkpoint(str(tmp_path / f"port_{i}"), tree)
        jax_dirs.append(str(tmp_path / f"jax_{i}"))
        port_dirs.append(str(tmp_path / f"port_{i}"))
    return ",".join(jax_dirs), ",".join(port_dirs)


def run(main, argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(argv)
    return printed.getvalue().splitlines()


def best(tree, step, score):
    """An `agent_best/` tree: the agent with its step and score, as the trainers write it."""
    return dict(tree, step=np.asarray(step), score=np.asarray(score))


CASES = {  # (env, actor trees (in_dim offset over the raw obs, seed), flags)
    "greedy": ("hopper", [(0, 1)], ["--episodes", "3"]),
    "stochastic": ("hopper", [(0, 2)], ["--episodes", "3", "--stochastic", "0.3"]),
    "only_timeout_all_dropped": ("hopper", [(0, 1)],
                                 ["--episodes", "2", "--only-timeout-episodes", "--max-attempts", "3"]),
    "only_timeout_kept": ("halfcheetah", [(0, 4)],  # halfcheetah never terminates
                          ["--episodes", "1", "--only-timeout-episodes", "--max-attempts", "2"]),
    "min_normalized": ("hopper", [(0, 3)], ["--episodes", "3", "--stochastic", "0.5",
                                            "--min-normalized", "0.02", "--max-attempts", "8"]),
    "round_robin": ("hopper", [(0, 1), (0, 5)], ["--episodes", "4", "--stochastic", "0.2"]),
    "absorbing_bit": ("hopper", [(1, 6)], ["--episodes", "2"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_from_checkpoint_matches_the_script(tmp_path, case):
    env, actors, flags = CASES[case]
    S, A = {"hopper": (HOPPER_S, HOPPER_A), "halfcheetah": (17, 6)}[env]
    trees = [agent_tree(S + extra, A, seed) for extra, seed in actors]
    if len(trees) == 2:  # agent/ and agent_best/
        trees[1] = best(trees[1], 400, 0.5)
    jax_dirs, port_dirs = checkpoints(tmp_path, trees)
    common = ["--env", env, "--env-backend", "native", "--platform", "cpu", "--seed", "3", *flags]
    want = run(script.main, common + ["--from-checkpoint", jax_dirs, "--out", str(tmp_path / "jax.npz")])
    got = run(port.main, common + ["--from-checkpoint", port_dirs, "--out", str(tmp_path / "port.npz")])
    assert got[:-1] == want[:-1]
    assert got[-1] == want[-1].replace(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert b.files == a.files == list(port.COLUMNS)
        for k in a.files:
            assert b[k].dtype == a[k].dtype == np.float32 and b[k].shape == a[k].shape
            assert b[k].tobytes() == a[k].tobytes(), k
        n = len(a["rewards"])
    kept = sum(line.startswith("episode ") for line in got)
    dropped = sum(" — dropped (" in line for line in got)
    want_kept = {"only_timeout_all_dropped": 0, "only_timeout_kept": 1}.get(case, int(flags[1]))
    assert (n > 0) == (kept > 0)
    if case == "min_normalized":  # both branches taken, the attempts spent
        assert 0 < kept < 3 and dropped == 8 - kept and got[-2].startswith("WARNING")
    else:
        assert (kept, dropped) == (want_kept, 3 if case == "only_timeout_all_dropped" else 0)


def test_checkpoint_actor_reads_agent_and_agent_best(tmp_path):
    tree = agent_tree(HOPPER_S, HOPPER_A, 7)
    save_checkpoint(str(tmp_path / "agent"), tree)
    save_checkpoint(str(tmp_path / "agent_best"), best(tree, 10, 0.25))
    want = [tree["actor"]["layers"][i][k] for i in range(3) for k in ("w", "b")]
    for d in ("agent", "agent_best"):
        got = port.checkpoint_actor(str(tmp_path / d))
        assert [g.numpy().tobytes() for g in got] == [w.tobytes() for w in want]
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), tree)
    with pytest.raises(FileNotFoundError):  # iltpu's directories: header.pkl only
        port.checkpoint_actor(str(tmp_path / "jax"))


@pytest.mark.parametrize("flags", [
    ["--env", "hopper"],
    ["--env", "pointmass", "--env-backend", "jax", "--steps", "1200", "--num-envs", "2", "--seed", "4"],
    ["--env", "ant", "--steps", "7", "--platform", "cpu"],
])
def test_config_is_the_scripts(tmp_path, monkeypatch, flags):
    """The override list the script hands iltpu's `load_config` (caught
    there), then both packages' configs of it; the port adds `platform=`."""
    caught = []

    class Caught(Exception):
        pass

    def catch(overrides, **kw):
        caught.append(list(overrides))
        raise Caught

    monkeypatch.setattr(iltpu.config, "load_config", catch)
    argv = flags + ["--out", str(tmp_path / "x.npz")]
    with pytest.raises(Caught):
        script.main([f for f in argv if f not in ("--platform", "cpu")])
    monkeypatch.undo()
    ours = port.overrides(port.parser().parse_args(argv))
    platform = [f"platform={argv[argv.index('--platform') + 1]}"] if "--platform" in argv else []
    assert ours == caught[0] + platform
    assert _same(dict(load_config(caught[0])), dict(iltpu.config.load_config(caught[0])))


def test_the_card_is_the_default(tmp_path):
    """Without CUDA and without `--platform cpu` the generator raises before
    it trains or steps anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="platform=cpu"):
        port.main(["--env", "hopper", "--from-checkpoint", "x", "--out", str(tmp_path / "x.npz")])
    assert not os.path.exists(tmp_path / "x.npz")


@pytest.mark.parametrize("env,backend", [("hopper", "native"), ("pointmass", "jax")])
def test_training_path_runs_on_the_port_alone(tmp_path, env, backend):
    """In a process that never imports JAX or iltpu: train the SAC expert
    (1,200 steps, 2 envs, autograd SAC), roll out 2 greedy episodes; the
    file loads through both packages' `build_expert_transitions` to equal
    transitions."""
    out = tmp_path / "data" / f"{env}.npz"
    code = f"""
import json, sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(2)
from iltpu_torch import generate_expert_data
generate_expert_data.main(["--env", {env!r}, "--env-backend", {backend!r}, "--steps", "1200",
                           "--num-envs", "2", "--episodes", "2", "--platform", "cpu",
                           "--out", {str(out)!r}])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "iltpu", "scripts"))
print(json.dumps(bad))
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(tmp_path), timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == []
    assert lines[0].startswith("expert trained: mean normalized score ")
    assert [line.split(":")[0] for line in lines[1:3]] == ["episode 1/2", "episode 2/2"]
    assert lines[-2].startswith(f"wrote {out}: ") and lines[-2].endswith(" transitions, 2 episodes")
    training = tmp_path / "data" / "expert_training"
    assert (training / "agent").is_dir() and (training / "metrics.pkl").is_file()
    with np.load(out) as f:
        data = {k: f[k] for k in f.files}
    assert list(data) == list(port.COLUMNS) and all(v.dtype == np.float32 for v in data.values())
    ends = np.flatnonzero(data["terminals"] + data["timeouts"])
    assert len(ends) == 2 and ends[-1] == len(data["rewards"]) - 1
    for absorbing in (False, True):
        (got, n_got), (want, n_want) = [
            f({k: v.copy() for k, v in data.items()}, trajectories=2, absorbing=absorbing,
              rng=np.random.default_rng(0))
            for f in (build_expert_transitions, jax_transitions)]
        assert n_got == n_want == 2 and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
