"""Checkpoint and resume in the port (`iltpu_torch/utils/checkpoint.py`,
`convert.train_state_tree` / `load_train_state_`, `Trainer._checkpoint` /
`_resume`, the run outputs of `Trainer._save` and `agent_best/`) against
iltpu's (`iltpu/utils/checkpoint.py`, `iltpu/trainer.py:1304-1400`):

- a round trip restores every `state_tensors()` entry, the rest of the
  state (the expert ring, DRIL's threshold, ...) and the generator's state
  bit for bit, on every algorithm's state;
- the port's `leaves.npz` of `checkpoint/`, `agent/` and `discriminator/`
  unflattens with the treedef of an iltpu Trainer on the same config into
  iltpu's leaf paths, shapes and dtypes, and iltpu's values where the two
  states were loaded equal through `convert`;
- a run to 200 steps with checkpointing.interval=100, resumed to 400, has
  iltpu's steps, evaluations, checkpoint steps and metrics on both loops
  (the device programs and envs stubbed on both sides); iltpu's resumed
  host loop makes up every update since training.start in its first
  iteration, the port's continues the schedule;
- `agent_best/` is rewritten only on a strict improvement and keeps its
  floor across a resume; an iltpu `agent_best/header.pkl` is never
  unpickled."""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from iltpu.config import load_config as jax_load_config
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.trainer import Trainer
from iltpu_torch.utils.checkpoint import Fields, flatten, load_checkpoint, unflatten
from test_torch_pipeline import AUX, SMALL, assert_same_metrics, stub_iltpu, stub_port

torch.set_num_threads(1)

ALGORITHMS = {
    "gail": ["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true"],
    "gail_shaping_log_pi": ["algorithm=GAIL", "imitation.discriminator.reward_shaping=true",
                            "imitation.discriminator.subtract_log_policy=true"],
    "dril": ["algorithm=DRIL", "imitation.pretraining.iterations=10"],
    "red": ["algorithm=RED", "imitation.pretraining.iterations=10"],
    "gmmil": ["algorithm=GMMIL"],
    "pwil": ["algorithm=PWIL", "imitation.mix_expert_data=prefill_memory"],
    "adril": ["algorithm=AdRIL"],
    "sac": ["algorithm=SAC"],
}
RUN = ["num_envs=4", "steps=64", "training.start=32", "logging.interval=8",
       "evaluation.interval=1000", "checkpointing.interval=64", "memory.size=200"]


def _port(tmp_path, name, extra):
    return Trainer(load_config(SMALL + list(extra) + ["platform=cpu"]), out_dir=str(tmp_path / name))


def _assert_equal_trees(got, want, what):
    (lg, pg), (lw, pw) = flatten(got), flatten(want)
    assert pg == pw, what
    for path, g, w in zip(pg, lg, lw):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"{what} {path}")


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_round_trip_restores_every_tensor_and_the_generator(tmp_path, name):
    a = _port(tmp_path, "a", ALGORITHMS[name] + RUN)
    a.run()
    ckpt = str(tmp_path / "a" / "checkpoint")
    b = _port(tmp_path, "b", ALGORITHMS[name] + RUN + [f"checkpointing.resume={ckpt}"])
    sa, sb = a.state_tensors(), b.state_tensors()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    _assert_equal_trees(convert.train_state_tree(b), convert.train_state_tree(a), name)
    assert b.start_step == 64 and b.updates_done == a.updates_done == 64 - 32 + 1
    assert b.metrics == a.metrics and b.score == a.score
    if name == "dril":
        assert torch.equal(a.dril_threshold, b.dril_threshold) and float(a.dril_threshold) != 0


JAX_CONFIGS = {k: v for k, v in ALGORITHMS.items() if k not in ("sac",)}


@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_leaves_unflatten_into_iltpus_state(tmp_path, name):
    """iltpu's state, loaded into the port through its leaves and
    `load_train_state_`, comes back from the port's checkpoint, agent/ and
    discriminator/ with iltpu's treedefs: paths, shapes, dtypes and values."""
    args = SMALL + JAX_CONFIGS[name] + RUN
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    state = jt.state
    flat, treedef = jax.tree_util.tree_flatten_with_path(state)
    leaves = [np.asarray(x) for _, x in flat]
    like = convert.train_state_tree(tt)
    assert flatten(like)[1] == [jax.tree_util.keystr(p) for p, _ in flat]
    convert.load_train_state_(tt, unflatten(like, leaves))
    tt._checkpoint(0, 0)
    tt._save()
    jax_leaves = jax.tree.leaves(state)
    for sub, want in (("checkpoint", state),
                      ("agent", {"actor": state["sac"].actor_params,
                                 "critic": state["sac"].critic_params,
                                 "log_alpha": state["sac"].log_alpha}),
                      ("discriminator", state.get("disc"))):
        path = tmp_path / "torch" / sub
        if sub == "discriminator" and name in ("gmmil", "pwil", "adril"):
            assert not path.exists()  # iltpu writes none for these
            continue
        with np.load(path / "leaves.npz") as data:
            got = [data[f"leaf_{i}"] for i in range(len(data.files))]
        want_leaves, want_def = jax.tree.flatten(want)
        rebuilt = jax.tree.unflatten(want_def, got)
        for (p, g), w in zip(jax.tree_util.tree_flatten_with_path(rebuilt)[0], want_leaves):
            w = np.asarray(w)
            what = f"{sub} {jax.tree_util.keystr(p)}"
            assert g.shape == w.shape and g.dtype == w.dtype, what
            np.testing.assert_array_equal(g, w, err_msg=what)
    assert len(jax_leaves) == len(leaves)


def test_checkpoint_layout_is_checked(tmp_path):
    a = _port(tmp_path, "a", ALGORITHMS["gail"] + RUN)
    a._checkpoint(0, 0)
    with pytest.raises(ValueError, match="another state layout"):
        load_checkpoint(str(tmp_path / "a" / "checkpoint"),
                        like=convert.train_state_tree(_port(tmp_path, "b", ALGORITHMS["sac"] + RUN)))
    assert isinstance(convert.train_state_tree(a)["sac"], Fields)


# ------------------------------------------------------- resume against iltpu


def _chunk(start, n_iters, N):
    steps = start + N * np.arange(1, n_iters + 1)[:, None] + np.arange(N)[None]
    return np.sin(0.37 * steps).astype(np.float32), (steps // N + np.arange(N)) % 5 == 0


def _recording_chunk(calls, N):
    def run_chunk(env_state, step, n_iters, upi):
        calls.append((step, n_iters, upi))
        r, d = _chunk(step, n_iters, N)
        return (torch.from_numpy(r), torch.from_numpy(d),
                {k: torch.tensor(v) for k, v in AUX.items()})

    return run_chunk


def _stubbed(tmp_path, jargs, targs, tag, first=0):
    """iltpu's trainer on `jargs` and the port's on `targs`, with their
    device programs and envs stubbed and their checkpoints recorded;
    returns (update calls, checkpoint steps, iltpu's trainer, the port's)."""
    jt = JaxTrainer(jax_load_config(jargs), out_dir=str(tmp_path / tag / "jax"))
    tt = Trainer(load_config(targs + ["platform=cpu"]), out_dir=str(tmp_path / tag / "torch"))
    calls, checks = {"jax": [], "torch": []}, {"jax": [], "torch": []}
    for key, t in (("jax", jt), ("torch", tt)):
        real = t._checkpoint
        t._checkpoint = lambda step, *rest, real=real, key=key: (checks[key].append(step),
                                                                 real(step, *rest))
    N = jt.cfg.num_envs
    if jt.cfg.training.get("on_device_loop"):
        def scan_chunk(state, env_state, base_key, start_step, n_iters, updates_per_iter):
            calls["jax"].append((int(start_step), n_iters, updates_per_iter))
            r, d = _chunk(int(start_step), n_iters, N)
            return state, env_state, r, d, {k: np.asarray(v, np.float32) for k, v in AUX.items()}

        jt._scan_chunk, tt.run_chunk = scan_chunk, _recording_chunk(calls["torch"], N)
        jt.evaluate = tt.evaluate = lambda: [1.0, 2.0]
    else:
        stub_iltpu(jt, calls["jax"], first)
        stub_port(tt, calls["torch"], first)
    return calls, checks, jt, tt


@pytest.mark.parametrize("loop", ["host", "device"])
def test_resume_follows_iltpus_schedule(tmp_path, loop):
    N = 4
    base = SMALL + ["algorithm=SAC", f"num_envs={N}", "training.start=64", "logging.interval=40",
                    "evaluation.interval=100", "checkpointing.interval=100", "memory.size=400",
                    "training.on_device_loop=true" if loop == "device" else "training.pipeline=true"]
    first = base + ["steps=200"]
    calls, checks, jt, tt = _stubbed(tmp_path, first, first, "first")
    jt.run()
    tt.run()
    assert calls["torch"] == calls["jax"] and checks["torch"] == checks["jax"]
    assert checks["jax"][-1] == 200 and len(checks["jax"]) == 2  # a chunk may end past 100
    assert_same_metrics(tt.metrics, jt.metrics)

    # each resumes from its own checkpoint (iltpu's header.pkl is not the port's)
    resumed = ["checkpointing.resume=" + str(tmp_path / "first" / "{}" / "checkpoint"), "steps=400"]
    calls2, checks2, jt2, tt2 = _stubbed(
        tmp_path, base + [a.format("jax") for a in resumed],
        base + [a.format("torch") for a in resumed], "second", first=200 // N)
    assert jt2.start_step == tt2.start_step == 200
    jt2.run()
    tt2.run()
    if loop == "device":
        assert calls2["torch"] == calls2["jax"] and calls2["jax"][0][0] == 200
    else:
        # iltpu makes up every update since training.start in its first
        # resumed iteration; the port continues the schedule
        assert calls2["torch"][1:] == calls2["jax"][1:]
        assert calls2["jax"][0] == calls2["torch"][0] + sum(calls["torch"])
        assert sum(calls["torch"]) + sum(calls2["torch"]) == 400 - 64 + 1 == tt2.updates_done
    assert checks2["torch"] == checks2["jax"] and checks2["jax"][-1] == 400
    assert tt2.step_done == jt2.step_done == 400
    for key in ("train_steps", "update_steps", "test_steps", "alphas", "train_returns",
                "test_returns"):
        assert len(tt2.metrics[key]) == len(jt2.metrics[key]), key
    assert_same_metrics(tt2.metrics, jt2.metrics)
    assert len(tt2.metrics["test_steps"]) == 4


# ------------------------------------------------------------- agent_best


def test_agent_best_strict_improvement_and_floor_across_resume(tmp_path, monkeypatch):
    import shutil

    import iltpu_torch.trainer as trainer_module

    opened, written = [], []
    real_load, real_save = pickle.load, trainer_module.save_checkpoint

    def load(f, *args, **kwargs):
        opened.append(os.path.basename(f.name))
        return real_load(f, *args, **kwargs)

    def save(path, tree, aux=None):
        if path.endswith("agent_best"):
            written.append((os.path.basename(os.path.dirname(path)), aux["step"]))
        return real_save(path, tree, aux)

    monkeypatch.setattr(pickle, "load", load)
    monkeypatch.setattr(trainer_module, "save_checkpoint", save)
    args = SMALL + ALGORITHMS["sac"] + [
        "num_envs=4", "training.start=32", "logging.interval=0", "evaluation.interval=40",
        "checkpointing.interval=80", "memory.size=400", "platform=cpu"]

    def run(out, scores, steps, resume=None):
        extra = [f"steps={steps}"] + ([f"checkpointing.resume={resume}"] if resume else [])
        t = Trainer(load_config(args + extra), out_dir=str(tmp_path / out))
        it = iter(scores)
        t.evaluate = lambda: [next(it)] * 2
        t._normalized = lambda r: list(r)
        t.run()
        return t

    best = tmp_path / "a" / "agent_best"
    best.mkdir(parents=True)
    (best / "header.pkl").write_bytes(b"iltpu's pickled JAX treedef")  # no floor, never opened
    t = run("a", [0.2, 0.5, 0.5, 0.4], 160)  # a tie and a drop do not rewrite it
    assert written == [("a", 40), ("a", 80)]
    saved, aux = load_checkpoint(str(best), like=t._best_tree(0, 0.0))
    assert int(saved["step"]) == 80 and float(saved["score"]) == 0.5 == aux["score"]
    assert saved["score"].dtype == np.float64 and saved["step"].dtype == np.asarray(0).dtype
    assert sorted(saved) == ["actor", "critic", "log_alpha", "score", "step"]
    shutil.copytree(tmp_path / "a" / "checkpoint", tmp_path / "at160")
    # resumed from 160: a better best in this directory ...
    run("b", [0.9, 0.6], 240, resume=str(tmp_path / "at160"))
    assert written[2:] == [("b", 200)]
    # ... is the floor of a run resumed into it from the same checkpoint,
    # whose restored history (best 0.5) ends before it
    t = run("b", [0.7, 0.8], 240, resume=str(tmp_path / "at160"))
    assert written[3:] == [] and t.score == [0.2, 0.5, 0.5, 0.4, 0.7, 0.8]
    assert "header.pkl" not in opened and "header_torch.pkl" in opened
