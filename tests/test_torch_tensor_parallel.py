"""The tensor-parallel layout's rule, and `evaluation.on_host`, in the port
against iltpu.

- `iltpu_torch.parallel.param_shardings` on `convert.train_state_tree`
  shards exactly the leaves that iltpu's `param_shardings` shards in
  iltpu's `Trainer.state` (same configuration, meshes of 2 and 4 of the 8
  virtual devices), leaf for leaf in iltpu's flatten order, and
  `tensor.port_name` names a port tensor for every sharded leaf;
- `Trainer.evaluate` reads `evaluation.on_host`: true evaluates through the
  numpy copy of the actor (`host_greedy_fn`), false through the device
  forward, and both give iltpu's `evaluate` returns from the same actor
  parameters and initial states, at the chain tolerance rtol 1e-4 /
  atol 1e-5.

The layout itself runs in tests/test_torch_parallel.py (gloo ranks)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import iltpu.parallel as jax_parallel
import iltpu_torch.trainer as port_trainer
from iltpu.config import load_config as jax_load_config
from iltpu.trainer import Trainer as JaxTrainer
from iltpu.trainer import _JaxEnvAdapter
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.parallel import DataMesh, param_shardings
from iltpu_torch.parallel.tensor import port_name
from iltpu_torch.trainer import Trainer
from iltpu_torch.utils.checkpoint import flatten
from test_torch_convert import jax_sac_tree

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)

# the rule's configuration: full widths, a small ring
RULE = ["env=pointmass", "env_backend=jax", "memory.size=1000", "training.batch_size=32"]


def _iltpu_sharded(state, n):
    """(sharded?, shape) of every leaf of iltpu's state under its rule on a
    mesh of the first n devices, in flatten order."""
    specs = jax_parallel.param_shardings(jax_parallel.make_mesh(n), state, "data")
    return [(s.spec != PartitionSpec(), tuple(np.shape(x)))
            for s, x in zip(jax.tree.leaves(specs), jax.tree.leaves(state))]


@pytest.fixture(scope="module")
def rule_trainers(tmp_path_factory):
    root = tmp_path_factory.mktemp("rule")
    out = {}
    for alg in ("GAIL", "DRIL", "RED", "PWIL"):
        args = RULE + [f"algorithm={alg}"]
        jt = JaxTrainer(jax_load_config(args), out_dir=str(root / f"{alg}.jax"))
        tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(root / f"{alg}.torch"))
        out[alg] = (jt, tt)
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("alg", ["GAIL", "DRIL", "RED", "PWIL"])
def test_param_shardings_matches_iltpu(rule_trainers, alg, world):
    """The port's specs on train_state_tree equal iltpu's param_shardings
    on its Trainer.state leaf for leaf; each rank's columns are its block
    of the last axis; every sharded leaf has a port tensor. GAIL: 14
    sharded leaves at 2 ranks (the replay's and the expert's actions
    among them), 12 at 4."""
    jt, tt = rule_trainers[alg]
    want = _iltpu_sharded(jt.state, world)
    tree = convert.train_state_tree(tt)
    leaves, paths = flatten(tree)
    for rank in range(world):
        specs = flatten(param_shardings(DataMesh(None, rank, world, "data", None), tree))[0]
        got = [(s is not None, tuple(np.shape(x))) for s, x in zip(specs, leaves)]
        assert got == want, [(p, g, w) for p, g, w in zip(paths, got, want) if g != w]
        for s, x, p in zip(specs, leaves, paths):
            if s is not None:
                c = np.shape(x)[-1] // world
                assert (s.start, s.stop) == (rank * c, (rank + 1) * c), p
                assert port_name(p, tt.disc) is not None, p
    sharded = {p for (s, _), p in zip(want, paths) if s}
    assert ({"['replay'].actions", "['expert'].actions"} <= sharded) == (world == 2)
    assert {"['sac'].actor_params['layers'][0]['w']", "['sac'].critic_params['layers'][0]['b']",
            "['sac'].target_critic_params['layers'][1]['w']"} <= sharded
    if alg == "GAIL":
        assert len(sharded) == {2: 14, 4: 12}[world]
        assert "['disc']['g']['layers'][0]['w']" in sharded


EVAL = ["algorithm=GAIL", "env=pointmass", "env_backend=jax", "evaluation.episodes=3",
        "reinforcement.actor.hidden_size=32", "reinforcement.critic.hidden_size=32",
        "memory.size=1000"]


@pytest.mark.parametrize("on_host", ["true", "false"])
def test_evaluate_on_host(tmp_path, monkeypatch, on_host):
    """The port's test returns equal iltpu's `evaluate` (its `_greedy_fn`
    and `_JaxEnvAdapter` loop) for both settings of evaluation.on_host, from
    iltpu's actor parameters (`convert`) and iltpu's initial eval states;
    true goes through `host_greedy_fn`, false does not."""
    args = EVAL + [f"evaluation.on_host={on_host}"]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    convert.load_sac_tree_(tt.sac, jax_sac_tree(jt.state["sac"]))
    cfg = jt.cfg
    obs0 = torch.from_numpy(_JaxEnvAdapter(cfg.env, cfg.evaluation.episodes,
                                           absorbing=cfg.imitation.absorbing,
                                           seed=cfg.seed + 7919).reset().copy())
    make_env = port_trainer.make_env

    def iltpu_start(*a, **kw):  # the eval envs start where iltpu's do
        env = make_env(*a, **kw)
        fresh = env.reset

        def reset(generator=None):
            st = fresh(generator)
            st["inner"] = {"pos": obs0[:, :2].clone(), "vel": obs0[:, 2:4].clone()}
            st["obs"] = obs0.clone()
            return st

        env.reset = reset
        return env

    host_calls, host_greedy_fn = [], port_trainer.host_greedy_fn

    def spy(actor, params):
        host_calls.append(len(params))
        return host_greedy_fn(actor, params)

    monkeypatch.setattr(port_trainer, "make_env", iltpu_start)
    monkeypatch.setattr(port_trainer, "host_greedy_fn", spy)
    got, want = tt.evaluate(), jt.evaluate()
    assert len(got) == cfg.evaluation.episodes and np.all(np.asarray(want) != 0)
    np.testing.assert_allclose(got, want, **TOL)
    assert host_calls == ([6] if on_host == "true" else [])
