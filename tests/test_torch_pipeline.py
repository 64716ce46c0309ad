"""Pipelined and host acting in the port's host loop
(`training.pipeline`, `training.host_acting`; `Trainer._host_loop` in
iltpu_torch/trainer.py, `iltpu_torch/models/host_inference.py`) against
iltpu's (`iltpu/trainer.py:1449-1637`, `iltpu/models/host_inference.py`):

- the port's HostActor and host_greedy_fn equal iltpu's bit for bit on
  converted params, observations and seeded numpy generators;
- the pipelined host loop equals, bit for bit, the same iterations driven
  one by one with each act reading the actor params saved before the
  previous iteration's updates (every state tensor and the generator), on
  GAIL per update and update_block=4, PWIL and AdRIL; before
  training.start it equals the plain loop;
- host acting equals the same iterations with a HostActor refreshed by
  hand with the params of one iteration before;
- the schedule and metrics of both modes (the updates an iteration, the
  train, update and test steps, the steady marks) equal iltpu's host loop's
  with the device programs and the envs stubbed on both sides;
- either flag with training.on_device_loop takes the on-device loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.config import load_config as jax_load_config
from iltpu.models.actor import SoftActor
from iltpu.models.host_inference import HostActor as JaxHostActor
from iltpu.models.host_inference import host_greedy_fn as jax_host_greedy_fn
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch import convert
from iltpu_torch.config import load_config
from iltpu_torch.models import SoftActor as TSoftActor
from iltpu_torch.models.host_inference import HostActor, host_greedy_fn
from iltpu_torch.trainer import Trainer
from test_torch_convert import np_tree

torch.set_num_threads(1)

SMALL = [
    "env=pointmass", "env_backend=jax", "memory.size=1000", "imitation.trajectories=4",
    "training.batch_size=16", "reinforcement.actor.hidden_size=16",
    "reinforcement.critic.hidden_size=16", "evaluation.episodes=1",
]
AUX = {"predicted_rewards": [0.5, 0.25], "alphas": 0.1, "entropies": [0.0, 1.0],
       "Q_values": [2.0, 3.0]}


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_host_actor_equals_iltpus(activation):
    actor = SoftActor(5, 2, hidden_size=32, depth=2, activation=activation)
    params = actor.init(__import__("jax").random.key(3))
    ta = TSoftActor(5, 2, hidden_size=32, depth=2, activation=activation)
    convert._copy_(ta.net.leaves(), convert._layers(np_tree(params)))
    obs = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    mine, theirs = HostActor(ta, ta.net.leaves()), JaxHostActor(actor, params)
    r1, r2 = (np.random.default_rng(np.random.SeedSequence([7, 0xAC7])) for _ in range(2))
    for _ in range(3):
        np.testing.assert_array_equal(mine.sample(obs, r1), theirs.sample(obs, r2))
    np.testing.assert_array_equal(mine.greedy(obs), theirs.greedy(obs))
    np.testing.assert_array_equal(host_greedy_fn(ta, ta.net.leaves())(obs[3]),
                                  jax_host_greedy_fn(actor, params)(obs[3]))
    # start_sync copies: a later change of the params reaches the actor at its refresh only
    before = mine.greedy(obs)
    for p in ta.net.leaves():
        p.mul_(0.5)
    mine.start_sync(ta.net.leaves())
    np.testing.assert_array_equal(mine.greedy(obs), before)
    mine.refresh()
    assert not np.array_equal(mine.greedy(obs), before)


def _trainer(tmp_path, name, extra):
    args = SMALL + list(extra) + ["platform=cpu"]
    return Trainer(load_config(args), out_dir=str(tmp_path / name))


def _assert_same_state(a, b):
    sa, sb = a.state_tensors(), b.state_tensors()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def _schedule(t):
    """(step, n_updates) of each host-loop iteration."""
    out, step, done = [], t.start_step, t._updates_owed(t.start_step)
    while step < t.cfg.steps:
        n = t._updates_owed(step + t.cfg.num_envs) - done
        done += n
        out.append((step, n))
        step += t.cfg.num_envs
    return out


PATHS = {
    "gail": ["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true",
             "training.fused_update_scan=true"],
    "gail_kblock4": ["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true",
                     "training.fused_update_scan=true", "training.update_block=4"],
    "pwil": ["algorithm=PWIL", "training.sac_pallas=true"],
    "adril": ["algorithm=AdRIL", "imitation.update_freq=40", "training.sac_pallas=true"],
}
RUN = ["num_envs=4", "steps=160", "training.start=32", "logging.interval=40",
       "check_time_usage=true"]


@pytest.mark.parametrize("path", list(PATHS))
def test_pipelined_loop_equals_stale_iterations(tmp_path, path):
    a = _trainer(tmp_path, "a", PATHS[path] + RUN + ["training.pipeline=true"])
    b = _trainer(tmp_path, "b", PATHS[path] + RUN)
    a._host_loop()
    params = b.sac["a"]
    env_state = b.env.reset()
    stale = [p.clone() for p in params]
    for step, n in _schedule(b):
        now = [p.clone() for p in params]  # after the previous iteration's updates
        for p, s in zip(params, stale):
            p.copy_(s)
        acted = b.act_env(env_state)  # from the params before the previous updates
        for p, s in zip(params, now):
            p.copy_(s)
        b._updates_of(step, b.front_of(step, acted, n), n)
        stale = now
    _assert_same_state(a, b)
    assert a.updates_done == (160 - 32) + 1 and a.step_done == 160
    plain = _trainer(tmp_path, "plain", PATHS[path] + RUN)
    plain._host_loop()
    assert not torch.equal(plain.sac["a"][0], a.sac["a"][0])  # the staleness shows


def test_pipelined_loop_before_start_equals_the_plain_loop(tmp_path):
    extra = PATHS["gail"] + ["num_envs=4", "steps=96", "training.start=1000",
                             "evaluation.interval=48"]
    a = _trainer(tmp_path, "a", extra + ["training.pipeline=true"])
    b = _trainer(tmp_path, "b", extra)
    a._host_loop()
    b._host_loop()
    _assert_same_state(a, b)
    for k in ("train_steps", "train_returns", "test_steps", "test_returns"):
        assert a.metrics[k] == b.metrics[k], k
    assert len(a.metrics["test_steps"]) == 2


@pytest.mark.parametrize("path", ["gail", "adril"])
def test_host_acting_equals_iterations_with_params_one_iteration_behind(tmp_path, path):
    a = _trainer(tmp_path, "a", PATHS[path] + RUN + ["training.host_acting=true"])
    b = _trainer(tmp_path, "b", PATHS[path] + RUN)
    a._host_loop()
    params = b.sac["a"]
    host = HostActor(b.actor, params)
    rng = np.random.default_rng(np.random.SeedSequence([b.cfg.seed, 0xAC7]))
    env_state = b.env.reset()
    actions = host.sample(env_state["obs"].numpy(), rng)
    for step, n in _schedule(b):
        acted = b.act_env(env_state, torch.from_numpy(actions))
        now = [p.clone() for p in params]
        b._updates_of(step, b.front_of(step, acted, n), n)
        host.start_sync(now)
        host.refresh()
        actions = host.sample(env_state["obs"].numpy(), rng)
    _assert_same_state(a, b)


# ------------------------------------------------- the schedule against iltpu


def fake_step(k, N):
    """The k-th env step's rewards and dones (k from 1), a function of k."""
    steps = k * N + np.arange(N)
    return np.sin(0.37 * steps).astype(np.float32), (k + np.arange(N)) % 5 == 0


class FakeJaxEnv:
    """iltpu's host env interface with `fake_step`'s outputs."""

    def __init__(self, N, S, first=0):
        self.N, self.S, self.k = N, S, first

    def reset(self, seed=None):
        return np.zeros((self.N, self.S), np.float32)

    def step(self, actions):
        self.k += 1
        r, d = fake_step(self.k, self.N)
        obs = np.zeros((self.N, self.S), np.float32)
        return obs, r, np.zeros(self.N, np.float32), d.astype(np.float32), obs

    def close(self):
        pass


class FakeTorchEnv:
    """The port's VecEnv interface with `fake_step`'s outputs."""

    def __init__(self, env, first=0):
        self.env, self.k = env, first
        self.N, self.S = env.num_envs, env.obs_size

    def reset(self, generator=None):
        return {"inner": {}, "t": torch.zeros(self.N, dtype=torch.int64),
                "obs": torch.zeros(self.N, self.S)}

    def step(self, state, actions):
        self.k += 1
        r, d = fake_step(self.k, self.N)
        done = torch.from_numpy(d)
        return state, {"next_obs": state["obs"].clone(), "reward": torch.from_numpy(r),
                       "terminal": torch.zeros(self.N), "timeout": done.float(), "done": done}


def stub_iltpu(jt, calls, first=0):
    """iltpu's host loop with its device programs and env stubbed."""
    N, A = jt.cfg.num_envs, jt.env.action_size
    zeros = jnp.zeros((N, A))
    jt.env = FakeJaxEnv(N, jt.env.obs_size, first)
    jt._interact = lambda p, base, step, obs: zeros
    jt._interact_packed = lambda p, base, step, packed, S: zeros

    def post_step(state, base_key, packed, n_updates):
        calls.append(n_updates)
        return state, {k: jnp.asarray(v, jnp.float32) for k, v in AUX.items()}, zeros

    jt._post_step = post_step
    jt.evaluate = lambda: [1.0, 2.0]


def stub_port(tt, calls, first=0):
    """The port's host loop with its updates and env stubbed."""
    tt.env = FakeTorchEnv(tt.env, first)

    def run_updates(step, batches, expert_batches, draws, n_updates):
        return {k: torch.tensor(v) for k, v in AUX.items()}

    real_front = tt.front_of

    def front_of(step, acted, n_updates):
        calls.append(n_updates)
        return real_front(step, acted, n_updates)

    tt.run_updates, tt.front_of = run_updates, front_of
    tt.evaluate = lambda: [1.0, 2.0]


def assert_same_metrics(tm, jm, keys=("train_steps", "update_steps", "test_steps", "alphas")):
    for key in keys:
        np.testing.assert_allclose(np.asarray(tm.get(key, []), np.float64),
                                   np.asarray(jm.get(key, []), np.float64), rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(np.asarray(tm["train_returns"]), np.asarray(jm["train_returns"]),
                               rtol=1e-5, atol=1e-5)
    assert [m[0] for m in tm.get("steady_marks", [])] == [m[0] for m in jm.get("steady_marks", [])]
    assert tm.get("steady_env_steps") == jm.get("steady_env_steps")


# (num_envs, interval, start, steps, logging, evaluation, extra)
SCHEDULES = {
    "pipeline": (4, 1, 64, 300, 40, 100, ["training.pipeline=true"]),
    "pipeline_interval2_marks": (8, 2, 100, 520, 0, 128,
                                 ["training.pipeline=true", "training.timing_skip_steps=128",
                                  "training.timing_marks=2"]),
    "host_acting": (4, 8, 0, 200, 64, 1000, ["training.host_acting=true"]),
    "host_acting_and_pipeline": (16, 1, 32, 700, 0, 50,
                                 ["training.host_acting=true", "training.pipeline=true",
                                  "check_time_usage=true"]),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_and_metrics_match_iltpu(tmp_path, name):
    N, interval, start, steps, log, ev, extra = SCHEDULES[name]
    args = SMALL + ["algorithm=SAC", f"num_envs={N}", f"training.interval={interval}",
                    f"training.start={start}", f"steps={steps}", f"logging.interval={log}",
                    f"evaluation.interval={ev}", *extra]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    calls = {"jax": [], "torch": []}
    stub_iltpu(jt, calls["jax"])
    stub_port(tt, calls["torch"])
    jt._host_loop()
    tt._host_loop()
    jt._flush_logs()
    tt._flush_logs()
    assert calls["torch"] == calls["jax"] and sum(calls["jax"]) > 0
    assert tt.step_done == jt.step_done
    assert_same_metrics(tt.metrics, jt.metrics)
    assert len(jt.metrics["train_steps"]) > 0


@pytest.mark.parametrize("flag", ["training.pipeline=true", "training.host_acting=true"])
def test_acting_flags_with_the_device_loop_take_the_device_loop(tmp_path, flag):
    t = _trainer(tmp_path, "t", PATHS["gail"] + RUN + [flag, "training.on_device_loop=true"])
    taken = []
    t._device_loop = lambda: taken.append("device")
    t._host_loop = lambda: taken.append("host")
    t._save = lambda: None
    t.run()
    assert taken == ["device"]
