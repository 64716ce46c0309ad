"""The port's on-device loop (`training.on_device_loop`,
`Trainer._device_loop` in iltpu_torch/trainer.py) against iltpu's
(`iltpu/trainer.py:1639-1762`): the chunk schedule (power-of-two chunks,
clipped at training.start and at the end, num_envs // interval updates an
iteration past the start) and the metrics built from each chunk's rewards,
dones and last aux, with the chunk itself stubbed on both trainer instances
so nothing compiles; the loop on the CPU, bit for bit, against the same
iterations driven one by one through `Trainer.iteration`. On the card,
tests/test_torch_cuda.py holds a chunk replayed from CUDA graphs against
the same chunk run eagerly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.config import load_config as jax_load_config
from iltpu.trainer import Trainer as JaxTrainer
from iltpu_torch.config import load_config
from iltpu_torch.trainer import Trainer

torch.set_num_threads(1)

SMALL = [
    "env=pointmass", "env_backend=jax", "memory.size=1000", "imitation.trajectories=4",
    "training.batch_size=16", "reinforcement.actor.hidden_size=16",
    "reinforcement.critic.hidden_size=16", "evaluation.episodes=1",
    "training.on_device_loop=true",
]

# (num_envs, interval, start, steps, logging, evaluation, extra)
SCHEDULES = {
    "start64": (4, 1, 64, 300, 40, 100, []),
    "interval2_marks": (8, 2, 100, 520, 0, 128,
                        ["training.timing_skip_steps=128", "training.timing_marks=2"]),
    "interval_past_envs": (4, 8, 0, 200, 64, 1000, []),
    "check_time_usage": (16, 1, 32, 700, 0, 50, ["check_time_usage=true"]),
    "checkpointing": (4, 1, 64, 300, 40, 100, ["checkpointing.interval=96"]),
}

AUX = {"predicted_rewards": [0.5, 0.25], "alphas": 0.1, "entropies": [0.0, 1.0],
       "Q_values": [2.0, 3.0], "diag_num_trajectories": 3.0}


def _fake_chunk(start, n_iters, N):
    """Rewards and dones of a chunk, a function of the env steps it covers."""
    steps = start + N * np.arange(1, n_iters + 1)[:, None] + np.arange(N)[None]
    return np.sin(0.37 * steps).astype(np.float32), (steps // N + np.arange(N)) % 5 == 0


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_and_metrics_match_iltpu(tmp_path, name):
    N, interval, start, steps, log, ev, extra = SCHEDULES[name]
    args = SMALL + ["algorithm=SAC", f"num_envs={N}", f"training.interval={interval}",
                    f"training.start={start}", f"steps={steps}", f"logging.interval={log}",
                    f"evaluation.interval={ev}", *extra]
    jt = JaxTrainer(jax_load_config(args), out_dir=str(tmp_path / "jax"))
    tt = Trainer(load_config(args + ["platform=cpu"]), out_dir=str(tmp_path / "torch"))
    calls = {"jax": [], "torch": []}

    def scan_chunk(state, env_state, base_key, start_step, n_iters, updates_per_iter):
        calls["jax"].append((int(start_step), n_iters, updates_per_iter))
        r, d = _fake_chunk(int(start_step), n_iters, N)
        return state, env_state, jnp.asarray(r), jnp.asarray(d), {
            k: jnp.asarray(v, jnp.float32) for k, v in AUX.items()}

    def run_chunk(env_state, step, n_iters, upi):
        calls["torch"].append((step, n_iters, upi))
        r, d = _fake_chunk(step, n_iters, N)
        return torch.from_numpy(r), torch.from_numpy(d), {k: torch.tensor(v) for k, v in AUX.items()}

    jt._scan_chunk, tt.run_chunk = scan_chunk, run_chunk
    jt.evaluate = tt.evaluate = lambda: [1.0, 2.0]
    checks = {"jax": [], "torch": []}
    jt._checkpoint = lambda step: checks["jax"].append(step)
    tt._checkpoint = lambda step, updates_done: checks["torch"].append(step)
    jt._device_loop()
    tt._device_loop()
    assert checks["torch"] == checks["jax"]
    assert bool(checks["jax"]) == (name == "checkpointing")
    jt._flush_logs()
    tt._flush_logs()
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) > 2
    assert {upi for _, _, upi in calls["jax"]} == ({0} if start else set()) | {max(N // interval, 1)}
    assert tt.step_done == jt.step_done
    jm, tm = jt.metrics, tt.metrics
    for key in ("train_steps", "update_steps", "test_steps", "alphas", "predicted_rewards",
                "diag_num_trajectories"):
        np.testing.assert_allclose(np.asarray(tm.get(key, []), np.float64),
                                   np.asarray(jm.get(key, []), np.float64), rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(np.asarray(tm["train_returns"]), np.asarray(jm["train_returns"]),
                               rtol=1e-5, atol=1e-5)
    assert len(jm["train_steps"]) > 0
    assert [m[0] for m in tm.get("steady_marks", [])] == [m[0] for m in jm.get("steady_marks", [])]
    assert tm.get("steady_env_steps") == jm.get("steady_env_steps")


PATHS = {
    "gail_kblock4": ["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true",
                     "training.fused_update_scan=true", "training.update_block=4"],
    "pwil": ["algorithm=PWIL", "training.sac_pallas=true"],
    "adril": ["algorithm=AdRIL", "imitation.update_freq=40", "training.sac_pallas=true"],
    "gmmil": ["algorithm=GMMIL"],
}


@pytest.mark.parametrize("path", list(PATHS))
def test_device_loop_equals_iterations_one_by_one(tmp_path, path):
    """Two trainers from one seed: one runs the on-device loop on the CPU,
    the other the same iterations through `iteration`; every state tensor
    and the generator end equal."""
    args = SMALL + PATHS[path] + ["num_envs=4", "steps=160", "training.start=32",
                                  "logging.interval=40", "check_time_usage=true", "platform=cpu"]
    a = Trainer(load_config(args), out_dir=str(tmp_path / "a"))
    b = Trainer(load_config(args), out_dir=str(tmp_path / "b"))
    calls, run_chunk = [], a.run_chunk

    def recording(env_state, step, n_iters, upi):
        calls.append((step, n_iters, upi))
        return run_chunk(env_state, step, n_iters, upi)

    a.run_chunk = recording
    a._device_loop()
    env_state = b.env.reset()
    for step, n_iters, upi in calls:
        for i in range(n_iters):
            b.iteration(env_state, step + i * 4, upi)
    assert len(calls) > 2 and calls[-1][2] == 4
    sa, sb = a.state_tensors(), b.state_tensors()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert a.updates_done == 4 * (160 - 32) // 4
