"""The port's array envs (iltpu_torch/envs) against iltpu's pure-JAX ones:
PointMass2D and Pendulum steps, and VecEnv's auto-reset, absorbing bit and
terminal/timeout split, given the same states, actions and reset draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.envs import JAX_ENVS, VecEnv as JVecEnv
from iltpu_torch.envs import ENVS, VecEnv

torch.set_num_threads(1)

N = 16


def _reset_draws(name, key):
    """The uniforms behind iltpu's env.reset(key), per env."""
    if name == "pointmass":
        return jax.vmap(lambda k: jax.random.uniform(k, (2,)))(key)
    k12 = jax.vmap(jax.random.split)(key)
    return jax.vmap(lambda ks: jnp.stack([jax.random.uniform(ks[0], ()), jax.random.uniform(ks[1], ())]))(k12)


def _inner_to_torch(name, inner):
    if name == "pointmass":
        return {"pos": torch.from_numpy(np.array(inner.pos)), "vel": torch.from_numpy(np.array(inner.vel))}
    return {"theta": torch.from_numpy(np.array(inner.theta)), "theta_dot": torch.from_numpy(np.array(inner.theta_dot))}


@pytest.mark.parametrize("name", ["pointmass", "pendulum"])
@pytest.mark.parametrize("absorbing", [True, False])
def test_vecenv_steps_and_auto_reset(name, absorbing):
    jenv = JVecEnv(JAX_ENVS[name](), N, absorbing=absorbing)
    tenv = VecEnv(ENVS[name](), N, absorbing=absorbing)
    js = jenv.reset(jax.random.key(0))
    ts = {"inner": _inner_to_torch(name, js.inner), "t": torch.from_numpy(np.array(js.t)).long(),
          "obs": torch.from_numpy(np.array(js.obs))}
    jstep = jax.jit(jenv.step)
    draws_of = jax.jit(lambda key: _reset_draws(name, jax.random.split(jax.random.split(key)[1], N)))
    rng = np.random.default_rng(0)
    scale = 1.0 if name == "pointmass" else 2.5
    dones = 0
    for step in range(230):  # crosses pendulum's 200-step limit and pointmass goals
        act = (scale * np.tanh(rng.normal(size=(N, tenv.action_size)) + (-0.6 if name == "pointmass" else 0))).astype(np.float32)
        # iltpu's fresh-state draws for this step, handed to the port
        draws = torch.from_numpy(np.array(draws_of(js.key)))
        js, jout = jstep(js, jnp.asarray(act))
        ts, tout = tenv.step(ts, torch.from_numpy(act), reset_draws=draws)
        for k in ("next_obs", "reward", "terminal", "timeout", "done"):
            np.testing.assert_allclose(
                tout[k].numpy().astype(np.float32), np.asarray(getattr(jout, k), np.float32),
                rtol=1e-5, atol=1e-5, err_msg=f"{name} step {step} {k}",
            )
        np.testing.assert_allclose(ts["obs"].numpy(), np.asarray(js.obs), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(ts["t"].numpy(), np.asarray(js.t))
        # re-sync the float state so rounding cannot compound over 230 steps
        ts["inner"] = _inner_to_torch(name, js.inner)
        dones += int(np.asarray(jout.done).sum())
    assert dones > 0
