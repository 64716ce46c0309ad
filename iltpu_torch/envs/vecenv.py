"""Vectorised array env: the port of `VecEnv` from `iltpu/envs/jaxenv.py`.

N envs step together on the device: actions clipped to the env's bounds,
per-env auto-reset to a fresh initial state when an episode ends, the
reference's terminal/timeout split (a time-limit end is a timeout, and
wins over a termination on the same step), and the DAC absorbing
indicator bit appended to observations.
"""

from typing import Dict, Optional, Tuple

import torch

from iltpu_torch.envs.classic import ENVS


class VecEnv:
    def __init__(self, env, num_envs: int, *, absorbing: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        self.env = env
        self.num_envs = num_envs
        self.absorbing = absorbing
        self.device = device
        self.generator = generator

    @property
    def obs_size(self) -> int:
        return self.env.obs_size + (1 if self.absorbing else 0)

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def max_episode_steps(self) -> int:
        return self.env.max_episode_steps

    def _augment(self, obs: torch.Tensor) -> torch.Tensor:
        if self.absorbing:
            obs = torch.cat([obs, torch.zeros_like(obs[:, :1])], -1)
        return obs

    def _draw(self) -> torch.Tensor:
        shape = (self.num_envs, self.env.reset_draws)
        return torch.rand(shape, generator=self.generator, device=self.device)

    def reset(self) -> Dict:
        inner, obs = self.env.reset_from(self._draw())
        t = torch.zeros(self.num_envs, dtype=torch.int64, device=obs.device)
        return {"inner": inner, "t": t, "obs": self._augment(obs)}

    def step(self, state: Dict, action: torch.Tensor, reset_draws: Optional[torch.Tensor] = None
             ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """One step of every env. `reset_draws` injects the uniforms of the
        fresh states that replace finished episodes."""
        action = torch.clamp(action, self.env.action_low, self.env.action_high)
        inner, obs, reward, terminated = self.env.step(state["inner"], action)
        t = state["t"] + 1
        timeout = t >= self.env.max_episode_steps
        terminal = terminated & ~timeout
        done = terminated | timeout
        fresh_inner, fresh_obs = self.env.reset_from(
            self._draw() if reset_draws is None else reset_draws
        )
        pick = lambda new, old: torch.where(done.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
        next_inner = {k: pick(fresh_inner[k], inner[k]) for k in inner}
        new_state = {
            "inner": next_inner,
            "t": torch.where(done, 0, t),
            "obs": self._augment(pick(fresh_obs, obs)),
        }
        out = {
            "next_obs": self._augment(obs),
            "reward": reward,
            "terminal": terminal.float(),
            "timeout": timeout.float(),
            "done": done,
        }
        return new_state, out


def make_env(name: str, num_envs: int, *, absorbing: bool, device=None,
             generator: Optional[torch.Generator] = None) -> VecEnv:
    if name not in ENVS:
        raise NotImplementedError(
            f"env {name!r} has no array version in the port (pointmass, pendulum); "
            "the MuJoCo envs wait for MuJoCo in the repository: ROADMAP.md, "
            "'Native hopper env'"
        )
    return VecEnv(ENVS[name](), num_envs, absorbing=absorbing, device=device, generator=generator)
