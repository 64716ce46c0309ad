"""Analytic array environments: the port of `iltpu/envs/classic.py`, batched
over a leading env dimension and living on the device.

Each env keeps its state as a dict of (N, ...) tensors. `reset(n,
generator)` draws n initial states; `reset_from(u)` builds them from given
uniform draws, so a test can hand across another implementation's draws.
"""

import math
from typing import Dict, Tuple

import torch

State = Dict[str, torch.Tensor]


class Pendulum:
    """Classic torque-limited swing-up; no termination (timeout-only env)."""

    obs_size = 3
    action_size = 1
    action_low = -2.0
    action_high = 2.0
    max_episode_steps = 200
    ref_min_score = -1200.0
    ref_max_score = -130.0
    reset_draws = 2  # uniforms per env

    g, m, l, dt = 10.0, 1.0, 1.0, 0.05
    max_speed = 8.0

    def reset_from(self, u: torch.Tensor) -> Tuple[State, torch.Tensor]:
        """u (N, 2) uniform on [0, 1) -> theta in [-pi, pi), theta_dot in [-1, 1)."""
        state = {
            "theta": -math.pi + 2.0 * math.pi * u[:, 0],
            "theta_dot": -1.0 + 2.0 * u[:, 1],
        }
        return state, self._obs(state)

    def _obs(self, s: State) -> torch.Tensor:
        return torch.stack([torch.cos(s["theta"]), torch.sin(s["theta"]), s["theta_dot"]], -1)

    def step(self, s: State, action: torch.Tensor):
        u = torch.clamp(action[:, 0], self.action_low, self.action_high)
        th, thd = s["theta"], s["theta_dot"]
        angle = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = angle**2 + 0.1 * thd**2 + 0.001 * u**2
        thd = thd + (
            3 * self.g / (2 * self.l) * torch.sin(th) + 3.0 / (self.m * self.l**2) * u
        ) * self.dt
        thd = torch.clamp(thd, -self.max_speed, self.max_speed)
        new = {"theta": th + thd * self.dt, "theta_dot": thd}
        return new, self._obs(new), -cost, torch.zeros_like(cost, dtype=torch.bool)


class PointMass2D:
    """Velocity-damped point mass steering to the origin; terminates inside
    the goal radius, so true terminals and absorbing wrapping occur."""

    obs_size = 4
    action_size = 2
    action_low = -1.0
    action_high = 1.0
    max_episode_steps = 100
    ref_min_score = -80.0
    ref_max_score = 5.0
    reset_draws = 2

    dt, damping, goal_radius = 0.1, 0.95, 0.1

    def reset_from(self, u: torch.Tensor) -> Tuple[State, torch.Tensor]:
        """u (N, 2) uniform on [0, 1) -> position uniform on [-1, 1)^2, at rest."""
        state = {"pos": -1.0 + 2.0 * u, "vel": torch.zeros_like(u)}
        return state, self._obs(state)

    def _obs(self, s: State) -> torch.Tensor:
        return torch.cat([s["pos"], s["vel"]], -1)

    def step(self, s: State, action: torch.Tensor):
        a = torch.clamp(action, self.action_low, self.action_high)
        vel = self.damping * s["vel"] + a * self.dt
        pos = s["pos"] + vel * self.dt
        new = {"pos": pos, "vel": vel}
        dist = torch.linalg.vector_norm(pos, dim=-1)
        terminated = dist < self.goal_radius
        reward = -dist + torch.where(terminated, 10.0, 0.0)
        return new, self._obs(new), reward, terminated


ENVS = {"pendulum": Pendulum, "pointmass": PointMass2D}
