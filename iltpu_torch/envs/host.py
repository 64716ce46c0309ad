"""Host-side vectorised MuJoCo environments through gymnasium: the port of
`iltpu/envs/host.py` (`HostVecEnv`, `evaluate_policy`, `render_rollout`,
`save_frames_gif`).

`HostVecEnv` steps N gymnasium envs on a thread pool, with iltpu's
contract: one (N, S) float32 observation block a step, per-env
auto-reset returning the true pre-reset successor for replay and the
post-reset observation to act on, actions clipped to the space's bounds,
the absorbing indicator bit appended, and terminals excluding time-limit
truncations (flagged as timeouts). gymnasium is imported when an env is
built: without it (the GPU machine has none) `env_backend=mujoco` raises
its ImportError, as iltpu does there. `native.NativeVecEnv` has the same
contract without gymnasium.

`render_rollout` draws a greedy rollout as gymnasium's `rgb_array` frames
would show it, with neither gymnasium nor OpenGL: it steps the port's C++
stepper (whatever the trainer's `env_backend`; it is the port's gymnasium
counterpart) from gymnasium's reset draw, takes MuJoCo's abstract scene
after each step through gymnasium's camera (`envs.render`), casts the
frames in batches on a torch device (`utils.raycast`) and writes them as
iltpu does: a compressed npz (`frames`) and, given `gif_path`, a GIF
(`utils.gif`, no PIL).
"""

import concurrent.futures
import os
from typing import Optional, Tuple

import numpy as np
import torch

from iltpu_torch.envs import render
from iltpu_torch.envs.native import STATE_SIZES, NativeVecEnv
from iltpu_torch.envs.scores import SPECS, EnvSpec
from iltpu_torch.utils import gif, raycast


def _make_env(spec: EnvSpec):
    import gymnasium as gym

    return gym.make(spec.gym_id, **spec.gym_kwargs)


class HostVecEnv:
    """N synchronous MuJoCo envs behind one batched interface."""

    def __init__(self, env_name: str, num_envs: int = 1, *, absorbing: bool = True,
                 seed: int = 0):
        if env_name not in SPECS:
            raise ValueError(f"unsupported env {env_name}; one of {list(SPECS)}")
        self.env_name = env_name
        self.spec = SPECS[env_name]
        self.num_envs = num_envs
        self.absorbing = absorbing
        self._envs = [_make_env(self.spec) for _ in range(num_envs)]
        self._seed = seed
        low = self._envs[0].action_space.low.astype(np.float32)
        high = self._envs[0].action_space.high.astype(np.float32)
        self.action_low, self.action_high = low, high
        self._obs = np.zeros((num_envs, self.obs_size), np.float32)
        # mj_step releases the GIL: one contiguous chunk of envs a worker
        self._pool = None
        if num_envs > 1:
            self._workers = min(num_envs, os.cpu_count() or 2)
            self._chunks = [
                range(w * num_envs // self._workers, (w + 1) * num_envs // self._workers)
                for w in range(self._workers)
            ]
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=self._workers)

    @property
    def obs_size(self) -> int:
        return self.spec.obs_size + (1 if self.absorbing else 0)

    @property
    def action_size(self) -> int:
        return self.spec.action_size

    @property
    def max_episode_steps(self) -> int:
        return self.spec.time_limit

    def _augment(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if self.absorbing:
            obs = np.concatenate([obs, np.zeros((*obs.shape[:-1], 1), np.float32)], -1)
        return obs

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        """Reset ALL envs (env i from seed + i); returns the (N, S) block."""
        base = self._seed if seed is None else seed
        for i, env in enumerate(self._envs):
            obs, _ = env.reset(seed=base + i)
            self._obs[i] = self._augment(obs)
        self._seed = base + self.num_envs  # fresh seeds on the next full reset
        return self._obs.copy()

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Step every env; auto-resets finished ones. Returns (true_next_obs,
        rewards, terminals, timeouts, obs): the pre-reset successor (what
        replay stores) and what the policy acts on next. A timeout wins
        over a termination on the same step (the reference's train.py:157)."""
        actions = np.clip(np.asarray(actions, np.float32), self.action_low, self.action_high)
        n = self.num_envs
        next_obs = np.zeros_like(self._obs)
        rewards = np.zeros(n, np.float32)
        terminals = np.zeros(n, np.float32)
        timeouts = np.zeros(n, np.float32)

        def step_one(i):
            env = self._envs[i]
            obs, r, terminated, truncated, _ = env.step(actions[i])
            next_obs[i] = self._augment(obs)
            rewards[i] = r
            terminals[i] = float(terminated and not truncated)
            timeouts[i] = float(truncated)
            if terminated or truncated:
                obs, _ = env.reset()
                self._obs[i] = self._augment(obs)
            else:
                self._obs[i] = next_obs[i]

        def step_chunk(idx):
            for i in idx:
                step_one(i)

        if self._pool is not None:
            list(self._pool.map(step_chunk, self._chunks))  # raises a worker's exception
        else:
            for i in range(n):
                step_one(i)
        return next_obs, rewards, terminals, timeouts, self._obs.copy()

    def close(self):
        if self._pool is not None:
            # wait: a chunk may still be inside mj_step after another raised
            self._pool.shutdown(wait=True)
            self._pool = None
        for env in self._envs:
            env.close()


def evaluate_policy(env_name: str, act_fn, num_episodes: int, *, absorbing: bool = True,
                    seed: int = 0, return_trajectories: bool = False, env_cls=None):
    """Batched greedy evaluation (reference evaluation.py:11-35): all
    `num_episodes` episodes at once, one `act_fn((E, S)) -> (E, A)` call a
    step, finished episodes masked out, the returns summed in float64.
    `env_cls` is HostVecEnv by default (`native.NativeVecEnv` takes the same
    arguments). Returns the returns, and with `return_trajectories` each
    episode's states, actions, rewards and terminals (1 at its last step)."""
    env_cls = HostVecEnv if env_cls is None else env_cls
    env = env_cls(env_name, num_episodes, absorbing=absorbing, seed=seed)
    done = np.zeros(num_episodes, bool)
    returns = np.zeros(num_episodes, np.float64)
    traj = [[] for _ in range(num_episodes)] if return_trajectories else None
    try:
        obs = env.reset()
        while not done.all():
            actions = np.asarray(act_fn(obs))
            next_obs, rewards, terminals, timeouts, obs_after = env.step(actions)
            for i in range(num_episodes):
                if done[i]:
                    continue
                returns[i] += rewards[i]
                if return_trajectories:
                    traj[i].append((obs[i], actions[i], rewards[i]))
                if terminals[i] or timeouts[i]:
                    done[i] = True
            obs = obs_after
    finally:
        env.close()
    if not return_trajectories:
        return returns.tolist()
    trajectories = []
    for ep in traj:
        terms = np.zeros(len(ep), np.float32)
        terms[-1] = 1.0
        trajectories.append({
            "states": np.stack([t[0] for t in ep]),
            "actions": np.stack([t[1] for t in ep]),
            "rewards": np.asarray([t[2] for t in ep], np.float32),
            "terminals": terms,
        })
    return returns.tolist(), trajectories


def rollout_scenes(env_name: str, act_fn, *, absorbing: bool = True, seed: int = 0,
                   max_frames: int = 500):
    """The scenes of iltpu's `render_rollout` loop and the model's textures.
    gymnasium's `env.reset(seed=seed)` state set on one stepper env (auto-reset
    off), then per frame: the greedy action on the (absorbing-augmented)
    observation, one step, the scene after it through gymnasium's camera
    (built after the first step, as gymnasium's viewer is), and a stop on
    termination or truncation, the last state still drawn."""
    env = NativeVecEnv(env_name, 1, absorbing=absorbing, seed=seed)
    try:
        env.set_auto_reset(False)
        env.reset()
        qpos, qvel = render.reset_state(env_name, seed, env.qpos0(), STATE_SIZES[env_name][1])
        env.set_state(0, qpos, qvel)
        obs = env.observation(0)
        scenes, camera = [], None
        for _ in range(max_frames):
            action = np.asarray(act_fn(obs[None]))[0]
            next_obs, _, terminals, timeouts, _ = env.step(action[None])
            if camera is None:
                camera = render.camera(env_name, env.geom_xpos(0))
            scenes.append(env.scene(0, camera))
            obs = next_obs[0]
            if terminals[0] or timeouts[0]:
                break
        return scenes, env.textures()
    finally:
        env.close()


def render_rollout(env_name: str, act_fn, out_path: str, *, absorbing: bool = True, seed: int = 0,
                   max_frames: int = 500, gif_path: str = None, fps: int = 30, device="cuda") -> int:
    """Greedy rollout with (N, 480, 480, 3) uint8 frames, saved as a
    compressed npz (key `frames`) and, given `gif_path`, an animated GIF
    (iltpu's `render_rollout`). The frames are cast on `device`, 16 at a
    time on the card, 4 on the CPU (less memory: each batch holds
    tensors of batch x 230,400 rays). Returns the number of frames written."""
    scenes, textures = rollout_scenes(env_name, act_fn, absorbing=absorbing, seed=seed,
                                      max_frames=max_frames)
    device = torch.device(device)
    frames = raycast.render_scenes(scenes, textures, width=render.WIDTH, height=render.HEIGHT,
                                   device=device, batch=16 if device.type == "cuda" else 4)
    np.savez_compressed(out_path, frames=frames)
    if gif_path:
        save_frames_gif(frames, gif_path, fps=fps)
    return len(frames)


def save_frames_gif(frames: np.ndarray, gif_path: str, fps: int = 30) -> None:
    """Write an (N, H, W, 3) uint8 frame stack as an animated GIF (iltpu's
    `save_frames_gif`: one image a frame, a delay of max(1000 // fps, 10) ms,
    looping forever), with the port's own palette and coder."""
    gif.save_frames_gif(frames, gif_path, fps=fps)
