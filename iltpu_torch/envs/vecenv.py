"""The trainer's envs: the array env (the port of `VecEnv` from
`iltpu/envs/jaxenv.py`) and `HostEnv`, the same contract over a MuJoCo env
stepped on the host.

`VecEnv`: N envs step together on the device: actions clipped to the env's
bounds, per-env auto-reset to a fresh initial state when an episode ends,
the reference's terminal/timeout split (a time-limit end is a timeout, and
wins over a termination on the same step), and the DAC absorbing
indicator bit appended to observations.

`HostEnv` wraps a host env (`native.NativeVecEnv`, the C++ stepper, or
gymnasium's `host.HostVecEnv`), which has the same semantics on the host.
`make_env` builds either by `env_backend`, as iltpu's `_make_env`.
"""

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from iltpu_torch.envs.classic import ENVS
from iltpu_torch.utils.spans import WAIT_ACTIONS, WAIT_BLOCK


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

    def _draw(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shape = (self.num_envs, self.env.reset_draws)
        return torch.rand(shape, generator=generator or self.generator, device=self.device)

    def reset(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Fresh initial states, drawn from `generator` (the env's own when
        None)."""
        inner, obs = self.env.reset_from(self._draw(generator))
        t = torch.zeros(self.num_envs, dtype=torch.int64, device=obs.device)
        return {"inner": inner, "t": t, "obs": self._augment(obs)}

    def step(self, state: Dict, action: torch.Tensor, reset_draws: Optional[torch.Tensor] = None
             ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """One step of every env, `state` updated in place (and returned).
        `reset_draws` injects the uniforms of the fresh states that replace
        finished episodes."""
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
        for k in inner:
            state["inner"][k].copy_(pick(fresh_inner[k], inner[k]))
        state["t"].copy_(torch.where(done, 0, t))
        state["obs"].copy_(self._augment(pick(fresh_obs, obs)))
        out = {
            "next_obs": self._augment(obs),
            "reward": reward,
            "terminal": terminal.float(),
            "timeout": timeout.float(),
            "done": done,
        }
        return state, out


class HostEnv:
    """A host env (`NativeVecEnv` or `HostVecEnv`) behind `VecEnv`'s
    contract: `reset()` -> a state dict and `step(state, actions)` ->
    (state, out), `state["obs"]` updated in place and `out` holding
    `next_obs`, `reward`, `terminal`, `timeout` and `done` on the device.

    A step makes one copy of the actions to the host (float32; none when
    they are given as a numpy array, as host acting gives them), one C
    call, and one copy to the device of one pinned block packed as iltpu
    packs it (`iltpu/trainer.py:1537-1548`: obs, actions, reward,
    next_obs, terminal, timeout, obs_after; the step column, which the
    trainer writes on the device, left out). `out` also holds the
    observations acted on and the actions as the block's columns, and
    under "host" the rewards, dones and next observations to act on as
    the numpy arrays the env returned, which the host reads without a copy
    back from the device.

    Host envs are seeded with an int, as iltpu seeds them: `reset` starts
    every env from `seed` (iltpu's `self.env.reset(cfg.seed)`), and the
    torch generator that `VecEnv.reset` takes is ignored.

    `spans`, the trainer's span recorder when it is on (`utils.spans`),
    takes each step as an `env_step` span and each wait on an event in it
    as a `wait` span.
    """

    def __init__(self, env, device=None, seed: int = 0):
        self.env, self.seed = env, seed
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.num_envs = env.num_envs
        self.obs = None  # the observations to act on, on the host
        S, A = env.obs_size, env.action_size
        edges = np.cumsum([0, S, A, 1, S, 1, 1, S])
        names = ("obs", "actions", "reward", "next_obs", "terminal", "timeout", "obs_after")
        self._cols = {k: slice(int(a), int(b)) for k, a, b in zip(names, edges, edges[1:])}
        self._width = int(edges[-1])
        self._turn = 0
        self._blocks = [None, None]  # two pinned blocks on the card, each with its copy's event
        self._actions = None  # the pinned actions on the card
        self.spans = None

    @property
    def obs_size(self) -> int:
        return self.env.obs_size

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def max_episode_steps(self) -> int:
        return self.env.max_episode_steps

    def reset(self, generator: Optional[torch.Generator] = None) -> Dict:
        """Every env from `seed`, whatever the generator."""
        self.obs = self.env.reset(self.seed)
        return {"obs": torch.from_numpy(self.obs).to(self.device)}

    def fetch(self, actions: torch.Tensor):
        """Begin copying device actions to the host; `step` takes what this
        returns (and waits for it)."""
        if self.device.type != "cuda":
            return actions.to(torch.float32).numpy().copy(), None
        if self._actions is None:
            self._actions = torch.empty(actions.shape, dtype=torch.float32, pin_memory=True)
        buf = self._actions
        buf.copy_(actions, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    def _block(self) -> torch.Tensor:
        """A block to pack into: pinned on the card (the other of two, once
        its last copy to the device is done), fresh on the CPU."""
        if self.device.type != "cuda":
            return torch.empty((self.num_envs, self._width))
        self._turn ^= 1
        if self._blocks[self._turn] is None:
            buf = torch.empty((self.num_envs, self._width), pin_memory=True)
            self._blocks[self._turn] = [buf, None]
        buf, event = self._blocks[self._turn]
        if event is not None:
            sp = self.spans
            if sp is not None:
                sp.begin("wait", WAIT_BLOCK)
            event.synchronize()
            if sp is not None:
                sp.end()
        return buf

    def step(self, state: Dict, actions) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """One step of every env; `actions` on the device, a numpy array, or
        what `fetch` returned."""
        sp = self.spans
        if sp is not None:
            sp.begin("env_step", self.num_envs, sp.acting)
        if isinstance(actions, torch.Tensor):
            actions = self.fetch(actions)
        if isinstance(actions, tuple):
            buf, event = actions
            if event is not None:
                if sp is not None:
                    sp.begin("wait", WAIT_ACTIONS)
                event.synchronize()
                if sp is not None:
                    sp.end()
            actions = buf.numpy() if isinstance(buf, torch.Tensor) else buf
        actions = np.asarray(actions, np.float32)
        next_obs, rewards, terminals, timeouts, obs_after = self.env.step(actions)
        block = self._block()
        np.concatenate([self.obs, actions, rewards[:, None], next_obs, terminals[:, None],
                        timeouts[:, None], obs_after], axis=1, out=block.numpy())
        if self.device.type == "cuda":
            dev = block.to(self.device, non_blocking=True)
            self._blocks[self._turn][1] = torch.cuda.Event()
            self._blocks[self._turn][1].record()
        else:
            dev = block
        c = self._cols
        out = {k: dev[:, c[k]] for k in ("obs", "actions", "next_obs")}
        out.update({k: dev[:, c[k].start] for k in ("reward", "terminal", "timeout")})
        out["done"] = (out["terminal"] + out["timeout"]) > 0
        state["obs"].copy_(dev[:, c["obs_after"]])
        out["host"] = {"reward": rewards, "done": (terminals + timeouts) > 0, "obs": obs_after}
        self.obs = obs_after
        if sp is not None:
            sp.end()
        return state, out

    def close(self):
        self.env.close()


BACKENDS = ("jax", "native", "auto", "mujoco")


class ArrayHostEnv:
    """An array env (`VecEnv`) behind the host envs' API, as iltpu's
    `_JaxEnvAdapter` (`iltpu/trainer.py:77-112`): `reset(seed)` -> the
    observations and `step(actions)` -> (next_obs, rewards, terminals,
    timeouts, obs_after), numpy arrays in and out, the env on `device`.
    `reset(seed)` reseeds the torch generator that draws the initial states
    and every auto-reset (with the env's own seed where `seed` is falsy, as
    iltpu's `seed or self._seed`), so its draws are the port's own, not
    JAX's."""

    def __init__(self, name: str, num_envs: int, *, absorbing: bool, seed: int, device=None):
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.generator = torch.Generator(self.device)
        self.venv = make_env(name, num_envs, absorbing=absorbing, device=self.device,
                             generator=self.generator)
        self.num_envs, self._seed, self._state = num_envs, seed, None
        self.ref_min_score = self.venv.env.ref_min_score
        self.ref_max_score = self.venv.env.ref_max_score

    obs_size = property(lambda self: self.venv.obs_size)
    action_size = property(lambda self: self.venv.action_size)
    max_episode_steps = property(lambda self: self.venv.max_episode_steps)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        self.generator.manual_seed(seed or self._seed)
        self._state = self.venv.reset()
        return self._state["obs"].to("cpu", copy=True).numpy()

    def step(self, actions):
        a = torch.as_tensor(np.asarray(actions, np.float32), device=self.device)
        self._state, out = self.venv.step(self._state, a)
        return tuple(t.to("cpu", copy=True).numpy() for t in (
            out["next_obs"], out["reward"], out["terminal"], out["timeout"], self._state["obs"]))

    def close(self):
        pass


def host_env(name: str, num_envs: int, *, absorbing: bool, seed: int, backend: str, device=None):
    """iltpu's `_make_env`: `native` builds the C++ stepper (raising where
    it cannot), `auto` takes it where it builds and gymnasium's envs
    otherwise (with a warning), `mujoco` takes gymnasium's; `jax` the array
    env on `device` behind the same API (`ArrayHostEnv`)."""
    from iltpu_torch.envs.host import HostVecEnv

    if backend == "jax":
        return ArrayHostEnv(name, num_envs, absorbing=absorbing, seed=seed, device=device)
    if backend in ("native", "auto"):
        from iltpu_torch.envs import native

        try:
            native.ensure_built()
        except (OSError, RuntimeError) as e:
            if backend == "native":
                raise
            warnings.warn(f"env_backend=auto: the native stepper did not build ({e}); "
                          "stepping gymnasium's envs instead")
        else:
            return native.NativeVecEnv(name, num_envs, absorbing=absorbing, seed=seed)
    return HostVecEnv(name, num_envs, absorbing=absorbing, seed=seed)


def make_env(name: str, num_envs: int, *, absorbing: bool, device=None,
             generator: Optional[torch.Generator] = None, backend: str = "jax", seed: int = 0):
    """The env of `env_backend` `backend`: the array env on the device for
    `jax` (drawing from `generator`), else a `HostEnv` seeded with `seed`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown env_backend {backend!r}: one of {BACKENDS}")
    if backend != "jax":
        return HostEnv(host_env(name, num_envs, absorbing=absorbing, seed=seed, backend=backend),
                       device, seed)
    if name not in ENVS:
        raise NotImplementedError(
            f"env {name!r} has no array version in the port (pointmass, pendulum): "
            "env_backend=native, auto or mujoco steps the MuJoCo envs on the host")
    return VecEnv(ENVS[name](), num_envs, absorbing=absorbing, device=device, generator=generator)
