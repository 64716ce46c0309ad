"""PWIL, the greedy Wasserstein ("nofill") reward: the port of
`iltpu/rewards/pwil.py`.

The expert atoms (states, or states and actions unless `state_only`) are
normalised by the dataset's statistics, (x - mean) / std, with a feature of
zero std taking scale 1. Each env owns a pool of atom masses, 1/N each. An
agent atom of mass 1/T - 1e-6 (T the env's episode length) is transported
greedily onto the nearest atoms with mass left, and its reward is
reward_scale * exp(-bandwidth * cost), bandwidth = reward_bandwidth_scale *
T / sqrt(dim). A pool is refilled where its env's episode ends.

The transport is `ops.pwil_transport`: one kernel launch for every env's
step (or for the whole expert relabelling), its plain version on the CPU.
On the card the kernel reads the atoms feature-major; that copy is made
once, here.

What keeps the port on iltpu's numbers:
- `jnp.std` is the population std: `torch.std(..., correction=0)`;
- 1/T - 1e-6, 1/N and the bandwidth are Python doubles in iltpu that meet
  float32 arrays as weak types: computed in double here and rounded once to
  float32 where they meet the tensors;
- `jnp.argmin` takes the first minimum, and so does the transport;
- the loop stops when the agent's weight is spent OR no atom has mass left
  (the exhausted-pool guard).

The pools are `PWILState.expert_weights`, (pools, N) float32, updated in
place.
"""

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from iltpu_torch.ops.pwil_transport import feature_major, pwil_transport


@dataclass
class PWILState:
    expert_weights: torch.Tensor  # (pools, N) float32: remaining mass per expert atom


class PWILDiscriminator:
    def __init__(
        self,
        state_size: int,
        action_size: int,
        *,
        state_only: bool = False,
        reward_scale: float = 5.0,
        reward_bandwidth_scale: float = 5.0,
        time_horizon: int = 1000,
        expert_states: torch.Tensor,
        expert_actions: torch.Tensor,
    ):
        self.state_only = state_only
        self.time_horizon = time_horizon
        atoms = expert_states if state_only else torch.cat([expert_states, expert_actions], -1)
        std = torch.std(atoms, 0, correction=0)
        self.data_scale = 1.0 / torch.where(std == 0, 1.0, std)
        self.data_offset = -torch.mean(atoms, 0)
        self.expert_atoms = self.normalise(atoms).contiguous()
        if self.expert_atoms.is_cuda:  # the kernel's (d, N) copy, made before any graph capture
            feature_major(self.expert_atoms)
        self.num_atoms = atoms.shape[0]
        dim = state_size if state_only else state_size + action_size
        self.reward_scale = float(reward_scale)
        self.reward_bandwidth = reward_bandwidth_scale * time_horizon / math.sqrt(dim)
        self.atom_weight = 1.0 / self.num_atoms
        self.agent_weight = 1.0 / time_horizon - 1e-6
        self._step_offsets: Dict[int, torch.Tensor] = {}

    def normalise(self, atoms: torch.Tensor) -> torch.Tensor:
        return self.data_scale * (atoms + self.data_offset)

    def _atoms(self, states: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        return states if self.state_only else torch.cat([states, actions], -1)

    def init(self, pools: int) -> PWILState:
        """`pools` fresh pools: mass 1/N on every expert atom."""
        dev = self.expert_atoms.device
        return PWILState(torch.full((pools, self.num_atoms), self.atom_weight, device=dev))

    reset = init

    def _transport(self, pools, queries, offsets, reset) -> torch.Tensor:
        return pwil_transport(
            self.expert_atoms, pools, queries, offsets, reset, atom_weight=self.atom_weight,
            agent_weight=self.agent_weight, bandwidth=self.reward_bandwidth, scale=self.reward_scale,
        )

    def compute_reward(
        self, carry: PWILState, states: torch.Tensor, actions: torch.Tensor,
        dones: Optional[torch.Tensor] = None,
    ) -> Tuple[PWILState, torch.Tensor]:
        """One agent atom per pool (iltpu's compute_reward vmapped over the
        pools), then the pools of `dones` refilled; in place. Returns the
        carry and the rewards (pools,)."""
        pools = carry.expert_weights
        P = pools.shape[0]
        if P not in self._step_offsets:
            self._step_offsets[P] = torch.arange(P + 1, dtype=torch.int32, device=pools.device)
        reset = torch.zeros(P, dtype=torch.bool, device=pools.device) if dones is None else dones
        queries = self.normalise(self._atoms(states, actions)).contiguous()
        return carry, self._transport(pools, queries, self._step_offsets[P], reset.contiguous())

    def relabel(self, states, actions, terminals, timeouts) -> torch.Tensor:
        """The rewards of the expert rows in order, the pool reset after
        every row that ends a trajectory (iltpu's `_pwil_relabel_expert`):
        the rows between two ends are independent, so each such segment is
        one pool of one launch. Reads the episode ends once."""
        ends = (terminals + timeouts) > 0
        stops = np.flatnonzero(ends.cpu().numpy()) + 1
        R = states.shape[0]
        bounds = [0] + [int(s) for s in stops if s < R] + [R]
        offsets = torch.tensor(bounds, dtype=torch.int32, device=states.device)
        pools = self.init(len(bounds) - 1).expert_weights
        queries = self.normalise(self._atoms(states, actions)).contiguous()
        return self._transport(pools, queries, offsets, ends.contiguous())
