"""GMMIL, the non-parametric MMD-witness reward: the port of
`iltpu/rewards/gmmil.py`.

reward = (weighted kernel similarity to the expert batch) - (weighted
self-similarity), summed over two Gaussian bandwidths that the first call
sets by the weighted-median heuristic (agent<->expert and expert<->expert
medians) and later calls keep. The reward goes through the row-sum kernel
(`ops.gaussian_rowsum`), as iltpu's does on its accelerator.

The carry holds the bandwidths and the `initialized` flag as tensors on the
device. The host never reads the flag: a fresh carry (or one loaded from
elsewhere) is marked `settled=False`, and its first call computes the
median bandwidths and keeps the old ones where the device flag says so;
every carry a call returns is settled, since its flag is then true.
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from iltpu_torch.ops.gaussian_rowsum import gmmil_witness_reward
from iltpu_torch.ops.pairwise import squared_distance, weighted_median


@dataclass
class GMMILState:
    gamma_1: torch.Tensor  # 0-d float32
    gamma_2: torch.Tensor  # 0-d float32
    initialized: torch.Tensor  # 0-d bool
    settled: bool = False  # host side: `initialized` is known to be true


class GMMILDiscriminator:
    def __init__(self, state_size: int, action_size: int, *, state_only: bool = False):
        self.state_only = state_only

    def init(self, device=None) -> GMMILState:
        return GMMILState(
            gamma_1=torch.ones((), device=device),
            gamma_2=torch.ones((), device=device),
            initialized=torch.zeros((), dtype=torch.bool, device=device),
        )

    def _atoms(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return state if self.state_only else torch.cat([state, action], -1)

    def predict_reward(
        self, carry: GMMILState, state, action, expert_state, expert_action, weight, expert_weight
    ) -> Tuple[GMMILState, torch.Tensor]:
        sa = self._atoms(state, action)
        esa = self._atoms(expert_state, expert_action)
        g1, g2 = carry.gamma_1, carry.gamma_2
        if not carry.settled:
            m1 = weighted_median(squared_distance(sa, esa), torch.outer(weight, expert_weight))
            m2 = weighted_median(squared_distance(esa, esa), torch.outer(expert_weight, expert_weight))
            g1 = torch.where(carry.initialized, g1, 1.0 / (m1 + 1e-8))
            g2 = torch.where(carry.initialized, g2, 1.0 / (m2 + 1e-8))
        new = GMMILState(g1, g2, torch.ones_like(carry.initialized), settled=True)
        return new, gmmil_witness_reward(sa, esa, weight, expert_weight, g1, g2)
