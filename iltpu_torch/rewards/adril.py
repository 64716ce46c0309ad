"""AdRIL / SQIL reward relabelling: the port of `iltpu/rewards/adril.py`.

- Balanced mode: whole batches alternate between pure expert and pure
  policy data (the flip is a 0-d bool tensor carried by the caller);
  unbalanced: the first half of the batch is replaced with expert data.
- AdRIL (update_freq > 0): expert reward 1/|expert trajectories|; policy
  reward 0 for the current round and -1/max(|trajectories|, 1) for stale
  rounds, round = ceil(step / update_freq) against the stored step column.
- SQIL (update_freq == 0): +1 expert, 0 policy.

A masked select per column; nothing is read back to the host.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from iltpu_torch.rewards.mixing import select_rows


def init_relabeller(device=None) -> torch.Tensor:
    """The balanced-mode flip: the first batch is the expert's."""
    return torch.ones((), dtype=torch.bool, device=device)


def round_of(step: int, update_freq: int) -> float:
    """ceil(step / update_freq) with the division in float32, as iltpu
    computes it (a host number: no copy to the device)."""
    return float(np.ceil(np.float32(step) / np.float32(update_freq)))


def resample_and_relabel(
    sample_expert: torch.Tensor,
    transitions: Dict[str, torch.Tensor],
    expert_transitions: Dict[str, torch.Tensor],
    step: int,
    num_trajectories: torch.Tensor,
    num_expert_trajectories: torch.Tensor,
    *,
    update_freq: int,
    balanced: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(the next flip, the relabelled batch)."""
    B = transitions["rewards"].shape[0]
    dev = transitions["rewards"].device
    if balanced:
        is_expert_row = sample_expert.expand(B)
        flip = ~sample_expert
    else:
        is_expert_row = torch.arange(B, device=dev) < B // 2
        flip = sample_expert
    out = select_rows(is_expert_row, expert_transitions, transitions)
    if update_freq > 0:  # AdRIL
        expert_reward = 1.0 / num_expert_trajectories.float()
        stale = round_of(step, update_freq) > torch.ceil(out["step"] / update_freq)
        policy_reward = -stale.float() / torch.clamp_min(num_trajectories.float(), 1.0)
    else:  # SQIL
        expert_reward = torch.ones((), device=dev)
        policy_reward = torch.zeros(B, device=dev)
    out["rewards"] = torch.where(is_expert_row, expert_reward, policy_reward)
    return flip, out

