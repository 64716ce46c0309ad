"""Expert/agent batch mixing: the port of `iltpu/rewards/mixing.py`."""

from typing import Dict

import torch


def select_rows(is_expert_row: torch.Tensor, expert: Dict, agent: Dict) -> Dict:
    """Each column of `agent` with the rows where `is_expert_row` holds
    taken from `expert`."""
    out = {}
    for key, x in agent.items():
        mask = is_expert_row[:, None] if x.dim() == 2 else is_expert_row
        out[key] = torch.where(mask, expert[key], x)
    return out


def mix_expert_agent_transitions(transitions: Dict, expert_transitions: Dict) -> Dict:
    """The first half of the batch replaced with expert rows."""
    B = transitions["rewards"].shape[0]
    is_expert_row = torch.arange(B, device=transitions["rewards"].device) < B // 2
    return select_rows(is_expert_row, expert_transitions, transitions)
