"""The plain reference of DRIL's reward model: float32 PyTorch, no autograd,
no kernel, the formulas written out.

  the 5 members' forwards of one dropout MLP (one keep-mask set a member,
  `bc.forward` broadcasting the rows) -> pi(a | s) = exp(log pi), the
  tanh-Gaussian of `bc.log_prob` at the clamped expert or policy action
  -> each row's variance over the members (ddof 1) -> +1 where it is at
  most the threshold, else -1; the threshold: the quantile of the expert
  rows' variances, linearly interpolated between order statistics.

It imports nothing of the program.
"""

import math
from typing import Sequence

import torch

from portbench.reference import bc as ref_bc


def uncertainty(params: Sequence[torch.Tensor], states, actions, masks, rates,
                activation: str) -> torch.Tensor:
    """(rows,) variance over the members of pi(a | s), with `masks[k]` of
    shape (members, rows, width) or None."""
    out, _ = ref_bc.forward(params, states, activation, masks, rates)
    probs = torch.exp(ref_bc.log_prob(out, ref_bc.clamped_atanh(actions)))  # (members, rows)
    n = probs.shape[0]
    mean = probs.sum(0) / n
    d = probs - mean
    return (d * d).sum(0) / (n - 1)


def quantile(u: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of `u`, linear between the order statistics around
    position q (n - 1)."""
    s, _ = torch.sort(u)
    pos = q * (s.shape[0] - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, s.shape[0] - 1)
    return s[lo] + (pos - lo) * (s[hi] - s[lo])


def reward(u: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    return torch.where(u <= threshold, 1.0, -1.0)
