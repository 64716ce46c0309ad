"""RED pretraining: the port of `iltpu/updates/red.py`. The predictor
regresses onto the frozen target, loss = mean(w * mean_d (pred - target)^2);
only the predictor's leaves take the AdamW step, in place."""

from typing import Dict, Optional

import torch

from iltpu_torch.ops.sac_update import adamw_
from iltpu_torch.rewards.red import REDDiscriminator


@torch.enable_grad()
def target_estimation_update(
    red: REDDiscriminator,
    st: Dict,
    expert_transitions: Dict[str, torch.Tensor],
    *,
    lr: float,
    weight_decay: float,
    masks=None,
    generator: Optional[torch.Generator] = None,
    train_dropout: bool = True,
) -> torch.Tensor:
    """One step of the predictor in place; returns the loss."""
    s, a, w = expert_transitions["states"], expert_transitions["actions"], expert_transitions["weights"]
    params = [t.detach().requires_grad_() for t in st["p"]]
    pred, tgt = red.forward(st, s, a, params=params, masks=masks, generator=generator,
                            train=train_dropout)
    loss = torch.mean(w * torch.mean((pred - tgt) ** 2, -1))
    grads = torch.autograd.grad(loss, params)
    adamw_(st["p"], grads, st["m"], st["v"], st["t"], lr, weight_decay)
    return loss.detach()
