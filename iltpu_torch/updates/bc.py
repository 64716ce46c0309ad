"""Behavioural-cloning update: the port of `iltpu/updates/bc.py`.

Weighted maximum likelihood, loss = mean(w * -log pi(a_E | s_E)), with the
expert actions clamped into (-1, 1) inside `log_prob_of_action`. Used for
BC pretraining, DRIL's ensemble pretraining (with dropout) and the per-update
BC auxiliary loss, which steps the SAC actor's own AdamW state.

The optimised state is a dict of lists of tensors, updated in place:
  p: the actor's parameter leaves, m, v: their AdamW moments,
  t: the (1,) step clock.
For the SAC actor, `actor_opt_state` gives that view of the SAC state, so
BC's step lands in the very tensors the SAC kernel reads next.
"""

from typing import Dict, Optional

import torch

from iltpu_torch.models.actor import SoftActor
from iltpu_torch.ops.sac_update import adamw_


def actor_opt_state(sac_state: Dict) -> Dict:
    """The SAC actor's parameters, AdamW moments and clock, as the same
    tensors (no copy)."""
    return {"p": sac_state["a"], "m": sac_state["am"], "v": sac_state["av"], "t": sac_state["ta"]}


@torch.enable_grad()
def behavioural_cloning_update(
    actor: SoftActor,
    opt_state: Dict,
    expert_transitions: Dict[str, torch.Tensor],
    *,
    lr: float,
    weight_decay: float,
    masks=None,
    generator: Optional[torch.Generator] = None,
    train_dropout: bool = False,
) -> torch.Tensor:
    """One AdamW step of `opt_state` in place; returns the loss. With
    `train_dropout`, the actor's dropout runs with `masks` or masks drawn
    from `generator` (DRIL's pretraining)."""
    s, a, w = expert_transitions["states"], expert_transitions["actions"], expert_transitions["weights"]
    params = [t.detach().requires_grad_() for t in opt_state["p"]]
    lp = actor.log_prob(s, a, params=params, masks=masks, generator=generator, train=train_dropout)
    loss = torch.mean(w * -lp)
    grads = torch.autograd.grad(loss, params)
    adamw_(opt_state["p"], grads, opt_state["m"], opt_state["v"], opt_state["t"], lr, weight_decay)
    return loss.detach()
