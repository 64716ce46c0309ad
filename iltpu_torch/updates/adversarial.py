"""Adversarial (GAIL/AIRL/FAIRL) discriminator update in autograd: the port
of `iltpu/updates/adversarial.py`, the `training.disc_pallas=false` path.

- Losses: weighted BCE; nn-PUGAIL, positive-unlabelled with a class prior
  and the non-negative margin clamp; Mixup on convex combinations of expert
  and policy rows with the draw `mix` (Beta(alpha, alpha); the trainer
  takes alpha 1, a uniform draw).
- Gradient penalty: the squared L2 norm of the logit's input gradient at
  `eps_gp`-interpolated (state, action) rows, weighted by the interpolated
  importance weights, through `torch.autograd.grad(..., create_graph=True)`
  (second order through spectral norm, with u and v held constant).
- Entropy bonus: maximise the Bernoulli(logits=D) entropy.
- One AdamW step on the discriminator's leaves, then one spectral-norm
  power iteration.

The state is the GAIL kernel's (`ops.gail_update`), updated in place, so
both GAIL paths share it. The reward comes afterwards from the UPDATED
discriminator (`GAILDiscriminator.predict_reward`), as iltpu's trainer takes
it.
"""

from typing import Dict, NamedTuple, Optional

import torch

from iltpu_torch.models.distributions import softplus
from iltpu_torch.ops.sac_update import adamw_
from iltpu_torch.rewards.gail import GAILDiscriminator

LOSS_FUNCTIONS = ("BCE", "PUGAIL", "Mixup")


class AdversarialConfig(NamedTuple):
    loss_function: str = "BCE"
    grad_penalty: float = 1.0
    entropy_bonus: float = 0.0
    pos_class_prior: float = 0.7
    nonnegative_margin: float = float("inf")
    learning_rate: float = 3e-5
    weight_decay: float = 10.0


def _bce_with_logits(logits: torch.Tensor, target) -> torch.Tensor:
    """softplus(-x) + (1 - z) x, per element."""
    return softplus(-logits) + (1.0 - target) * logits


def _bernoulli_entropy(logits: torch.Tensor) -> torch.Tensor:
    p = torch.sigmoid(logits)
    return p * softplus(-logits) + (1.0 - p) * softplus(logits)


def _mix(x1: torch.Tensor, x2: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    m = eps[:, None] if x1.dim() == 2 else eps
    return m * x1 + (1.0 - m) * x2


@torch.enable_grad()
def adversarial_imitation_update(
    disc: GAILDiscriminator,
    st: Dict,
    transitions: Dict[str, torch.Tensor],
    expert_transitions: Dict[str, torch.Tensor],
    cfg: AdversarialConfig,
    eps_gp: torch.Tensor,
    mix: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One discriminator step of `st` in place; returns the loss (0-d).
    `mix` is the Mixup draw, given exactly when the loss is Mixup."""
    if cfg.loss_function not in LOSS_FUNCTIONS:
        raise ValueError(f"unknown loss_function {cfg.loss_function}")
    if (mix is None) == (cfg.loss_function == "Mixup"):
        raise ValueError("mix must be given exactly for the Mixup loss")
    e_s, e_a, e_w = (expert_transitions[k] for k in ("states", "actions", "weights"))
    p_s, p_a, p_w = (transitions[k] for k in ("states", "actions", "weights"))
    B = p_s.shape[0]
    params = [t.detach().requires_grad_() for t in st["p"]]

    def logits(s, a):
        return disc.forward(s, a, params, st["sn"])

    if cfg.loss_function == "Mixup":
        m_w = _mix(e_w, p_w, mix)
        d_m = logits(_mix(e_s, p_s, mix), _mix(e_a, p_a, mix))
        loss = torch.mean(mix * m_w * _bce_with_logits(d_m, 1.0)
                          + (1.0 - mix) * m_w * _bce_with_logits(d_m, 0.0))
        entropy_terms = [(d_m, m_w)]
    else:
        d = logits(torch.cat([e_s, p_s]), torch.cat([e_a, p_a]))
        d_e, d_p = d[:B], d[B:]
        if cfg.loss_function == "BCE":
            expert_loss = torch.mean(e_w * _bce_with_logits(d_e, 1.0))
            policy_loss = torch.mean(p_w * _bce_with_logits(d_p, 0.0))
        else:  # nn-PUGAIL
            prior = cfg.pos_class_prior
            expert_loss = prior * torch.mean(e_w * _bce_with_logits(d_e, 1.0))
            policy_loss = torch.clamp(
                prior * torch.mean(e_w * _bce_with_logits(d_e, 0.0))
                - torch.mean(p_w * _bce_with_logits(d_p, 0.0)),
                min=-cfg.nonnegative_margin,
            )
        loss = expert_loss + policy_loss
        entropy_terms = [(d_e, e_w), (d_p, p_w)]

    if cfg.grad_penalty > 0:
        g_s = _mix(e_s, p_s, eps_gp).requires_grad_()
        g_a = _mix(e_a, p_a, eps_gp).requires_grad_()
        gs, ga = torch.autograd.grad(logits(g_s, g_a).sum(), (g_s, g_a), create_graph=True)
        sq_norms = (gs**2).sum(-1) + (ga**2).sum(-1)
        loss = loss + cfg.grad_penalty * torch.mean(_mix(e_w, p_w, eps_gp) * sq_norms)

    if cfg.entropy_bonus > 0:
        loss = loss - cfg.entropy_bonus * torch.mean(
            sum(w * _bernoulli_entropy(d) for d, w in entropy_terms))

    grads = torch.autograd.grad(loss, params)
    adamw_(st["p"], grads, st["m"], st["v"], st["t"], cfg.learning_rate, cfg.weight_decay)
    disc.update_sn(st)
    return loss.detach()
