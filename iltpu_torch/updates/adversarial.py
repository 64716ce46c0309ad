"""Adversarial (GAIL/AIRL/FAIRL) discriminator update in autograd: the port
of `iltpu/updates/adversarial.py`, the `training.disc_pallas=false` path.

- Losses: weighted BCE; nn-PUGAIL, positive-unlabelled with a class prior
  and the non-negative margin clamp; Mixup on convex combinations of expert
  and policy rows (their next states, terminals, weights and log pi too)
  with the draw `mix` (Beta(alpha, alpha); a uniform draw at alpha 1).
- The discriminator's input options (`rewards.gail`): the rows' next
  states and terminals feed the shaping term; `log_pi(s, a)` gives the
  actor's log-probabilities that the logit subtracts, constants here.
- Gradient penalty: the squared L2 norm of the logit's input gradient at
  `eps_gp`-interpolated (state, action) rows, weighted by the interpolated
  importance weights, through `torch.autograd.grad(..., create_graph=True)`
  (second order through spectral norm, with u and v held constant); the
  interpolated next states, terminals and log pi are held constant.
- Entropy bonus: maximise the Bernoulli(logits=D) entropy.
- One AdamW step on the discriminator's leaves, then one spectral-norm
  power iteration.

Under data parallel (`mesh`) the rows and draws given are this rank's
shard, and the step's gradients and loss go through one `allreduce_mean_`
before AdamW. Every term is a plain mean over rows but nn-PUGAIL's clamp,
which is not linear in its two means: those are all-reduced first (a
second `allreduce_mean_`), and the clamp decides on the whole batch's
value, so the gradient follows the global branch.

The state is the GAIL kernel's (`ops.gail_update`), updated in place, so
both GAIL paths share it. The reward comes afterwards from the UPDATED
discriminator (`GAILDiscriminator.predict_reward`), as iltpu's trainer takes
it.
"""

from typing import Callable, Dict, NamedTuple, Optional

import torch

from iltpu_torch.models.distributions import softplus
from iltpu_torch.ops.sac_update import adamw_
from iltpu_torch.parallel.data import DataMesh, allreduce_mean_
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


def _mix(x1: Optional[torch.Tensor], x2: Optional[torch.Tensor], eps: torch.Tensor):
    if x1 is None:
        return None
    m = eps[:, None] if x1.dim() == 2 else eps
    return m * x1 + (1.0 - m) * x2


def _cat(x1: Optional[torch.Tensor], x2: Optional[torch.Tensor]):
    return None if x1 is None else torch.cat([x1, x2])


def _clamp_min(x: torch.Tensor, value: torch.Tensor, lo: float) -> torch.Tensor:
    """`clamp(value, min=lo)`, with `x`'s gradient where `value >= lo` (as
    clamp passes it) and none elsewhere: nn-PUGAIL's clamp, whose branch
    the whole batch's `value` picks while this rank's `x` carries the
    gradient. With `value` x's own, it is `torch.clamp(x, min=lo)`."""
    return torch.where(value >= lo, x - x.detach() + value, torch.full_like(value, lo))


@torch.enable_grad()
def adversarial_imitation_update(
    disc: GAILDiscriminator,
    st: Dict,
    transitions: Dict[str, torch.Tensor],
    expert_transitions: Dict[str, torch.Tensor],
    cfg: AdversarialConfig,
    eps_gp: torch.Tensor,
    mix: Optional[torch.Tensor] = None,
    log_pi: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    mesh: Optional[DataMesh] = None,
) -> torch.Tensor:
    """One discriminator step of `st` in place; returns the loss (0-d), of
    the whole batch under `mesh`. `mix` is the Mixup draw, given exactly
    when the loss is Mixup; `log_pi` the actor's log-probability, given
    exactly when the discriminator subtracts it."""
    if cfg.loss_function not in LOSS_FUNCTIONS:
        raise ValueError(f"unknown loss_function {cfg.loss_function}")
    if (mix is None) == (cfg.loss_function == "Mixup"):
        raise ValueError("mix must be given exactly for the Mixup loss")
    if (log_pi is None) == disc.subtract_log_policy:
        raise ValueError("log_pi must be given exactly when the discriminator subtracts log pi")

    def cols(d):  # the next states and terminals only where the shaping term reads them
        shaped = ("next_states", "terminals") if disc.reward_shaping else ()
        return [d[k] for k in ("states", "actions", "weights")] + [
            d[k] if k in shaped else None for k in ("next_states", "terminals")]

    e_s, e_a, e_w, e_s2, e_term = cols(expert_transitions)
    p_s, p_a, p_w, p_s2, p_term = cols(transitions)
    B = p_s.shape[0]
    params = [t.detach().requires_grad_() for t in st["p"]]

    def lp(s, a):
        if log_pi is None:
            return None
        with torch.no_grad():
            return log_pi(s, a)

    def logits(s, a, s2, term, lpi):
        return disc.forward(s, a, params, st["sn"], s2, term, lpi)

    if cfg.loss_function == "Mixup":
        m_s, m_a = _mix(e_s, p_s, mix), _mix(e_a, p_a, mix)
        m_w = _mix(e_w, p_w, mix)
        d_m = logits(m_s, m_a, _mix(e_s2, p_s2, mix), _mix(e_term, p_term, mix), lp(m_s, m_a))
        loss = torch.mean(mix * m_w * _bce_with_logits(d_m, 1.0)
                          + (1.0 - mix) * m_w * _bce_with_logits(d_m, 0.0))
        entropy_terms = [(d_m, m_w)]
    else:
        lp_e, lp_p = lp(e_s, e_a), lp(p_s, p_a)
        d = logits(torch.cat([e_s, p_s]), torch.cat([e_a, p_a]), _cat(e_s2, p_s2),
                   _cat(e_term, p_term), _cat(lp_e, lp_p))
        d_e, d_p = d[:B], d[B:]
        if cfg.loss_function == "BCE":
            expert_loss = torch.mean(e_w * _bce_with_logits(d_e, 1.0))
            policy_loss = torch.mean(p_w * _bce_with_logits(d_p, 0.0))
        else:  # nn-PUGAIL
            prior = cfg.pos_class_prior
            expert_loss = prior * torch.mean(e_w * _bce_with_logits(d_e, 1.0))
            m_e = torch.mean(e_w * _bce_with_logits(d_e, 0.0))
            m_p = torch.mean(p_w * _bce_with_logits(d_p, 0.0))
            mine = prior * m_e - m_p
            value = mine.detach()
            if mesh is not None:  # the whole batch's value
                whole = allreduce_mean_([torch.stack([m_e, m_p]).detach()], mesh)[0]
                value = prior * whole[0] - whole[1]
            policy_loss = _clamp_min(mine, value, -cfg.nonnegative_margin)
        loss = expert_loss + policy_loss
        entropy_terms = [(d_e, e_w), (d_p, p_w)]

    # Both backwards run on this thread. On CUDA the engine would run the
    # penalty's double backward on its device thread, which numbers the nodes
    # it creates from a counter of its own; the engine orders ready nodes by
    # those numbers, so the order in which the first layer's gradient sums
    # its contributions (and so its last bits) would depend on both threads'
    # history: a process's first step differed from its later ones. On one
    # thread the order depends on this step alone.
    with torch.autograd.set_multithreading_enabled(False):
        if cfg.grad_penalty > 0:
            g_s = _mix(e_s, p_s, eps_gp)
            g_a = _mix(e_a, p_a, eps_gp)
            g_s2, g_term = _mix(e_s2, p_s2, eps_gp), _mix(e_term, p_term, eps_gp)
            lp_g = lp(g_s, g_a)
            g_s, g_a = g_s.requires_grad_(), g_a.requires_grad_()
            f = logits(g_s, g_a, g_s2, g_term, lp_g).sum()
            # state-only: the logit does not read the action, whose gradient is 0
            gs, ga = torch.autograd.grad(f, (g_s, g_a), create_graph=True, allow_unused=True)
            sq_norms = (gs**2).sum(-1) + (0.0 if ga is None else (ga**2).sum(-1))
            loss = loss + cfg.grad_penalty * torch.mean(_mix(e_w, p_w, eps_gp) * sq_norms)

        if cfg.entropy_bonus > 0:
            loss = loss - cfg.entropy_bonus * torch.mean(
                sum(w * _bernoulli_entropy(d) for d, w in entropy_terms))

        grads = torch.autograd.grad(loss, params)
    loss = loss.detach()
    if mesh is not None:
        allreduce_mean_([*grads, loss], mesh)
    adamw_(st["p"], grads, st["m"], st["v"], st["t"], cfg.learning_rate, cfg.weight_decay)
    disc.update_sn(st)
    return loss
