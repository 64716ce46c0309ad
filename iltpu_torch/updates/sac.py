"""SAC learner: the port of `iltpu/updates/sac.py`.

Holds the hyperparameters and builds the update state: actor and twin
critic parameters, a target critic copy, log_alpha, the AdamW moments and
step counts of actor and critic, and the Adam moments and count of the
temperature (`sac.py:68-101`). The state is the flat dict of tensors that
`iltpu_torch.ops.sac_update` updates in place; the actor and critic modules
share their parameter tensors with it.

Two updates work on that one state: the SAC kernel of
`iltpu_torch.ops.sac_update` (`training.sac_pallas=true`, depth-2 relu
networks) and `SACLearner.update`, the autograd update of
`training.sac_pallas=false`, for any depth and activation. It keeps iltpu's
sequence: critic step -> actor loss against the UPDATED critic ->
temperature step with the pre-update log_alpha -> Polyak, with the
absorbing masks, the min_alpha floor on the alpha that the losses use, and
the importance weights on the critic MSE and the entropy terms only.
Gradients come from `torch.autograd.grad` on detached views of the state's
leaves; the AdamW steps write the results back in place (`adamw_`, the same
formulas as the kernel's plain version), so the modules and the kernel keep
seeing the same tensors.
"""

from typing import Dict

import torch

from iltpu_torch.models import distributions as D
from iltpu_torch.models.actor import SoftActor
from iltpu_torch.models.critic import TwinCritic, polyak_update
from iltpu_torch.ops.sac_update import SACHyper, adamw_


class SACLearner:
    def __init__(
        self,
        actor: SoftActor,
        critic: TwinCritic,
        *,
        learning_rate: float = 3e-4,
        weight_decay: float = 0.0,
        discount: float = 0.99,
        entropy_target: float = -3.0,
        polyak_factor: float = 0.995,
        min_alpha: float = 0.0,
    ):
        self.actor = actor
        self.critic = critic
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.alpha_lr = learning_rate
        self.discount = discount
        self.entropy_target = entropy_target
        self.polyak_factor = polyak_factor
        self.min_alpha = min_alpha

    @property
    def hyper(self) -> SACHyper:
        return SACHyper(
            lr=self.lr,
            weight_decay=self.weight_decay,
            alpha_lr=self.alpha_lr,
            discount=self.discount,
            entropy_target=self.entropy_target,
            polyak=self.polyak_factor,
            min_alpha=self.min_alpha,
        )

    def init(self, generator: torch.Generator) -> Dict:
        self.actor.reset_parameters(generator)
        self.critic.reset_parameters(generator)
        a = self.actor.net.leaves()
        c = self.critic.leaves()
        zeros = lambda ts: [torch.zeros_like(t) for t in ts]
        one = lambda: torch.zeros(1, device=c[0].device)
        return {
            "a": a, "am": zeros(a), "av": zeros(a),
            "c": c, "cm": zeros(c), "cv": zeros(c),
            "t": [t.clone() for t in c],
            "la": one(), "lam": one(), "lav": one(),
            "ta": one(), "tc": one(), "tal": one(),
        }

    @torch.enable_grad()
    def update(
        self, st: Dict, batch: Dict[str, torch.Tensor], eps2: torch.Tensor, eps_new: torch.Tensor
    ) -> Dict[str, torch.Tensor]:
        """One SAC update of `st` in place, with the standard-normal draws
        eps2 (next actions) and eps_new (the actor loss's actions). Returns
        (log_probs, Q_values, critic_loss, actor_loss, alpha)."""
        s, a, r, s2 = batch["states"], batch["actions"], batch["rewards"], batch["next_states"]
        term, w, absorbing = batch["terminals"], batch["weights"], batch["absorbing"]
        live = 1.0 - absorbing
        alpha = torch.exp(st["la"].detach())[0]
        if self.min_alpha > 0.0:
            alpha = torch.clamp_min(alpha, self.min_alpha)

        # TD target: the pre-update actor on s', the target twin
        with torch.no_grad():
            next_mean, next_ls = self.actor.dist(s2, params=st["a"])
            z2 = D.sample_pretanh(next_mean, next_ls, eps2)
            next_lp = D.log_prob_from_pretanh(next_mean, next_ls, z2)
            next_action = live[:, None] * torch.tanh(z2)
            tq1, tq2 = self.critic(s2, next_action, params=st["t"])
            target_v = torch.minimum(tq1, tq2) - live * alpha * next_lp
            td = r + (1.0 - term) * self.discount * target_v

        # critic step
        c = [t.detach().requires_grad_() for t in st["c"]]
        q1, q2 = self.critic(s, a, params=c)
        critic_loss = torch.mean(w * (q1 - td) ** 2) + torch.mean(w * (q2 - td) ** 2)
        c_grads = torch.autograd.grad(critic_loss, c)
        min_q = torch.minimum(q1, q2).detach()
        adamw_(st["c"], c_grads, st["cm"], st["cv"], st["tc"], self.lr, self.weight_decay)

        # actor and temperature, one backward, against the UPDATED critic
        ap = [t.detach().requires_grad_() for t in st["a"]]
        log_alpha = st["la"].detach().clone().requires_grad_()
        mean, log_std = self.actor.dist(s, params=ap)
        z = D.sample_pretanh(mean, log_std, eps_new)
        log_prob = D.log_prob_from_pretanh(mean, log_std, z)
        nq1, nq2 = self.critic(s, torch.tanh(z), params=[t.detach() for t in st["c"]])
        actor_loss = torch.mean(w * live * alpha * log_prob - torch.minimum(nq1, nq2))
        lp = log_prob.detach()
        alpha_loss = -torch.mean(w * live * torch.exp(log_alpha)[0] * (lp + self.entropy_target))
        *a_grads, la_grad = torch.autograd.grad(actor_loss + alpha_loss, ap + [log_alpha])
        adamw_(st["a"], a_grads, st["am"], st["av"], st["ta"], self.lr, self.weight_decay)
        adamw_([st["la"]], [la_grad], [st["lam"]], [st["lav"]], st["tal"], self.alpha_lr, 0.0)

        polyak_update(st["c"], st["t"], self.polyak_factor)
        return {
            "log_probs": lp, "Q_values": min_q, "critic_loss": critic_loss.detach(),
            "actor_loss": actor_loss.detach(), "alpha": alpha,
        }
