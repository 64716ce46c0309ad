"""SAC learner: the port of `iltpu/updates/sac.py`.

Holds the hyperparameters and builds the update state: actor and twin
critic parameters, a target critic copy, log_alpha, the AdamW moments and
step counts of actor and critic, and the Adam moments and count of the
temperature (`sac.py:68-101`). The state is the flat dict of tensors that
`iltpu_torch.ops.sac_update` updates in place; the actor and critic modules
share their parameter tensors with it.

The update itself is `iltpu_torch.ops.sac_update` (the kernel path,
`training.sac_pallas=true`); the autograd update of the `sac_pallas=false`
path is not ported yet (ROADMAP.md, 'Autograd updates').
"""

from typing import Dict

import torch

from iltpu_torch.models.actor import SoftActor
from iltpu_torch.models.critic import TwinCritic
from iltpu_torch.ops.sac_update import SACHyper


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
