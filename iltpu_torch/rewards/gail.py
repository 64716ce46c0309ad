"""GAIL/AIRL/FAIRL discriminator: the port of `iltpu/rewards/gail.py`.

An MLP g over (state, action), or the state alone (`state_only`), with
optional spectral norm on every layer, and the GAIL -log(1-D), AIRL
log D - log(1-D) and FAIRL e^h (-h) reward heads with their 1e-6 guard. As
in iltpu (and its reference), the discriminator takes no dropout, although
the GAIL config carries dropout keys. The input options:

- AIRL reward shaping: g is a depth-0 linear head and h the shaping MLP
  over the state, and the logit is g + (1 - terminal)(discount h(s') - h(s));
- subtracting log pi: the logit less the actor's log-probability of the
  row, a constant that the caller computes (under no grad).

Its state (see ops.gail_update) is shared by both updates: the GAIL kernel
and the autograd `updates.adversarial.adversarial_imitation_update`. With
shaping, `p` holds g's leaves then h's (`ng` of them are g's) and `sn` their
power-iteration vectors in the same order; the kernel takes none of the
options (the trainer refuses them with `training.disc_pallas=true`, as
iltpu does).
"""

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from iltpu_torch.models.fcnn import MLP
from iltpu_torch.ops.gail_update import reward_head


class GAILDiscriminator(nn.Module):
    def __init__(
        self,
        state_size: int,
        action_size: int,
        *,
        state_only: bool = False,
        reward_shaping: bool = False,
        subtract_log_policy: bool = False,
        reward_function: str = "GAIL",
        hidden_size: int = 64,
        depth: int = 1,
        activation: str = "relu",
        spectral_norm: bool = False,
        discount: float = 0.99,
        device=None,
    ):
        super().__init__()
        assert reward_function in ("AIRL", "FAIRL", "GAIL")
        self.state_only = state_only
        self.reward_shaping = reward_shaping
        self.subtract_log_policy = subtract_log_policy
        self.reward_function = reward_function
        self.discount = discount
        in_size = state_size if state_only else state_size + action_size
        mlp = lambda n_in, d: MLP(n_in, hidden_size, d, 1, activation,
                                  spectral_norm=spectral_norm, device=device)
        self.g = mlp(in_size, 0 if reward_shaping else depth)
        self.h = mlp(state_size, depth) if reward_shaping else None
        self.ng = 2 * self.g.n_layers  # g's leaves in the state's `p`

    def nets(self):
        return (self.g,) if self.h is None else (self.g, self.h)

    def init(self, generator: torch.Generator) -> Dict:
        """Fresh parameters and the update state (see ops.gail_update)."""
        p, sn = [], []
        for net in self.nets():
            net.reset_parameters(generator)
            p += net.leaves()
            sn += net.sn_vectors()
        zeros = lambda ts: [torch.zeros_like(t) for t in ts]
        st = {
            "p": p, "sn": sn, "m": zeros(p), "v": zeros(p),
            "t": torch.zeros(1, device=p[0].device),
            "snm": zeros(sn), "snv": zeros(sn),
        }
        if self.h is not None:
            st["ng"] = self.ng
        return st

    def forward(
        self, state: torch.Tensor, action: torch.Tensor,
        params: Optional[Sequence[torch.Tensor]] = None,
        sn: Optional[Sequence[torch.Tensor]] = None,
        next_state: Optional[torch.Tensor] = None,
        terminal: Optional[torch.Tensor] = None,
        log_policy: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Discriminator logit f, with the leaves `params` and spectral-norm
        vectors `sn` (the modules' own, which its `init` state shares, when
        None); `next_state` and `terminal` with shaping, `log_policy` when
        subtracting log pi."""
        ng = self.ng
        gp, hp = (None, None) if params is None else (params[:ng], params[ng:])
        gs, hs = (None, None) if not sn else (sn[:ng], sn[ng:])
        x = state if self.state_only else torch.cat([state, action], dim=-1)
        f = self.g.apply(x, gp, sn=gs)[..., 0]
        if self.h is not None:
            h = lambda s: self.h.apply(s, hp, sn=hs)[..., 0]
            f = f + (1.0 - terminal) * (self.discount * h(next_state) - h(state))
        if self.subtract_log_policy:
            f = f - log_policy
        return f

    @torch.no_grad()
    def predict_reward(self, state: torch.Tensor, action: torch.Tensor,
                       st: Optional[Dict] = None, next_state=None, terminal=None,
                       log_policy=None) -> torch.Tensor:
        """The reward head on the logits of state `st` (the module's own
        when None)."""
        p, sn = (None, None) if st is None else (st["p"], st["sn"])
        return reward_head(self.forward(state, action, p, sn, next_state, terminal, log_policy),
                           self.reward_function)

    def update_sn(self, st: Dict) -> None:
        """One power iteration on every layer of state `st`, in place (a
        no-op without spectral norm); once per optimisation step."""
        if self.g.spectral_norm:
            ng = self.ng
            self.g.update_spectral_norm(st["p"][:ng], st["sn"][:ng])
            if self.h is not None:
                self.h.update_spectral_norm(st["p"][ng:], st["sn"][ng:])
