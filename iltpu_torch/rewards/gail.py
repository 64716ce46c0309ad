"""GAIL/AIRL/FAIRL discriminator: the port of `iltpu/rewards/gail.py`.

An MLP over (state, action) with optional spectral norm on every layer, and
the GAIL -log(1-D), AIRL log D - log(1-D) and FAIRL e^h (-h) reward heads
with their 1e-6 guard. As in iltpu (and its reference), the discriminator
takes no dropout, although the GAIL config carries dropout keys. AIRL
reward shaping, subtracting log pi and state-only input are not ported yet
(ROADMAP.md, 'GAIL options').

Its state (see ops.gail_update) is shared by both updates: the GAIL kernel
and the autograd `updates.adversarial.adversarial_imitation_update`.
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
        device=None,
    ):
        super().__init__()
        assert reward_function in ("AIRL", "FAIRL", "GAIL")
        todo = [
            name
            for name, on in (
                ("state_only", state_only),
                ("reward_shaping", reward_shaping),
                ("subtract_log_policy", subtract_log_policy),
            )
            if on
        ]
        if todo:
            raise NotImplementedError(
                f"GAILDiscriminator {', '.join(todo)} is not ported yet: "
                "ROADMAP.md, 'GAIL options'"
            )
        self.reward_function = reward_function
        self.g = MLP(
            state_size + action_size, hidden_size, depth, 1, activation,
            spectral_norm=spectral_norm, device=device,
        )

    def init(self, generator: torch.Generator) -> Dict:
        """Fresh parameters and the update state (see ops.gail_update)."""
        self.g.reset_parameters(generator)
        p = self.g.leaves()
        sn = self.g.sn_vectors()
        zeros = lambda ts: [torch.zeros_like(t) for t in ts]
        return {
            "p": p, "sn": sn, "m": zeros(p), "v": zeros(p),
            "t": torch.zeros(1, device=p[0].device),
            "snm": zeros(sn), "snv": zeros(sn),
        }

    def forward(
        self, state: torch.Tensor, action: torch.Tensor,
        params: Optional[Sequence[torch.Tensor]] = None,
        sn: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Discriminator logit f, with the leaves `params` and spectral-norm
        vectors `sn` (the module's own, which its `init` state shares, when
        None)."""
        return self.g.apply(torch.cat([state, action], dim=-1), params, sn=sn)[..., 0]

    @torch.no_grad()
    def predict_reward(self, state: torch.Tensor, action: torch.Tensor,
                       st: Optional[Dict] = None) -> torch.Tensor:
        """The reward head on the logits of state `st` (the module's own
        when None)."""
        f = self.forward(state, action) if st is None else self.forward(state, action, st["p"], st["sn"])
        return reward_head(f, self.reward_function)

    def update_sn(self, st: Dict) -> None:
        """One power iteration on every layer of state `st`, in place (a
        no-op without spectral norm); once per optimisation step."""
        if self.g.spectral_norm:
            self.g.update_spectral_norm(st["p"], st["sn"])
