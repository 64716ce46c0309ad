"""Tanh-Gaussian policy: the port of `iltpu/models/actor.py` (SoftActor).

The MLP trunk gives (mean, log_std) halves, log_std clamped to [-20, 2];
actions are tanh-squashed Gaussian samples with exact log-probs; the greedy
action is tanh(mean). The same network doubles as DRIL's discriminator: a
Monte-Carlo dropout ensemble of 5 members whose action-probability variance
is the uncertainty cost, thresholded at a quantile of the expert data.

Dropout runs only in training mode (`train=True`), with keep-masks given or
drawn from a generator, as iltpu's `rng=..., train=True`. An ensemble's
masks carry a leading member axis (5, rows, width) and run as one
broadcast forward.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from iltpu_torch.models import distributions as D
from iltpu_torch.models.fcnn import MLP

DRIL_ENSEMBLE_SIZE = 5


class SoftActor(nn.Module):
    def __init__(
        self,
        state_size: int,
        action_size: int,
        hidden_size: int = 256,
        depth: int = 2,
        activation: str = "relu",
        *,
        input_dropout: float = 0.0,
        dropout: float = 0.0,
        device=None,
    ):
        super().__init__()
        self.state_size = state_size
        self.action_size = action_size
        self.net = MLP(
            state_size,
            hidden_size,
            depth,
            2 * action_size,
            activation,
            input_dropout=input_dropout,
            dropout=dropout,
            device=device,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def dist(
        self,
        state: torch.Tensor,
        *,
        params: Optional[Sequence[torch.Tensor]] = None,
        masks=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = self.net.apply(state, params, masks).chunk(2, dim=-1)
        return mean, torch.clamp(log_std, D.LOG_STD_MIN, D.LOG_STD_MAX)

    def sample(
        self,
        state: torch.Tensor,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(action, log_prob) for standard-normal noise `eps`, drawn from
        `generator` when not given."""
        mean, log_std = self.dist(state)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        z = D.sample_pretanh(mean, log_std, eps)
        return torch.tanh(z), D.log_prob_from_pretanh(mean, log_std, z)

    def log_prob(
        self,
        state: torch.Tensor,
        action: torch.Tensor,
        *,
        params: Optional[Sequence[torch.Tensor]] = None,
        masks=None,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
    ) -> torch.Tensor:
        """log pi(action | state); with `train`, through dropout with `masks`
        or masks drawn from `generator` (neither: no dropout, as iltpu
        without an rng)."""
        if not train:
            masks = None
        elif masks is None and generator is not None:
            masks = self.net.draw_masks(state.shape[:-1], generator)
        mean, log_std = self.dist(state, params=params, masks=masks)
        return D.log_prob_of_action(mean, log_std, action)

    def greedy_action(self, state: torch.Tensor) -> torch.Tensor:
        mean, _ = self.dist(state)
        return torch.tanh(mean)

    # --- DRIL MC-dropout ensemble -----------------------------------------

    def ensemble_masks(self, rows: int, generator: torch.Generator):
        """The 5 members' keep-masks for `rows` inputs, (5, rows, width) per
        layer."""
        return self.net.draw_masks((DRIL_ENSEMBLE_SIZE, rows), generator)

    @torch.no_grad()
    def action_uncertainty(
        self, state: torch.Tensor, action: torch.Tensor, masks=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Unbiased variance (ddof 1) of pi(a|s) over the 5 dropout members."""
        if masks is None:
            masks = self.ensemble_masks(state.shape[0], generator)
        probs = torch.exp(self.log_prob(state, action, masks=masks, train=True))  # (5, rows)
        return torch.var(probs, dim=0, correction=1)

    @torch.no_grad()
    def uncertainty_threshold(
        self, expert_state, expert_action, quantile_cutoff: float, masks=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The quantile of the expert data's uncertainty (linear
        interpolation, as jnp.quantile), 0-d."""
        u = self.action_uncertainty(expert_state, expert_action, masks, generator)
        return torch.quantile(u, quantile_cutoff)

    @torch.no_grad()
    def dril_reward(
        self, state, action, threshold: torch.Tensor, masks=None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """+1 where the uncertainty is at most the threshold, else -1."""
        u = self.action_uncertainty(state, action, masks, generator)
        return torch.where(u <= threshold, 1.0, -1.0)
