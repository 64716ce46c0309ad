"""Tanh-Gaussian policy: the port of `iltpu/models/actor.py` (SoftActor).

The MLP trunk gives (mean, log_std) halves, log_std clamped to [-20, 2];
actions are tanh-squashed Gaussian samples with exact log-probs; the greedy
action is tanh(mean). The DRIL dropout ensemble is not ported yet.
"""

from typing import Optional, Tuple

import torch
from torch import nn

from iltpu_torch.models import distributions as D
from iltpu_torch.models.fcnn import MLP


class SoftActor(nn.Module):
    def __init__(
        self,
        state_size: int,
        action_size: int,
        hidden_size: int = 256,
        depth: int = 2,
        activation: str = "relu",
        *,
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
            device=device,
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.net.reset_parameters(generator)

    def dist(self, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = self.net(state).chunk(2, dim=-1)
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

    def log_prob(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        mean, log_std = self.dist(state)
        return D.log_prob_of_action(mean, log_std, action)

    def greedy_action(self, state: torch.Tensor) -> torch.Tensor:
        mean, _ = self.dist(state)
        return torch.tanh(mean)
