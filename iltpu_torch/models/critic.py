"""Twin Q-networks: the port of `iltpu/models/critic.py`.

The two critics are held as ONE set of (2, ...)-stacked parameters, as in
iltpu, so both run as batched products and convert leaf for leaf.
"""

from typing import List, Tuple

import torch
from torch import nn

from iltpu_torch.models.fcnn import _GAINS, orthogonal


class TwinCritic(nn.Module):
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
        assert activation == "relu", "the port's critic supports relu only"
        self.activation = activation
        self.depth = depth
        self.dims = (state_size + action_size, *([hidden_size] * depth), 1)
        pairs = list(zip(self.dims[:-1], self.dims[1:]))
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.zeros(2, i, o, device=device)) for i, o in pairs]
        )
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.zeros(2, o, device=device)) for _, o in pairs]
        )

    def leaves(self) -> List[torch.Tensor]:
        """[W1, b1, W2, b2, ...], each (2, ...)-stacked: the parameter
        tensors themselves."""
        out = []
        for w, b in zip(self.weights, self.biases):
            out += [w.data, b.data]
        return out

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        n = len(self.weights)
        for twin in range(2):
            for k, w in enumerate(self.weights):
                gain = 1.0 if k == n - 1 else _GAINS[self.activation]
                w[twin].copy_(orthogonal(w.shape[1:], gain, generator, w.device))
        for b in self.biases:
            b.zero_()

    def forward(
        self, state: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both critics on the rows [state, action] -> (q1, q2)."""
        h = torch.cat([state, action], dim=-1)
        n = len(self.weights)
        for k in range(n):
            h = torch.matmul(h, self.weights[k]) + self.biases[k][:, None, :]
            if k < n - 1:
                h = torch.relu(h)
        return h[0, :, 0], h[1, :, 0]


@torch.no_grad()
def polyak_update(params: List[torch.Tensor], target: List[torch.Tensor], polyak_factor: float) -> None:
    """target <- rho * target + (1 - rho) * online, in place."""
    for t, p in zip(target, params):
        t.copy_(polyak_factor * t + (1.0 - polyak_factor) * p)
