"""Twin Q-networks: the port of `iltpu/models/critic.py`.

The two critics are held as ONE set of (2, ...)-stacked parameters, as in
iltpu, so both run as batched products and convert leaf for leaf. Any
depth and activation; the SAC kernel takes depth 2 with relu.
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from iltpu_torch.models.fcnn import _ACTIVATIONS, _GAINS, orthogonal


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
        assert activation in _ACTIVATIONS, f"unsupported activation {activation}"
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
        self, state: torch.Tensor, action: torch.Tensor,
        params: Optional[Sequence[torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both critics on the rows [state, action] -> (q1, q2), with the
        stacked leaves `params` (the module's own when None)."""
        if params is None:
            params = [p for wb in zip(self.weights, self.biases) for p in wb]
        act = _ACTIVATIONS[self.activation]
        h = torch.cat([state, action], dim=-1)
        n = len(params) // 2
        for k in range(n):
            h = torch.matmul(h, params[2 * k]) + params[2 * k + 1][:, None, :]
            if k < n - 1:
                h = act(h)
        return h[0, :, 0], h[1, :, 0]


@torch.no_grad()
def polyak_update(params: List[torch.Tensor], target: List[torch.Tensor], polyak_factor: float) -> None:
    """target <- rho * target + (1 - rho) * online, in place (multi-tensor
    ops, the same formula per element)."""
    torch._foreach_mul_(target, polyak_factor)
    torch._foreach_add_(target, torch._foreach_mul(params, 1.0 - polyak_factor))
