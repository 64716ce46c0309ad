"""Fully-connected networks: the port of `iltpu/models/fcnn.py`.

The same parameter layout: each layer's weight `w` is (in, out) and a layer
computes `h @ w + b`, so parameters convert to and from iltpu's pytrees as
they are and the kernels read the same layout. Orthogonal init with the
activation's gain and zero bias; optional spectral normalisation of every
layer, dividing `w` by sigma = v^T w u with the power-iteration vectors
u (out,) and v (in,) held fixed, and refreshed by `update_spectral_norm`
once per optimisation step. Optional input and hidden dropout (DRIL's and
RED's), with inverted scaling: the input mask before the first layer, the
hidden mask of layer k between its linear map and its activation, as iltpu
keys them with `fold_in(rng, 0)` and `fold_in(rng, k + 1)`. A forward takes
keep-masks, which `draw_masks` draws from a generator.

`apply` takes explicit parameter leaves, so an update can differentiate
with `torch.autograd.grad` with respect to detached views of its state.
"""

from typing import List, Optional, Sequence

import torch
from torch import nn

_ACTIVATIONS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}

# torch.nn.init.calculate_gain values for the supported activations.
_GAINS = {"relu": 2.0**0.5, "tanh": 5.0 / 3.0, "sigmoid": 1.0}


def orthogonal(
    shape: Sequence[int], gain: float, generator: torch.Generator, device=None
) -> torch.Tensor:
    """(rows, cols) matrix with orthonormal columns (rows >= cols) or rows
    (rows < cols), scaled by gain; the sign-corrected QR of a Gaussian, as
    jax.nn.initializers.orthogonal draws it."""
    rows, cols = shape
    big, small = max(rows, cols), min(rows, cols)
    a = torch.randn((big, small), generator=generator, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.T
    return (gain * q).contiguous()


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + 1e-12)


def spectral_sigma(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sigma = v^T w u, v in R^in, u in R^out, w (in, out)."""
    return v @ w @ u


class MLP(nn.Module):
    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        depth: int,
        output_size: int,
        activation: str = "relu",
        final_gain: float = 1.0,
        spectral_norm: bool = False,
        *,
        input_dropout: float = 0.0,
        dropout: float = 0.0,
        device=None,
    ):
        super().__init__()
        assert activation in _ACTIVATIONS, f"unsupported activation {activation}"
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.depth = depth
        self.output_size = output_size
        self.activation = activation
        self.input_dropout = input_dropout
        self.dropout = dropout
        self.final_gain = final_gain
        self.spectral_norm = spectral_norm
        self.dims = (input_size, *([hidden_size] * depth), output_size)
        pairs = list(zip(self.dims[:-1], self.dims[1:]))
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.zeros(i, o, device=device)) for i, o in pairs]
        )
        self.biases = nn.ParameterList(
            [nn.Parameter(torch.zeros(o, device=device)) for _, o in pairs]
        )
        if spectral_norm:
            for k, (i, o) in enumerate(pairs):
                self.register_buffer(f"u{k}", torch.zeros(o, device=device))
                self.register_buffer(f"v{k}", torch.zeros(i, device=device))

    @property
    def n_layers(self) -> int:
        return len(self.weights)

    def leaves(self) -> List[torch.Tensor]:
        """[W1, b1, W2, b2, ...], the parameter tensors themselves."""
        out = []
        for w, b in zip(self.weights, self.biases):
            out += [w.data, b.data]
        return out

    def sn_vectors(self) -> List[torch.Tensor]:
        """[u0, v0, u1, v1, ...] (empty without spectral norm)."""
        if not self.spectral_norm:
            return []
        out = []
        for k in range(self.n_layers):
            out += [getattr(self, f"u{k}"), getattr(self, f"v{k}")]
        return out

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        n = self.n_layers
        for k in range(n):
            w = self.weights[k]
            gain = self.final_gain if k == n - 1 else _GAINS[self.activation]
            w.copy_(orthogonal(w.shape, gain, generator, w.device))
            self.biases[k].zero_()
            if self.spectral_norm:
                # one power iteration from a random unit vector, as iltpu
                u = _unit(torch.randn(w.shape[1], generator=generator, device=w.device))
                v = _unit(w @ u)
                getattr(self, f"u{k}").copy_(_unit(w.T @ v))
                getattr(self, f"v{k}").copy_(v)

    def params(self) -> List[torch.Tensor]:
        """[W1, b1, W2, b2, ...] as the module's Parameters (tracked by
        autograd, unlike `leaves`)."""
        return [p for wb in zip(self.weights, self.biases) for p in wb]

    def effective_weight(self, k: int, w: Optional[torch.Tensor] = None,
                         sn: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Layer k's weight (`w`, else the module's), divided by sigma with
        the vectors of `sn` = [u0, v0, u1, v1, ...] (else the module's),
        held constant."""
        w = self.weights[k] if w is None else w
        if self.spectral_norm:
            u, v = (getattr(self, f"u{k}"), getattr(self, f"v{k}")) if sn is None else sn[2 * k:2 * k + 2]
            w = w / spectral_sigma(w, u.detach(), v.detach())
        return w

    def _rates(self) -> List[float]:
        """The dropout rate before each layer: the input's, then the hidden
        layers' (0 = none)."""
        return [self.input_dropout] + [self.dropout] * (self.n_layers - 1)

    def draw_masks(self, rows, generator: torch.Generator) -> List[Optional[torch.Tensor]]:
        """Keep-masks for a forward over inputs of leading shape `rows`, one
        per layer (None where the rate is 0), from `generator`."""
        rows = (rows,) if isinstance(rows, int) else tuple(rows)
        dev = self.weights[0].device
        widths = [self.input_size] + [self.hidden_size] * (self.n_layers - 1)
        return [
            torch.rand(rows + (n,), generator=generator, device=dev) < 1.0 - rate if rate > 0 else None
            for rate, n in zip(self._rates(), widths)
        ]

    def apply(
        self,
        x: torch.Tensor,
        params: Optional[Sequence[torch.Tensor]] = None,
        masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
        sn: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """The forward with parameter leaves `params` and spectral-norm
        vectors `sn` (the module's own when None) and keep-masks `masks` (no
        dropout when None); a mask with leading axes the input lacks
        broadcasts it (one forward per ensemble member)."""
        params = self.params() if params is None else params
        act = _ACTIVATIONS[self.activation]
        rates = self._rates()

        def drop(k, h):
            if masks is None or masks[k] is None:
                return h
            return torch.where(masks[k], h / (1.0 - rates[k]), 0.0)

        h = drop(0, x)
        for k in range(self.n_layers):
            h = h @ self.effective_weight(k, params[2 * k], sn) + params[2 * k + 1]
            if k < self.n_layers - 1:
                h = act(drop(k + 1, h))
        return h

    def forward(
        self, x: torch.Tensor, *, masks: Optional[Sequence[Optional[torch.Tensor]]] = None
    ) -> torch.Tensor:
        """The forward with the module's own parameters; with `masks`, in
        training mode (dropout)."""
        return self.apply(x, masks=masks)

    @torch.no_grad()
    def update_spectral_norm(self, params: Optional[Sequence[torch.Tensor]] = None,
                             sn: Optional[Sequence[torch.Tensor]] = None) -> None:
        """One power iteration per layer, in place on `sn` (the module's
        vectors when None) from the weights of `params`: v <- unit(w u),
        then u <- unit(w^T v) (iltpu's update_spectral_norm)."""
        params = self.params() if params is None else params
        sn = self.sn_vectors() if sn is None else sn
        for k in range(self.n_layers):
            w, u, v = params[2 * k], sn[2 * k], sn[2 * k + 1]
            v.copy_(_unit(w @ u))
            u.copy_(_unit(w.T @ v))
