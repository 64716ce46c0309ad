"""Pairwise distance and kernel primitives (GMMIL): the port of
`iltpu/ops/pairwise.py`.

Distances come from the centred Gram expansion, one matrix product, with
the two sets shifted by a shared centre (which leaves every difference
unchanged and conditions the fp32 expansion).
"""

from typing import Tuple

import torch


def centre(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x and y shifted by 0.5 (mean(x) + mean(y))."""
    c = 0.5 * (x.mean(0) + y.mean(0))
    return x - c, y - c


def squared_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """out[i, j] = mean_d (x[i, d] - y[j, d])^2, shape (n_x, n_y)."""
    d = x.shape[-1]
    x, y = centre(x, y)
    x_sq = (x * x).sum(-1, keepdim=True)
    y_sq = (y * y).sum(-1, keepdim=True).T
    return torch.clamp_min(x_sq + y_sq - 2.0 * (x @ y.T), 0.0) / d


def gaussian_kernel(sq_dist: torch.Tensor, gamma) -> torch.Tensor:
    return torch.exp(-gamma * sq_dist)


def weighted_similarity(sq_dist, w_x, w_y, gamma) -> torch.Tensor:
    """out[i] = w_x[i] * sum_j exp(-gamma d2[i, j]) w_y[j]."""
    return w_x * (gaussian_kernel(sq_dist, gamma) @ w_y)


def weighted_median(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The first value of the stably sorted x whose cumulative normalised
    weight reaches 0.5 (0-d)."""
    x_flat = x.reshape(-1)
    w_flat = weights.reshape(-1)
    order = torch.sort(x_flat, stable=True).indices
    cdf = torch.cumsum((w_flat / w_flat.sum())[order], 0)
    return x_flat[order][torch.argmax((cdf >= 0.5).to(torch.int32))]
