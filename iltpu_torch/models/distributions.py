"""Tanh-Gaussian distribution math: the port of
`iltpu/models/distributions.py`, in the same numerically stable softplus
form. The noise of a sample is an argument, so a caller can hand in the
draws another implementation used."""

import math

import torch

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_ACTION_EPS = 1e-6
LOG2 = math.log(2.0)
LOG2PI = math.log(2.0 * math.pi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without torch's linear cut-off (jax.nn.softplus)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def normal_log_prob(mean, log_std, z):
    """Diagonal Normal log density, summed over the action dimension."""
    var_term = 2.0 * log_std
    lp = -0.5 * ((z - mean) ** 2 * torch.exp(-var_term) + var_term + LOG2PI)
    return lp.sum(-1)


def tanh_log_det_jacobian(z):
    """log |d tanh(z)/dz| summed over the last axis, 2(log 2 - z - softplus(-2z))."""
    return (2.0 * (LOG2 - z - softplus(-2.0 * z))).sum(-1)


def sample_pretanh(mean, log_std, eps):
    """Reparameterised pre-tanh sample z = mean + std * eps."""
    return mean + torch.exp(log_std) * eps


def log_prob_from_pretanh(mean, log_std, z):
    """Exact log pi(tanh(z)) from the pre-tanh value."""
    return normal_log_prob(mean, log_std, z) - tanh_log_det_jacobian(z)


def log_prob_of_action(mean, log_std, action):
    """log pi(a) for a given action, clamped into (-1, 1) before atanh."""
    a = torch.clamp(action, -1.0 + _ACTION_EPS, 1.0 - _ACTION_EPS)
    return log_prob_from_pretanh(mean, log_std, torch.atanh(a))


