"""Tanh-Gaussian distribution math: the port of
`iltpu/models/distributions.py`, in the same numerically stable softplus
form. The noise of a sample is an argument, so a caller can hand in the
draws another implementation used."""

import math
from typing import Optional

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




# Marsaglia-Tsang candidates an element: the method accepts a candidate with
# probability above 0.95 at shape >= 1 (the shapes it is used at here), so
# all 8 are rejected with probability below 0.05^8 = 4e-11.
GAMMA_CANDIDATES = 8


def log_gamma_sample(a: float, shape, generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """log of Gamma(a, 1) draws, a > 0, capture-safe: Marsaglia-Tsang with a
    fixed number of candidates an element (GAMMA_CANDIDATES normals, then as
    many uniforms, drawn in bulk) and no host read. An element takes its
    first accepted candidate d v; one whose candidates are all rejected
    takes d (v = 1). For a < 1 it draws Gamma(a + 1) and adds log(U) / a
    (the U^(1/a) boost), U = 1 - one more uniform, in (0, 1]."""
    shape = tuple(shape)
    a1 = a + 1.0 if a < 1.0 else a
    d = a1 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn((GAMMA_CANDIDATES,) + shape, generator=generator, device=device)
    u = torch.rand((GAMMA_CANDIDATES,) + shape, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    log_v = torch.log(v)  # nan where v <= 0: never accepted
    accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * log_v)
    first = accept.to(torch.int32).argmax(0, keepdim=True)  # the first True
    log_g = math.log(d) + torch.where(accept.any(0), log_v.gather(0, first)[0], 0.0)
    if a < 1.0:
        boost = 1.0 - torch.rand(shape, generator=generator, device=device)
        log_g = log_g + torch.log(boost) / a
    return log_g


def beta_log_odds(alpha: float, shape, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """log(X / Y) of two Gamma(alpha) draws (X's draws first, then Y's): the
    log-odds of a Beta(alpha, alpha) draw. Capture-safe, as
    `log_gamma_sample`."""
    lx = log_gamma_sample(alpha, shape, generator, device)
    return lx - log_gamma_sample(alpha, shape, generator, device)


def beta_sample(alpha: float, shape, generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """Beta(alpha, alpha) draws X / (X + Y), taken as the sigmoid of the
    log-odds so that tiny gammas cannot make 0 / 0."""
    return torch.sigmoid(beta_log_odds(alpha, shape, generator, device))
