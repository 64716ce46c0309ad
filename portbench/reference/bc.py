"""The plain reference of one behavioural-cloning step of a tanh-Gaussian
MLP policy: float32 PyTorch, no autograd, no kernel, the formulas written
out.

  (optional input dropout) -> per layer: x W + b, then (optional dropout
  of the pre-activation) and the activation, but on the last layer ->
  (mean | log_std) halves, log_std clamped to [-20, 2] -> the weighted
  negative log-likelihood of the expert actions, clamped into (-1, 1) and
  taken through atanh -> its backward -> AdamW (`sac.adamw_`).

The same step serves the BC auxiliary step on the SAC actor (relu, no
dropout) and the pretraining of DRIL's dropout ensemble (tanh, inverted
dropout with given keep-masks). It imports nothing of the program.

Params are [W1, b1, W2, b2, ...], each W (in, out). Dropout: `masks[k]`
(bool, None for none) and `rates[k]` for layer k's input (k = 0) or its
pre-activation (k >= 1, before the activation); kept units are scaled by
1 / (1 - rate). A mask with leading axes the input lacks broadcasts it
(the ensemble's members).
"""

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference.sac import LOG2, LOG2PI, adamw_, softplus

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
ACTION_EPS = 1e-6


def _drop(h, masks, rates, k):
    if masks is None or masks[k] is None:
        return h
    return torch.where(masks[k], h / (1.0 - rates[k]), 0.0)


def _act(h, activation: str):
    return torch.relu(h) if activation == "relu" else torch.tanh(h)


def forward(params: Sequence[torch.Tensor], x, activation: str, masks=None, rates=None):
    """The MLP's output and what its backward needs: each layer's input and
    each hidden activation."""
    n = len(params) // 2
    ins, hs = [], []
    h = _drop(x, masks, rates, 0)
    for k in range(n):
        ins.append(h)
        h = h @ params[2 * k] + params[2 * k + 1]
        if k < n - 1:
            h = _act(_drop(h, masks, rates, k + 1), activation)
            hs.append(h)
    return h, (ins, hs)


def backward(dout, cache, params: Sequence[torch.Tensor], activation: str, masks=None,
             rates=None) -> List[torch.Tensor]:
    """The leaves' gradients from the output's, rows summed (and any leading
    member axes)."""
    ins, hs = cache
    n = len(params) // 2
    grads: List[Optional[torch.Tensor]] = [None] * (2 * n)
    d = dout
    for k in reversed(range(n)):
        x = ins[k]
        xr, dr = x.reshape(-1, x.shape[-1]), d.reshape(-1, d.shape[-1])
        grads[2 * k] = xr.T @ dr
        grads[2 * k + 1] = dr.sum(0)
        if k == 0:
            break
        d = d @ params[2 * k].T
        h = hs[k - 1]
        d = d * (h > 0) if activation == "relu" else d * (1.0 - h * h)
        if masks is not None and masks[k] is not None:
            d = torch.where(masks[k], d / (1.0 - rates[k]), 0.0)
    return grads


def clamped_atanh(actions):
    return torch.atanh(torch.clamp(actions, -1.0 + ACTION_EPS, 1.0 - ACTION_EPS))


def log_prob(out, z):
    """log pi(tanh z) of the pre-tanh actions `z` under the output halves
    (mean | raw log_std), summed over the action axis."""
    A = z.shape[-1]
    mean, ls = out[..., :A], out[..., A:].clamp(LOG_STD_MIN, LOG_STD_MAX)
    d = z - mean
    normal = -0.5 * (d * d * torch.exp(-2.0 * ls) + 2.0 * ls + LOG2PI)
    jac = 2.0 * (LOG2 - z - softplus(-2.0 * z))
    return (normal - jac).sum(-1)


@torch.no_grad()
def bc_step(st: Dict, states, actions, weights, lr: float, weight_decay: float,
            activation: str = "relu", masks=None, rates=None) -> Dict:
    """One AdamW step of `st` ({"p", "m", "v": leaves, "t": (1,) clock}) in
    place on loss = mean(w * -log pi(a | s)). Returns {"loss": 0-d,
    "grads": leaves}."""
    p = st["p"]
    B = states.shape[0]
    out, cache = forward(p, states, activation, masks, rates)
    z = clamped_atanh(actions)
    A = z.shape[-1]
    mean, raw = out[:, :A], out[:, A:]
    ls = raw.clamp(LOG_STD_MIN, LOG_STD_MAX)
    d = z - mean
    inv_var = torch.exp(-2.0 * ls)
    c = (weights / B)[:, None]
    g_mean = -c * d * inv_var
    g_ls = c * (1.0 - d * d * inv_var) * ((raw >= LOG_STD_MIN) & (raw <= LOG_STD_MAX))
    grads = backward(torch.cat([g_mean, g_ls], -1), cache, p, activation, masks, rates)
    loss = (weights * -log_prob(out, z)).mean()
    adamw_(p, grads, st["m"], st["v"], st["t"], lr, weight_decay)
    return {"loss": loss, "grads": grads}


def opt_state(params: Sequence[torch.Tensor]) -> Dict:
    """A fresh AdamW state of copies of `params`: zero moments and clock."""
    return {"p": [x.clone() for x in params], "m": [torch.zeros_like(x) for x in params],
            "v": [torch.zeros_like(x) for x in params],
            "t": torch.zeros(1, device=params[0].device)}

