"""The plain reference of one SAC update: float32 PyTorch, no autograd, no
kernel, the formulas written out.

  TD target (actor on s', target twin, min, entropy) -> critic forward and
  backward + AdamW -> actor forward, input gradient of the UPDATED critic,
  tanh-Gaussian backward + AdamW -> temperature Adam -> Polyak.

A frozen copy of the plain SAC update that `iltpu_torch` keeps beside its
kernel, so a later change to the program cannot move the yardstick. It
imports nothing of the program. `sac_step` updates a state dict in place
and returns the aux and the gradients as the optimiser receives them.

The state: a, am, av (actor [W1, b1, W2, b2, W3, b3] and its AdamW
moments), c, cm, cv (twin critic leaves, (2, ...) stacked), t (target
critic), la, lam, lav (log alpha and its Adam moments), ta, tc, tal (the
three (1,) float32 step clocks). AdamW: eps 1e-8, decoupled decay inside
the lr scaling, bias correction as exp(t log b).
"""

import math
from typing import Dict, List, NamedTuple

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LOG_B1, LOG_B2 = math.log(ADAM_B1), math.log(ADAM_B2)
LOG2 = math.log(2.0)
LOG2PI = math.log(2.0 * math.pi)
BATCH_KEYS = ("states", "actions", "rewards", "next_states", "terminals", "weights", "absorbing")


class SACHyper(NamedTuple):
    lr: float
    weight_decay: float
    alpha_lr: float
    discount: float
    entropy_target: float
    polyak: float
    min_alpha: float = 0.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a linear cut-off."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


@torch.no_grad()
def adamw_(params, grads, m, v, count, lr, wd):
    """One AdamW step over lists of leaves in place, advancing the (1,)
    step clock `count`:
      m <- b1 m + (1 - b1) g,  v <- b2 v + ((1 - b2) g) g,
      p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)."""
    t = count + 1.0
    bc1 = (1.0 - torch.exp(t * LOG_B1)).reshape(())
    bc2 = (1.0 - torch.exp(t * LOG_B2)).reshape(())
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(ADAM_B1).add_(g * (1.0 - ADAM_B1))
        vi.mul_(ADAM_B2).add_((g * (1.0 - ADAM_B2)) * g)
        step = (mi / bc1) / (torch.sqrt(vi / bc2) + ADAM_EPS)
        if wd:
            step = step + p * wd
        p.sub_(step * lr)
    count.copy_(t)


def _log_prob(ls, eps, z):
    n = -0.5 * (eps * eps + 2.0 * ls + LOG2PI)
    t = 2.0 * (LOG2 - z - softplus(-2.0 * z))
    return (n - t).sum(-1)


def _mlp_fwd(x, lv):
    h1 = torch.relu(x @ lv[0] + lv[1])
    h2 = torch.relu(h1 @ lv[2] + lv[3])
    return h2 @ lv[4] + lv[5], (x, h1, h2)


def _mlp_bwd(dout, cache, lv):
    x, h1, h2 = cache
    dz2 = (dout @ lv[4].T) * (h2 > 0)
    dz1 = (dz2 @ lv[2].T) * (h1 > 0)
    return [x.T @ dz1, dz1.sum(0), h1.T @ dz2, dz2.sum(0), h2.T @ dout, dout.sum(0)]


def _twin_fwd(x, lv):
    h1 = torch.relu(torch.matmul(x, lv[0]) + lv[1][:, None, :])
    h2 = torch.relu(torch.matmul(h1, lv[2]) + lv[3][:, None, :])
    q = torch.matmul(h2, lv[4]) + lv[5][:, None, :]
    return q[..., 0], (x, h1, h2)


def _twin_dz(dq, cache, lv):
    _, h1, h2 = cache
    dz2 = torch.matmul(dq[..., None], lv[4].transpose(1, 2)) * (h2 > 0)
    dz1 = torch.matmul(dz2, lv[2].transpose(1, 2)) * (h1 > 0)
    return dz1, dz2


def _twin_bwd(dq, cache, lv):
    x, h1, h2 = cache
    dz1, dz2 = _twin_dz(dq, cache, lv)
    return [
        torch.matmul(x.T, dz1),
        dz1.sum(1),
        torch.matmul(h1.transpose(1, 2), dz2),
        dz2.sum(1),
        torch.matmul(h2.transpose(1, 2), dq[..., None]),
        dq.sum(1)[:, None],
    ]


@torch.no_grad()
def sac_step(h: SACHyper, st: Dict, batch: Dict[str, torch.Tensor], eps2, eps_new) -> Dict:
    """One SAC update of `st` in place. Returns {"aux": (log_probs,
    Q_values, alpha), "grads": {"a": [...], "c": [...], "la": [...]}}, the
    gradients as each optimiser receives them."""
    s, a, r, s2, term, w, ab = (batch[k] for k in BATCH_KEYS)
    B, S = s.shape
    A = eps2.shape[1]
    aw, cw, tw = st["a"], st["c"], st["t"]
    alpha_raw = torch.exp(st["la"])
    alpha = torch.clamp_min(alpha_raw, h.min_alpha) if h.min_alpha > 0 else alpha_raw
    alpha_pre = torch.clamp_min(alpha_raw, h.min_alpha)

    o2, _ = _mlp_fwd(s2, aw)
    ls2 = o2[:, A:].clamp(-20.0, 2.0)
    z2 = o2[:, :A] + torch.exp(ls2) * eps2
    lp2 = _log_prob(ls2, eps2, z2)
    x2 = torch.cat([s2, (1.0 - ab[:, None]) * torch.tanh(z2)], -1)
    tq, _ = _twin_fwd(x2, tw)
    target_v = torch.minimum(tq[0], tq[1]) - (1.0 - ab) * alpha * lp2
    td = r + (1.0 - term) * h.discount * target_v

    q, ccache = _twin_fwd(torch.cat([s, a], -1), cw)
    min_q = torch.minimum(q[0], q[1])
    dq = (2.0 / B) * w[None, :] * (q - td[None, :])
    cg = _twin_bwd(dq, ccache, cw)
    adamw_(cw, cg, st["cm"], st["cv"], st["tc"], h.lr, h.weight_decay)

    o1, acache = _mlp_fwd(s, aw)
    l_raw = o1[:, A:]
    ls1 = l_raw.clamp(-20.0, 2.0)
    sg1 = torch.exp(ls1)
    z1 = o1[:, :A] + sg1 * eps_new
    lp1 = _log_prob(ls1, eps_new, z1)
    tanh_z = torch.tanh(z1)
    uq, ucache = _twin_fwd(torch.cat([s, tanh_z], -1), cw)
    sel1 = (uq[0] <= uq[1]).to(uq.dtype)
    dqn = (-1.0 / B) * torch.stack([sel1, 1.0 - sel1])
    dz1n, _ = _twin_dz(dqn, ucache, cw)
    w1a = cw[0][:, S:, :]
    da = dz1n[0] @ w1a[0].T + dz1n[1] @ w1a[1].T
    sech2 = 1.0 - tanh_z * tanh_z
    c_ent = (w * (1.0 - ab) * alpha / B)[:, None]
    g_mu = c_ent * (2.0 * tanh_z) + da * sech2
    g_ls = c_ent * (-1.0 + 2.0 * sg1 * eps_new * tanh_z) + da * sech2 * sg1 * eps_new
    g_ls = g_ls * ((l_raw >= -20.0) & (l_raw <= 2.0))
    ag = _mlp_bwd(torch.cat([g_mu, g_ls], -1), acache, aw)
    adamw_(aw, ag, st["am"], st["av"], st["ta"], h.lr, h.weight_decay)

    g_la = -(w * (1.0 - ab) * (lp1 + h.entropy_target)).sum(0, keepdim=True) / B * alpha_raw
    adamw_([st["la"]], [g_la], [st["lam"]], [st["lav"]], st["tal"], h.alpha_lr, 0.0)

    for t, c in zip(tw, cw):
        t.mul_(h.polyak).add_(c * (1.0 - h.polyak))
    return {"aux": {"log_probs": lp1, "Q_values": min_q, "alpha": alpha_pre[0]},
            "grads": {"a": ag, "c": cg, "la": [g_la]}}


def init_state(actor: List[torch.Tensor], critic: List[torch.Tensor]) -> Dict:
    """A fresh SAC state from the benchmark's weights: zero moments and
    clocks, the target critic a copy of the critic, log alpha 0."""
    zeros = lambda ts: [torch.zeros_like(t) for t in ts]
    one = lambda: torch.zeros(1, device=critic[0].device)
    return {"a": [t.clone() for t in actor], "am": zeros(actor), "av": zeros(actor),
            "c": [t.clone() for t in critic], "cm": zeros(critic), "cv": zeros(critic),
            "t": [t.clone() for t in critic], "la": one(), "lam": one(), "lav": one(),
            "ta": one(), "tc": one(), "tal": one()}
