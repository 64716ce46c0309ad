"""The plain reference of one GAIL discriminator step with its reward head:
float32 PyTorch, no autograd, no kernel, the formulas written out.

  BCE on the 2B-row expert|policy forward, or Mixup on B convex
  combinations -> optional entropy bonus -> input-gradient penalty on
  eps-interpolated rows -> AdamW on (W1, b1, W2, b2) through the spectral
  norm -> one power iteration -> the reward of the policy batch from the
  UPDATED network (GAIL, AIRL or FAIRL head).

A frozen copy of the plain step that `iltpu_torch` keeps beside its kernel.
It imports nothing of the program. For a row x with relu mask m and
W~ = W / sigma, g = grad_x f = W~1 (m * w~2), the penalty's parameter
gradient is derived by hand (dP/db = 0), and through sigma = v^T W u:
dL/dW = G / sigma - (<G, W> / sigma^2) v u^T.

The state: p [W1 (D, Hd), b1 (Hd,), W2 (Hd, 1), b2 (1,)], m, v (AdamW
moments), sn [u1 (Hd,), v1 (D,), u2 (1,), v2 (Hd,)] or [], t (1,) clock.
"""

from typing import Dict, List, NamedTuple

import torch

from portbench.reference.sac import adamw_, softplus


class GAILHyper(NamedTuple):
    grad_penalty: float
    lr: float
    weight_decay: float
    reward_function: str = "AIRL"
    loss_function: str = "BCE"
    entropy_bonus: float = 0.0


def _sigma(w, u, v):
    return (v[:, None] * w * u[None, :]).sum()


def _normalised(st):
    W1, b1, W2, b2 = st["p"]
    if st["sn"]:
        u1, v1, u2, v2 = st["sn"]
        s1, s2 = _sigma(W1, u1, v1), _sigma(W2, u2, v2)
        return W1 / s1, W2[:, 0] / s2, (s1, s2)
    return W1, W2[:, 0], None


def reward_head(f: torch.Tensor, reward_function: str) -> torch.Tensor:
    """GAIL -log(1-D), AIRL log D - log(1-D), FAIRL e^h (-h), 1e-6 guarded."""
    D = torch.sigmoid(f)
    if reward_function == "GAIL":
        return -torch.log1p(-D + 1e-6)
    r = torch.log(D + 1e-6) - torch.log1p(-D + 1e-6)
    return torch.exp(r) * -r if reward_function == "FAIRL" else r


@torch.no_grad()
def gail_step(h: GAILHyper, st: Dict, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix=None) -> Dict:
    """One step of `st` in place. Returns {"loss": (1,), "rewards": (B,),
    "grads": [gW1, gb1, gW2, gb2]}, the gradients AdamW receives."""
    B = p_s.shape[0]
    W1, b1, W2, b2 = st["p"]
    Wt1, w2t, sig = _normalised(st)
    e_x = torch.cat([e_s, e_a], -1)
    p_x = torch.cat([p_s, p_a], -1)
    if h.loss_function == "BCE":
        cx = torch.cat([e_x, p_x])
        cw = torch.cat([e_w, p_w])
        tgt = torch.cat([torch.ones_like(e_w), torch.zeros_like(p_w)])
    else:
        cx = mix[:, None] * e_x + (1.0 - mix[:, None]) * p_x
        cw = mix * e_w + (1.0 - mix) * p_w
        tgt = mix

    hid = torch.relu(cx @ Wt1 + b1)
    f = hid @ w2t + b2[0]
    sg = torch.sigmoid(f)
    loss = (cw * (softplus(-f) + (1.0 - tgt) * f)).sum() / B
    delta = cw * (sg - tgt) / B
    if h.entropy_bonus > 0.0:
        ent = softplus(f) - f * sg
        loss = loss - h.entropy_bonus * (cw * ent).sum() / B
        delta = delta + h.entropy_bonus * cw * f * sg * (1.0 - sg) / B
    dz = delta[:, None] * w2t[None, :] * (hid > 0)
    gWt1 = cx.T @ dz
    gb1 = dz.sum(0)
    gw2t = hid.T @ delta
    gb2 = delta.sum(0, keepdim=True)

    if h.grad_penalty > 0.0:
        gx = eps_gp[:, None] * e_x + (1.0 - eps_gp[:, None]) * p_x
        gw = eps_gp * e_w + (1.0 - eps_gp) * p_w
        mg = (gx @ Wt1 + b1 > 0).float()
        am = mg * w2t[None, :]
        g = am @ Wt1.T
        loss = loss + h.grad_penalty * (gw * (g * g).sum(1)).mean()
        c = 2.0 * h.grad_penalty * gw / B
        cg = c[:, None] * g
        gWt1 = gWt1 + cg.T @ am
        gw2t = gw2t + (mg * (cg @ Wt1)).sum(0)

    if sig is not None:
        u1, v1, u2, v2 = st["sn"]
        s1, s2 = sig
        gW1 = gWt1 / s1 - ((gWt1 * W1).sum() / (s1 * s1)) * (v1[:, None] * u1[None, :])
        gW2 = gw2t[:, None] / s2 - ((gw2t * W2[:, 0]).sum() / (s2 * s2)) * (v2[:, None] * u2[None, :])
    else:
        gW1, gW2 = gWt1, gw2t[:, None]
    grads = [gW1, gb1, gW2, gb2]
    adamw_(st["p"], grads, st["m"], st["v"], st["t"], h.lr, h.weight_decay)

    if st["sn"]:
        for w, u, v in ((W1, st["sn"][0], st["sn"][1]), (W2, st["sn"][2], st["sn"][3])):
            nv = w @ u
            nv = nv / (torch.sqrt((nv * nv).sum()) + 1e-12)
            nu = w.T @ nv
            u.copy_(nu / (torch.sqrt((nu * nu).sum()) + 1e-12))
            v.copy_(nv)

    Wt1, w2t, _ = _normalised(st)
    f = torch.relu(p_x @ Wt1 + b1) @ w2t + b2[0]
    return {"loss": loss.reshape(1), "rewards": reward_head(f, h.reward_function), "grads": grads}


def init_state(p: List[torch.Tensor], sn: List[torch.Tensor]) -> Dict:
    """A fresh discriminator state from the benchmark's weights and
    spectral-norm vectors: zero moments and clock."""
    return {"p": [t.clone() for t in p], "sn": [t.clone() for t in sn],
            "m": [torch.zeros_like(t) for t in p], "v": [torch.zeros_like(t) for t in p],
            "t": torch.zeros(1, device=p[0].device)}
