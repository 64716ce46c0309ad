"""One whole SAC update: the port of `iltpu/ops/pallas_sac.py` (`_sac_core`).

  TD target (actor on s', target twin, min, entropy) -> critic forward and
  backward + AdamW -> actor forward, input-gradient of the UPDATED critic,
  hand-derived tanh-Gaussian backward + AdamW -> temperature Adam -> Polyak.

`sac_update` is the entry. On CUDA tensors it makes ONE cooperative launch
of the hand-written kernel of `csrc/sac_update.cu` (built by nvcc at first
use) and raises if the launch fails or the grid is refused; on CPU tensors it runs `sac_update_plain`, the
same explicit formulas in PyTorch (no autograd), which the CPU tests pin to
iltpu. Twin critics stay (2, ...)-stacked: no block-diagonal layout.

The state is a dict of tensors updated IN PLACE (parameters, AdamW moments,
target critic, log_alpha and its Adam moments, and the three Adam step
counts as (1,) float32 clocks):
  a, am, av: actor [W1, b1, W2, b2, W3, b3] and its moments
  c, cm, cv, t: twin critic (2, ...) leaves, its moments, the target critic
  la, lam, lav, ta, tc, tal: (1,) each
AdamW is optax's (eps 1e-8, decoupled decay inside the lr scaling, bias
correction on the float32 step clock); the temperature uses plain Adam.

Derivatives for z = mu + sigma*eps, lp = sum[-0.5(eps^2 + 2ls + log 2pi)]
- sum[2(log 2 - z - softplus(-2z))]:
  d lp/d mu = 2 tanh(z), d lp/d ls = -1 + 2 sigma eps tanh(z),
  d a/d mu = 1 - tanh^2(z), d a/d ls = (1 - tanh^2(z)) sigma eps.
"""

import ctypes
import math
from typing import Dict, List, NamedTuple

import torch

from iltpu_torch.models.critic import polyak_update
from iltpu_torch.models.distributions import LOG2, LOG2PI, softplus
from iltpu_torch.ops import build, operands

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
LOG_B1, LOG_B2 = math.log(ADAM_B1), math.log(ADAM_B2)

# Pointer order of the C entry: the state, the batch, the noise, the outputs.
STATE_KEYS = ("a", "am", "av", "c", "cm", "cv", "t")
SCALAR_KEYS = ("la", "lam", "lav", "ta", "tc", "tal")
BATCH_KEYS = ("states", "actions", "rewards", "next_states", "terminals", "weights", "absorbing")


class SACHyper(NamedTuple):
    lr: float
    weight_decay: float
    alpha_lr: float
    discount: float
    entropy_target: float
    polyak: float
    min_alpha: float = 0.0


# ---------------------------------------------------------------- plain


@torch.no_grad()
def adamw_(params, grads, m, v, count, lr, wd):
    """One AdamW step over lists of leaves in place (optax.flatten(adamw) is
    the same elementwise math; b**t as exp(t log b)), advancing the (1,)
    step clock `count`. Multi-tensor ops: a dozen launches whatever the
    number of leaves, each element computed as
      m <- b1 m + (1 - b1) g,  v <- b2 v + ((1 - b2) g) g,
      p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)."""
    t = count + 1.0
    bc1 = (1.0 - torch.exp(t * LOG_B1)).reshape(())
    bc2 = (1.0 - torch.exp(t * LOG_B2)).reshape(())
    torch._foreach_mul_(m, ADAM_B1)
    torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - ADAM_B1))
    torch._foreach_mul_(v, ADAM_B2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, 1.0 - ADAM_B2), grads))
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    step = torch._foreach_div(torch._foreach_div(m, bc1), denom)
    if wd:
        torch._foreach_add_(step, torch._foreach_mul(params, wd))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(params, step)
    count.copy_(t)


def _log_prob(ls, eps, z):
    n = -0.5 * (eps * eps + 2.0 * ls + LOG2PI)
    t = 2.0 * (LOG2 - z - softplus(-2.0 * z))
    return (n - t).sum(-1)


def _mlp_fwd(x, lv):
    """Depth-2 relu MLP (the actor) -> (out, (x, h1, h2))."""
    h1 = torch.relu(x @ lv[0] + lv[1])
    h2 = torch.relu(h1 @ lv[2] + lv[3])
    return h2 @ lv[4] + lv[5], (x, h1, h2)


def _mlp_bwd(dout, cache, lv):
    x, h1, h2 = cache
    dz2 = (dout @ lv[4].T) * (h2 > 0)
    dz1 = (dz2 @ lv[2].T) * (h1 > 0)
    return [x.T @ dz1, dz1.sum(0), h1.T @ dz2, dz2.sum(0), h2.T @ dout, dout.sum(0)]


def _twin_fwd(x, lv):
    """Both critics on rows x (B, X) -> ((2, B) q, cache)."""
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
def sac_update_plain(
    h: SACHyper, st: Dict, batch: Dict[str, torch.Tensor], eps2, eps_new
) -> Dict[str, torch.Tensor]:
    """The update in PyTorch with the kernel's explicit formulas; updates
    `st` in place and returns the aux (log_probs, Q_values, alpha)."""
    s, a, r, s2, term, w, ab = (batch[k] for k in BATCH_KEYS)
    B, S = s.shape
    A = eps2.shape[1]
    aw, cw, tw = st["a"], st["c"], st["t"]
    alpha_raw = torch.exp(st["la"])
    alpha = torch.clamp_min(alpha_raw, h.min_alpha) if h.min_alpha > 0 else alpha_raw
    alpha_pre = torch.clamp_min(alpha_raw, h.min_alpha)

    # TD target: no gradients
    o2, _ = _mlp_fwd(s2, aw)
    ls2 = o2[:, A:].clamp(-20.0, 2.0)
    z2 = o2[:, :A] + torch.exp(ls2) * eps2
    lp2 = _log_prob(ls2, eps2, z2)
    x2 = torch.cat([s2, (1.0 - ab[:, None]) * torch.tanh(z2)], -1)
    tq, _ = _twin_fwd(x2, tw)
    target_v = torch.minimum(tq[0], tq[1]) - (1.0 - ab) * alpha * lp2
    td = r + (1.0 - term) * h.discount * target_v

    # critic step
    q, ccache = _twin_fwd(torch.cat([s, a], -1), cw)
    min_q = torch.minimum(q[0], q[1])
    dq = (2.0 / B) * w[None, :] * (q - td[None, :])
    cg = _twin_bwd(dq, ccache, cw)
    adamw_(cw, cg, st["cm"], st["cv"], st["tc"], h.lr, h.weight_decay)

    # actor step against the UPDATED critic
    o1, acache = _mlp_fwd(s, aw)
    l_raw = o1[:, A:]
    ls1 = l_raw.clamp(-20.0, 2.0)
    sg1 = torch.exp(ls1)
    z1 = o1[:, :A] + sg1 * eps_new
    lp1 = _log_prob(ls1, eps_new, z1)
    tanh_z = torch.tanh(z1)
    uq, ucache = _twin_fwd(torch.cat([s, tanh_z], -1), cw)
    sel1 = (uq[0] <= uq[1]).float()
    dqn = (-1.0 / B) * torch.stack([sel1, 1.0 - sel1])
    dz1n, _ = _twin_dz(dqn, ucache, cw)
    w1a = cw[0][:, S:, :]  # rows of W1 that read the action
    da = dz1n[0] @ w1a[0].T + dz1n[1] @ w1a[1].T
    sech2 = 1.0 - tanh_z * tanh_z
    c_ent = (w * (1.0 - ab) * alpha / B)[:, None]
    g_mu = c_ent * (2.0 * tanh_z) + da * sech2
    g_ls = c_ent * (-1.0 + 2.0 * sg1 * eps_new * tanh_z) + da * sech2 * sg1 * eps_new
    g_ls = g_ls * ((l_raw >= -20.0) & (l_raw <= 2.0))
    ag = _mlp_bwd(torch.cat([g_mu, g_ls], -1), acache, aw)
    adamw_(aw, ag, st["am"], st["av"], st["ta"], h.lr, h.weight_decay)

    # temperature: plain Adam on the pre-update log_alpha, with the RAW alpha
    g_la = -(w * (1.0 - ab) * (lp1 + h.entropy_target)).sum(0, keepdim=True) / B * alpha_raw
    adamw_([st["la"]], [g_la], [st["lam"]], [st["lav"]], st["tal"], h.alpha_lr, 0.0)

    polyak_update(cw, tw, h.polyak)
    return {"log_probs": lp1, "Q_values": min_q, "alpha": alpha_pre[0]}


# --------------------------------------------------------------- kernel


def _bind(lib):
    """Set the C signatures once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        lib.iltpu_sac_update.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_float] * 7
            + [ctypes.c_void_p, ctypes.c_void_p]
        )
        lib.iltpu_sac_update.restype = ctypes.c_int
        lib.iltpu_sac_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.iltpu_sac_scratch_floats.restype = ctypes.c_longlong
        lib.iltpu_sac_grid.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.iltpu_sac_grid.restype = ctypes.c_int
        lib.iltpu_sac_error.argtypes = [ctypes.c_int]
        lib.iltpu_sac_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def state_tensors(st: Dict) -> List[torch.Tensor]:
    """The 48 state tensors in the C entries' pointer order."""
    ops = []
    for k in STATE_KEYS:
        ops += list(st[k])
    return ops + [st[k] for k in SCALAR_KEYS]


def _operands(st, batch, eps2, eps_new) -> List[torch.Tensor]:
    return state_tensors(st) + [batch[k] for k in BATCH_KEYS] + [eps2, eps_new]


def state_shapes(S: int, A: int, H: int) -> List[tuple]:
    X = S + A
    actor = [(S, H), (H,), (H, H), (H,), (H, 2 * A), (2 * A,)]
    critic = [(2, X, H), (2, H), (2, H, H), (2, H), (2, H, 1), (2, 1)]
    return actor * 3 + critic * 4 + [(1,)] * 6


def expected_shapes(S: int, A: int, H: int, B: int) -> List[tuple]:
    return state_shapes(S, A, H) + [(B, S), (B, A), (B,), (B, S), (B,), (B,), (B,), (B, A), (B, A)]


def sac_update(
    h: SACHyper, st: Dict, batch: Dict[str, torch.Tensor], eps2, eps_new
) -> Dict[str, torch.Tensor]:
    """One SAC update in place: the kernel on CUDA tensors, the plain
    version on CPU tensors. Returns (log_probs, Q_values, alpha)."""
    ops = _operands(st, batch, eps2, eps_new)
    if operands.placement("sac_update", ops) == "cpu":
        return sac_update_plain(h, st, batch, eps2, eps_new)
    B, S = batch["states"].shape
    A = eps2.shape[1]
    H = st["a"][0].shape[1]
    operands.check("sac_update", ops, expected_shapes(S, A, H, B))
    aux = launch(_bind(build.load("sac_update")), h, st, batch, eps2, eps_new,
                 torch.cuda.current_stream(ops[0].device).cuda_stream)
    sac_update.launches += 1
    return aux


def grid(lib, B: int, S: int, A: int, H: int):
    """(co-resident blocks per SM, SMs, dynamic shared memory bytes): the
    launch's grid is the product of the first two."""
    per_sm, sms, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    rc = _bind(lib).iltpu_sac_grid(B, S, A, H, ctypes.byref(per_sm), ctypes.byref(sms),
                                   ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"sac_update occupancy query failed: {_error(lib, rc)}")
    return per_sm.value, sms.value, smem.value


def _error(lib, rc: int) -> str:
    return f"CUDA error {rc} ({lib.iltpu_sac_error(rc).decode()})"


def launch(lib, h: SACHyper, st: Dict, batch: Dict[str, torch.Tensor], eps2, eps_new, stream: int):
    """Pack the operands and call the library's C entry on `stream`: one
    cooperative launch; raises if it failed or was refused. Outputs and
    scratch come from torch.empty."""
    ops = _operands(st, batch, eps2, eps_new)
    B, S = batch["states"].shape
    A = eps2.shape[1]
    H = st["a"][0].shape[1]
    dev = ops[0].device
    lp = torch.empty(B, device=dev)
    min_q = torch.empty(B, device=dev)
    alpha = torch.empty(1, device=dev)
    scratch = torch.empty(lib.iltpu_sac_scratch_floats(B, S, A, H), device=dev)
    ptrs = (ctypes.c_void_p * (len(ops) + 3))(
        *[t.data_ptr() for t in ops], lp.data_ptr(), min_q.data_ptr(), alpha.data_ptr()
    )
    rc = lib.iltpu_sac_update(
        ptrs, B, S, A, H,
        h.lr, h.weight_decay, h.alpha_lr, h.discount, h.entropy_target, h.polyak, h.min_alpha,
        scratch.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"sac_update kernel launch failed: {_error(lib, rc)}")
    return {"log_probs": lp, "Q_values": min_q, "alpha": alpha[0]}


sac_update.launches = 0
