"""One GAIL discriminator step + reward head: the port of
`iltpu/ops/pallas_gail.py` (`_gail_core`).

  BCE on one 2B-row expert|policy forward, or Mixup on B convex combinations
  -> optional entropy bonus -> input-gradient penalty on eps-interpolated
  rows -> AdamW on (W1, b1, W2, b2) -> one spectral-norm power iteration ->
  the reward of the policy batch from the UPDATED network.

`gail_update` is the entry. On CUDA tensors it launches the hand-written
kernel of `csrc/gail_update.cu` (built by nvcc at first use; one block
whose working set is in shared memory, so it takes inputs of up to 32
features and widths up to 128, see `smem_bytes`) and raises if the launch
fails or the shape does not fit; on CPU tensors it runs `gail_update_plain`,
the same explicit formulas in PyTorch, which the CPU tests pin to iltpu's
autodiff.

The TPU kernel differentiates the penalty by tracing jax.grad inside the
kernel; here its parameter gradient is derived by hand. For a row x with
relu mask m = 1[z > 0], W~ = W / sigma, w~2 = W~2[:, 0] and
g = grad_x f = W~1 (m * w~2), the penalty P = gp * mean_B(g_w |g|^2) has
  dP/dW~1 = (2 gp / B) sum_i g_w_i g_i (m_i * w~2)^T
  dP/dw~2 = (2 gp / B) sum_i g_w_i m_i * (W~1^T g_i)
  dP/db1 = dP/db2 = 0 almost everywhere,
and through sigma = v^T W u (u, v held fixed):
  dL/dW = G/sigma - (<G, W> / sigma^2) v u^T.

The state is a dict of tensors updated IN PLACE:
  p: [W1 (D, Hd), b1 (Hd,), W2 (Hd, 1), b2 (1,)], m, v: its AdamW moments,
  sn: [u1 (Hd,), v1 (D,), u2 (1,), v2 (Hd,)] or [] without spectral norm,
  t: (1,) float32 Adam step clock,
  snm, snv: the optimiser's moment slots of u and v, which AdamW never
  moves (their gradient is zero); kept so a conversion round trip is exact.
"""

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from iltpu_torch.models.distributions import softplus
from iltpu_torch.ops import build, operands
from iltpu_torch.ops.sac_update import adamw_

REWARD_FUNCTIONS = ("GAIL", "AIRL", "FAIRL")
LOSS_FUNCTIONS = ("BCE", "Mixup")


class GAILHyper(NamedTuple):
    grad_penalty: float
    lr: float
    weight_decay: float
    reward_function: str = "AIRL"
    loss_function: str = "BCE"
    entropy_bonus: float = 0.0


def _sigma(w, u, v):
    return (v[:, None] * w * u[None, :]).sum()


def _normalised_weights(st):
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
def gail_update_plain(
    h: GAILHyper, st: Dict, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step in PyTorch with the kernel's explicit formulas; updates
    `st` in place and returns (loss (1,), rewards (B,))."""
    B = p_s.shape[0]
    W1, b1, W2, b2 = st["p"]
    Wt1, w2t, sig = _normalised_weights(st)
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

    # data term: BCE-with-logits (+ entropy bonus) over the loss rows
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

    # gradient penalty on eps_gp-interpolated rows, differentiated by hand
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

    # through sigma = v^T W u
    if sig is not None:
        u1, v1, u2, v2 = st["sn"]
        s1, s2 = sig
        gW1 = gWt1 / s1 - ((gWt1 * W1).sum() / (s1 * s1)) * (v1[:, None] * u1[None, :])
        gW2 = gw2t[:, None] / s2 - ((gw2t * W2[:, 0]).sum() / (s2 * s2)) * (v2[:, None] * u2[None, :])
    else:
        gW1, gW2 = gWt1, gw2t[:, None]

    adamw_(st["p"], [gW1, gb1, gW2, gb2], st["m"], st["v"], st["t"], h.lr, h.weight_decay)

    # power iteration on the updated weights, from the old u: v first, then u
    if st["sn"]:
        for w, u, v in ((W1, st["sn"][0], st["sn"][1]), (W2, st["sn"][2], st["sn"][3])):
            nv = w @ u
            nv = nv / (torch.sqrt((nv * nv).sum()) + 1e-12)
            nu = w.T @ nv
            u.copy_(nu / (torch.sqrt((nu * nu).sum()) + 1e-12))
            v.copy_(nv)

    Wt1, w2t, _ = _normalised_weights(st)
    f = torch.relu(p_x @ Wt1 + b1) @ w2t + b2[0]
    return loss.reshape(1), reward_head(f, h.reward_function)


# --------------------------------------------------------------- kernel


def _bind(lib):
    """Set the C signatures once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        lib.iltpu_gail_update.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
        )
        lib.iltpu_gail_update.restype = ctypes.c_int
        lib.iltpu_gail_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.iltpu_gail_smem_bytes.restype = ctypes.c_longlong
        lib.iltpu_gail_smem_limit.argtypes = []
        lib.iltpu_gail_smem_limit.restype = ctypes.c_longlong
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def smem_bytes(B: int, D: int, Hd: int) -> int:
    """The step's dynamic shared memory on the card (the batch rows, the
    weights and 16 warps' partial gradients); raises NotImplementedError
    where the kernel cannot take the shape: input D = S + A above 32, width
    Hd above 128, D above 16 with Hd above 64, or more than a block's shared
    memory (the plain version, on CPU tensors, takes any shape)."""
    lib = _bind(build.load("gail_update"))
    n, limit = lib.iltpu_gail_smem_bytes(B, D, Hd), lib.iltpu_gail_smem_limit()
    if n == 0 or n > limit:
        raise NotImplementedError(
            f"the gail_update kernel cannot take batch {B}, input {D}, width {Hd}: it has "
            f"no variant past input 32, width 128, or input 16 with width 64, and a block "
            f"has {limit} bytes of shared memory (this shape needs {n or 'no variant'}); "
            "ROADMAP.md, 'GAIL options'")
    return n


def state_tensors(st: Dict) -> List[torch.Tensor]:
    return list(st["p"]) + list(st["sn"]) + list(st["m"]) + list(st["v"]) + [st["t"]]


def state_shapes(D: int, Hd: int, sn: bool) -> List[tuple]:
    shapes = [(D, Hd), (Hd,), (Hd, 1), (1,)]
    return shapes + ([(Hd,), (D,), (1,), (Hd,)] if sn else []) + shapes * 2 + [(1,)]


def state_pointers(st: Dict) -> List[int]:
    """The 17 state pointers of the C entries (null u, v without spectral
    norm)."""
    ptrs = [t.data_ptr() for t in st["p"]]
    ptrs += [t.data_ptr() for t in st["sn"]] if st["sn"] else [0] * 4
    return ptrs + [t.data_ptr() for t in list(st["m"]) + list(st["v"]) + [st["t"]]]


def check_hyper(h: GAILHyper, mix: Optional[torch.Tensor]) -> None:
    if h.loss_function not in LOSS_FUNCTIONS or h.reward_function not in REWARD_FUNCTIONS:
        raise ValueError(f"unsupported GAIL configuration {h}")
    if (mix is None) != (h.loss_function == "BCE"):
        raise ValueError("mix must be given exactly for the Mixup loss")


def gail_update(
    h: GAILHyper, st: Dict, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One discriminator step + reward head in place: the kernel on CUDA
    tensors, the plain version on CPU tensors. `mix` is the Mixup draw
    (Beta(alpha, alpha), (B,)) and must be given exactly when the loss is
    Mixup. Returns (loss (1,), rewards (B,))."""
    check_hyper(h, mix)
    batch = [e_s, e_a, e_w, p_s, p_a, p_w, eps_gp] + ([mix] if mix is not None else [])
    ops = state_tensors(st) + batch
    if operands.placement("gail_update", ops) == "cpu":
        return gail_update_plain(h, st, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix)
    B, S = p_s.shape
    A = p_a.shape[1]
    D, Hd = st["p"][0].shape
    if D != S + A:
        raise ValueError(f"discriminator input {D} != state {S} + action {A}")
    operands.check("gail_update", ops, state_shapes(D, Hd, bool(st["sn"])) + [
        (B, S), (B, A), (B,), (B, S), (B, A), (B,), (B,)] + ([(B,)] if mix is not None else []))
    smem_bytes(B, D, Hd)
    out = launch(_bind(build.load("gail_update")), h, st, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp,
                 mix, torch.cuda.current_stream(p_s.device).cuda_stream)
    gail_update.launches += 1
    return out


def launch(lib, h: GAILHyper, st: Dict, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix, stream: int):
    """Pack the operands and call the library's C entry on `stream`;
    raises if the launch failed. Outputs come from torch.empty; the step
    needs no scratch (its working set is in shared memory)."""
    B, S = p_s.shape
    A = p_a.shape[1]
    Hd = st["p"][0].shape[1]
    dev = p_s.device
    loss = torch.empty(1, device=dev)
    rewards = torch.empty(B, device=dev)
    ptrs = state_pointers(st) + [t.data_ptr() for t in (e_s, e_a, e_w, p_s, p_a, p_w, eps_gp)]
    ptrs += [0 if mix is None else mix.data_ptr(), loss.data_ptr(), rewards.data_ptr()]
    rc = lib.iltpu_gail_update(
        (ctypes.c_void_p * len(ptrs))(*ptrs), B, S, A, Hd, int(bool(st["sn"])), int(mix is None),
        REWARD_FUNCTIONS.index(h.reward_function),
        h.grad_penalty, h.lr, h.weight_decay, h.entropy_bonus, stream,
    )
    if rc != 0:
        raise RuntimeError(f"gail_update kernel launch failed with CUDA error {rc}")
    return loss, rewards


gail_update.launches = 0
