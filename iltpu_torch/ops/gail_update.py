"""One GAIL discriminator step + reward head: the port of
`iltpu/ops/pallas_gail.py` (`_gail_core`).

  BCE on one 2B-row expert|policy forward, or Mixup on B convex combinations
  -> optional entropy bonus -> input-gradient penalty on eps-interpolated
  rows -> AdamW on (W1, b1, W2, b2) -> one spectral-norm power iteration ->
  the reward of the policy batch from the UPDATED network.

`gail_update` is the entry. On CUDA tensors it launches the hand-written
kernel of `csrc/gail_update.cu` (built by nvcc at first use; its working
set is in shared memory: a tiled variant on one block holding the whole
batch where it fits, else the wide variant on one thread-block cluster of
`blocks` blocks, each streaming a segment of the rows through the tensor
cores in 3xTF32, so it takes inputs of up to 128 features and widths up to
128 at any batch, see `smem_bytes`, `variant` and `blocks`) and raises if
the launch fails, the card cannot hold the cluster, or the shape is past
those limits; on CPU tensors it runs `gail_update_plain`, the same
explicit formulas in PyTorch, which the CPU tests pin to iltpu's autodiff.

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


# The C entries' argument types before their own tail, as `entry_args` lays them out.
ENTRY_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_float] * 4


def _bind(lib):
    """Set the C signatures once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        lib.iltpu_gail_update.argtypes = ENTRY_ARGTYPES + [ctypes.c_void_p]
        lib.iltpu_gail_update.restype = ctypes.c_int
        lib.iltpu_gail_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.iltpu_gail_smem_bytes.restype = ctypes.c_longlong
        lib.iltpu_gail_variant.argtypes = [ctypes.c_int] * 3
        lib.iltpu_gail_variant.restype = ctypes.c_int
        lib.iltpu_gail_blocks.argtypes = [ctypes.c_int] * 3
        lib.iltpu_gail_blocks.restype = ctypes.c_int
        lib.iltpu_gail_smem_limit.argtypes = []
        lib.iltpu_gail_smem_limit.restype = ctypes.c_longlong
        lib._typed = True
    return lib


VARIANTS = ("tiled", "wide")
ERR_CLUSTER = -1000  # the C entry's answer where the card cannot hold the step's cluster
MAX_D = MAX_HD = 128  # the wide variant's input features and width, at most


@functools.lru_cache(maxsize=None)
def smem_bytes(B: int, D: int, Hd: int) -> int:
    """The step's dynamic shared memory on the card, of the variant the
    kernel routes the shape to (`variant`): the tiled variants hold the
    batch rows, the weights and 16 warps' partial gradients (inputs up to
    32, width 128 at inputs up to 16, and as far as a block's shared memory
    goes); the wide variant, on each block of its cluster, the weights and
    two stages of a chunk of 32 rows (inputs up to 128, width up to 128,
    any batch). Raises NotImplementedError where
    no variant can take the shape (the plain version, on CPU tensors, takes
    any shape)."""
    lib = _bind(build.load("gail_update"))
    n, limit = lib.iltpu_gail_smem_bytes(B, D, Hd), lib.iltpu_gail_smem_limit()
    if B < 1 or n == 0 or n > limit:
        raise NotImplementedError(
            f"the gail_update kernel cannot take batch {B}, input {D}, width {Hd}: it takes "
            f"inputs of 1 to {MAX_D} features and widths of 1 to {MAX_HD} (the tiled variants "
            f"up to 32 features and as far as a block's {limit} bytes of shared memory hold "
            f"the batch; this shape needs {n or 'no variant'})")
    return n


@functools.lru_cache(maxsize=None)
def variant(B: int, D: int, Hd: int) -> str:
    """The variant the kernel runs at (B, D, Hd): 'tiled' or 'wide'."""
    return VARIANTS[_bind(build.load("gail_update")).iltpu_gail_variant(B, D, Hd)]


@functools.lru_cache(maxsize=None)
def blocks(B: int, D: int, Hd: int) -> int:
    """The blocks a step at (B, D, Hd) runs on: 1 for a tiled variant; the
    wide variant's cluster, one block a segment of the rows (ceil(B / 32),
    at most 16). The segments are set by the shape alone, and so are the
    step's bits."""
    return _bind(build.load("gail_update")).iltpu_gail_blocks(B, D, Hd)


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


def batch_shapes(B: int, S: int, A: int, mixup: bool, lead: tuple = ()) -> List[tuple]:
    """The shapes of `_tail`'s operands, each after the leading dims `lead`
    (the K-blocked kernel's (K,): its slabs of K micro-updates)."""
    rows, s, a = (*lead, B), (*lead, B, S), (*lead, B, A)
    return [s, a, rows, s, a, rows, rows] + ([rows] if mixup else [])


def options(h: GAILHyper, st: Dict, mix: Optional[torch.Tensor]) -> tuple:
    """The C entries' integer options, in order: spectral norm, the BCE
    loss, the reward function's index."""
    return int(bool(st["sn"])), int(mix is None), REWARD_FUNCTIONS.index(h.reward_function)


def scalars(h: GAILHyper) -> tuple:
    """The C entries' float arguments, in order."""
    return h.grad_penalty, h.lr, h.weight_decay, h.entropy_bonus


TABLE = operands.Table()  # the kernel's launch table, bound to the last state it launched on
POINTERS = 27  # the C entry's: 17 of the state, 7 of the batch and draw, mix, loss, rewards


def _tail(e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix) -> List[torch.Tensor]:
    """The step's own operands: the batches, the draw and the Mixup draw."""
    return [e_s, e_a, e_w, p_s, p_a, p_w, eps_gp] + ([mix] if mix is not None else [])


def _bind_state(table: operands.Table, st: Dict, state, tail, shapes, S: int, A: int) -> None:
    """Check every operand as an unbound call would (one device; `shapes`
    the tail's), then pack the state's pointers into `table`; counted in
    `gail_update.binds`."""
    operands.placement("gail_update", state + tail)
    D, Hd = st["p"][0].shape
    if D != S + A:
        raise ValueError(f"discriminator input {D} != state {S} + action {A}")
    operands.check("gail_update", state + tail, state_shapes(D, Hd, bool(st["sn"])) + shapes)
    table.bind(state, state_pointers(st), (S, A), POINTERS)
    gail_update.binds += 1


def pack(table: operands.Table, st: Dict, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix, outs,
         shapes: Optional[List[tuple]] = None):
    """The C entries' pointer array for these operands and outputs (loss,
    rewards), in `table`: the state's part checked and packed only when the
    state's leaves are not those `table` last bound, the rest written on
    every call. `shapes` are the tail's (default `batch_shapes`, one
    step's). Raises the ValueError of an unbound call for an operand that
    does not fit or operands on more than one device."""
    state, tail = state_tensors(st), _tail(e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix)
    B, S = p_s.shape[-2:]
    A = p_a.shape[-1]
    shapes = shapes or batch_shapes(B, S, A, mix is not None)
    if not table.holds(state, (S, A), tail, shapes):
        _bind_state(table, st, state, tail, shapes, S, A)
    return table.fill(tail[:7] + [mix, *outs])


def entry_args(h: GAILHyper, st: Dict, mix: Optional[torch.Tensor], ptrs, B: int, S: int,
               A: int) -> tuple:
    """The C entries' arguments before their own tail (the stream; the
    phase timer's variant, then stamps or the stream): the pointer array
    (`pack`), the shape, the options, the scalars."""
    return (ptrs, B, S, A, st["p"][0].shape[1], *options(h, st, mix), *scalars(h))


def gail_update(
    h: GAILHyper, st: Dict, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One discriminator step + reward head in place: the kernel on CUDA
    tensors, the plain version on CPU tensors. `mix` is the Mixup draw
    (Beta(alpha, alpha), (B,)) and must be given exactly when the loss is
    Mixup. Returns (loss (1,), rewards (B,)).

    On the card the state's operands are checked and their pointers packed
    once (`pack` on `TABLE`, `gail_update.binds`): a later call on the same
    leaves checks and packs only the batches and draws."""
    check_hyper(h, mix)
    if p_s.is_cpu:  # raises unless every operand lies on the CPU
        operands.placement("gail_update",
                           state_tensors(st) + _tail(e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix))
        return gail_update_plain(h, st, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix)
    B, S = p_s.shape
    A = p_a.shape[1]
    loss, rewards = torch.empty(1, device=p_s.device), torch.empty(B, device=p_s.device)
    ptrs = pack(TABLE, st, e_s, e_a, e_w, p_s, p_a, p_w, eps_gp, mix, (loss, rewards))
    D, Hd = st["p"][0].shape
    smem_bytes(B, D, Hd)
    rc = _bind(build.load("gail_update")).iltpu_gail_update(
        *entry_args(h, st, mix, ptrs, B, S, A), operands.stream(TABLE.device))
    if rc == ERR_CLUSTER:
        raise RuntimeError(f"gail_update: the card cannot hold a cluster of {blocks(B, D, Hd)} "
                           f"blocks with {smem_bytes(B, D, Hd)} bytes of shared memory each")
    if rc != 0:
        raise RuntimeError(f"gail_update kernel launch failed with CUDA error {rc}")
    gail_update.launches += 1
    return loss, rewards


gail_update.launches = 0
gail_update.binds = 0
