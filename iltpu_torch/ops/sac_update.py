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
from typing import Dict, List, NamedTuple, Optional

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


def _mlp_bwd(dout, cache, lv, trace=None):
    x, h1, h2 = cache
    dz2 = (dout @ lv[4].T) * (h2 > 0)
    dz1 = (dz2 @ lv[2].T) * (h1 > 0)
    if trace is not None:
        trace.update(dout=dout, adz2=dz2, adz1=dz1)
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
    h: SACHyper, st: Dict, batch: Dict[str, torch.Tensor], eps2, eps_new,
    trace: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """The update in PyTorch with the kernel's explicit formulas; updates
    `st` in place and returns the aux (log_probs, Q_values, alpha). Given
    `trace`, it also records the intermediates under the names of the
    kernel's scratch buffers (`iltpu_sac_buffer_names`), a later one
    replacing an earlier one of the same name as the kernel's phases
    overwrite their buffers."""
    s, a, r, s2, term, w, ab = (batch[k] for k in BATCH_KEYS)
    B, S = s.shape
    A = eps2.shape[1]
    aw, cw, tw = st["a"], st["c"], st["t"]
    alpha_raw = torch.exp(st["la"])
    alpha = torch.clamp_min(alpha_raw, h.min_alpha) if h.min_alpha > 0 else alpha_raw
    alpha_pre = torch.clamp_min(alpha_raw, h.min_alpha)

    # TD target: no gradients
    o2, (_, ah1, ah2) = _mlp_fwd(s2, aw)
    ls2 = o2[:, A:].clamp(-20.0, 2.0)
    z2 = o2[:, :A] + torch.exp(ls2) * eps2
    lp2 = _log_prob(ls2, eps2, z2)
    x2 = torch.cat([s2, (1.0 - ab[:, None]) * torch.tanh(z2)], -1)
    tq, (_, th1, th2) = _twin_fwd(x2, tw)
    target_v = torch.minimum(tq[0], tq[1]) - (1.0 - ab) * alpha * lp2
    td = r + (1.0 - term) * h.discount * target_v
    if trace is not None:
        trace.update(ah1=ah1, ah2=ah2, ao=o2, lp2=lp2, x2=x2, th1=th1, th2=th2, tq=tq, td=td)

    # critic step
    q, ccache = _twin_fwd(torch.cat([s, a], -1), cw)
    min_q = torch.minimum(q[0], q[1])
    dq = (2.0 / B) * w[None, :] * (q - td[None, :])
    cg = _twin_bwd(dq, ccache, cw)
    if trace is not None:
        trace.update(x=ccache[0], ch1=ccache[1], ch2=ccache[2], cq=q, dq=dq,
                     **{f"gc{i}": g for i, g in enumerate(cg)})
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
    sel1 = (uq[0] <= uq[1]).to(uq.dtype)
    dqn = (-1.0 / B) * torch.stack([sel1, 1.0 - sel1])
    dz1n, dz2n = _twin_dz(dqn, ucache, cw)
    w1a = cw[0][:, S:, :]  # rows of W1 that read the action
    da2 = torch.stack([dz1n[0] @ w1a[0].T, dz1n[1] @ w1a[1].T])
    da = da2[0] + da2[1]
    if trace is not None:
        trace.update(bh1=acache[1], bh2=acache[2], bo=o1, xn=ucache[0], th1=ucache[1],
                     th2=ucache[2], tq=uq, dq=dqn, dz1=dz1n, dz2=dz2n, da=da2)
    sech2 = 1.0 - tanh_z * tanh_z
    c_ent = (w * (1.0 - ab) * alpha / B)[:, None]
    g_mu = c_ent * (2.0 * tanh_z) + da * sech2
    g_ls = c_ent * (-1.0 + 2.0 * sg1 * eps_new * tanh_z) + da * sech2 * sg1 * eps_new
    g_ls = g_ls * ((l_raw >= -20.0) & (l_raw <= 2.0))
    ag = _mlp_bwd(torch.cat([g_mu, g_ls], -1), acache, aw, trace)
    if trace is not None:
        trace.update({f"ga{i}": g for i, g in enumerate(ag)})
    adamw_(aw, ag, st["am"], st["av"], st["ta"], h.lr, h.weight_decay)

    # temperature: plain Adam on the pre-update log_alpha, with the RAW alpha
    g_la = -(w * (1.0 - ab) * (lp1 + h.entropy_target)).sum(0, keepdim=True) / B * alpha_raw
    adamw_([st["la"]], [g_la], [st["lam"]], [st["lav"]], st["tal"], h.alpha_lr, 0.0)

    polyak_update(cw, tw, h.polyak)
    return {"log_probs": lp1, "Q_values": min_q, "alpha": alpha_pre[0]}


# --------------------------------------------------------------- kernel


# The C entries' argument types before their own tail, as `entry_args` lays them out.
ENTRY_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_float] * 8 + [ctypes.c_void_p]


def _bind(lib):
    """Set the C signatures once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        lib.iltpu_sac_update.argtypes = ENTRY_ARGTYPES + [ctypes.c_void_p]
        lib.iltpu_sac_update.restype = ctypes.c_int
        lib.iltpu_sac_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.iltpu_sac_scratch_floats.restype = ctypes.c_longlong
        lib.iltpu_sac_grid.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.iltpu_sac_grid.restype = ctypes.c_int
        lib.iltpu_sac_error.argtypes = [ctypes.c_int]
        lib.iltpu_sac_error.restype = ctypes.c_char_p
        lib.iltpu_sac_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
        lib.iltpu_sac_plan.restype = None
        lib._typed = True
    return lib


def state_tensors(st: Dict) -> List[torch.Tensor]:
    """The 48 state tensors in the C entries' pointer order."""
    ops = []
    for k in STATE_KEYS:
        ops += list(st[k])
    return ops + [st[k] for k in SCALAR_KEYS]


def _tail(batch, eps2, eps_new) -> List[torch.Tensor]:
    """The update's own operands: the batch, then the noise."""
    return [batch[k] for k in BATCH_KEYS] + [eps2, eps_new]


def state_shapes(S: int, A: int, H: int) -> List[tuple]:
    X = S + A
    actor = [(S, H), (H,), (H, H), (H,), (H, 2 * A), (2 * A,)]
    critic = [(2, X, H), (2, H), (2, H, H), (2, H), (2, H, 1), (2, 1)]
    return actor * 3 + critic * 4 + [(1,)] * 6


def batch_shapes(S: int, A: int, B: int, lead: tuple = ()) -> List[tuple]:
    """The shapes of `_tail`'s operands, each after the leading dims `lead`
    (the K-blocked kernel's (K,): its slabs of K micro-updates)."""
    rows, s, a = (*lead, B), (*lead, B, S), (*lead, B, A)
    return [s, a, rows, s, rows, rows, rows, a, a]


def scalars(h: SACHyper) -> tuple:
    """The C entries' float arguments, in order."""
    return (h.lr, h.weight_decay, h.alpha_lr, h.discount, h.entropy_target, h.polyak,
            1.0 - h.polyak, h.min_alpha)


TABLE = operands.Table()  # the kernel's launch table, bound to the last state it launched on
OUTPUTS = 3  # log_probs, min Q, alpha: the table's last pointers


def outputs(B: int, device) -> List[torch.Tensor]:
    """The C entry's outputs, from torch.empty: log_probs, min Q (B,), alpha (1,)."""
    return [torch.empty(B, device=device), torch.empty(B, device=device),
            torch.empty(1, device=device)]


def _bind_state(table: operands.Table, state, tail, shapes, S: int, A: int, H: int) -> None:
    """Check every operand as an unbound call would (one device; `shapes`
    the tail's), then pack the state's pointers into `table`; counted in
    `sac_update.binds`."""
    operands.placement("sac_update", state + tail)
    operands.check("sac_update", state + tail, state_shapes(S, A, H) + shapes)
    table.bind(state, [t.data_ptr() for t in state], (S, A), len(state) + len(tail) + OUTPUTS)
    sac_update.binds += 1


def pack(table: operands.Table, st: Dict, batch: Dict[str, torch.Tensor], eps2, eps_new,
         outs: List[torch.Tensor], shapes: Optional[List[tuple]] = None):
    """The C entries' pointer array for these operands and outputs, in
    `table`: the state's part checked and packed only when the state's
    leaves are not those `table` last bound, the rest written on every
    call. `shapes` are the batch's and the noise's (default
    `batch_shapes`, one update's). Raises operands.check's ValueError for
    an operand that does not fit, and operands.placement's for operands
    on more than one device."""
    state, tail = state_tensors(st), _tail(batch, eps2, eps_new)
    B, S = tail[0].shape[-2:]
    A = eps2.shape[-1]
    shapes = shapes or batch_shapes(S, A, B)
    if not table.holds(state, (S, A), tail, shapes):
        _bind_state(table, state, tail, shapes, S, A, st["a"][0].shape[1])
    return table.fill(tail + outs)


def sac_update(
    h: SACHyper, st: Dict, batch: Dict[str, torch.Tensor], eps2, eps_new
) -> Dict[str, torch.Tensor]:
    """One SAC update in place: the kernel on CUDA tensors, the plain
    version on CPU tensors. Returns (log_probs, Q_values, alpha).

    On the card the state's operands are checked and their pointers packed
    once (`pack` on `TABLE`, `sac_update.binds`): a later call on the same
    leaves checks and packs only the batch and the noise."""
    s = batch["states"]
    if s.is_cpu:  # raises unless every operand lies on the CPU
        operands.placement("sac_update", state_tensors(st) + _tail(batch, eps2, eps_new))
        return sac_update_plain(h, st, batch, eps2, eps_new)
    B, S = s.shape
    shape = (B, S, eps2.shape[1], st["a"][0].shape[1])
    outs = outputs(B, s.device)
    ptrs = pack(TABLE, st, batch, eps2, eps_new, outs)
    lib = _bind(build.load("sac_update"))
    scratch = torch.empty(lib.iltpu_sac_scratch_floats(*shape), device=s.device)
    aux = launch(lib, h, ptrs, shape, outs, scratch, operands.stream(TABLE.device))
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


MAX_PHASES = 32  # gx::MAX_PHASES: the per-phase arrays of `iltpu_sac_plan`
PICKS = ("32x32", "64x32", "32x64", "64x64", "cols", "cols/block")  # gx::StepPlan::tiles' digits - 1


def plan(lib, B: int, S: int, A: int, H: int, blocks: int) -> Dict:
    """The plan of one update at a shape on `blocks` blocks (a launch's
    grid: `grid`; the K-blocked kernel's SAC blocks), as the library makes
    it by running its update on the host with no data and as a launch on
    that grid runs it: `phases`, the grid barriers an update crosses (the
    K-blocked kernel's micro-update crosses as many); `row_items`, its
    row-owned work items (the narrow heads with their row steps);
    `gemm_rounds`, over the phases with a GEMM job, the rounds of their
    items over the blocks; and for each phase its `items`, `rounds` and
    `picks` (each GEMM job's tile, each column sum's item width: "cols" of
    64 threads, "cols/block")."""
    phases, row_items, rounds = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    items, phase_rounds, tiles = ((ctypes.c_int * MAX_PHASES)() for _ in range(3))
    _bind(lib).iltpu_sac_plan(B, S, A, H, blocks, ctypes.byref(phases), ctypes.byref(row_items),
                              ctypes.byref(rounds), items, phase_rounds, tiles)
    picks = []
    for code in tiles[:phases.value]:
        picks.append([])
        while code:
            picks[-1].append(PICKS[code % 8 - 1])
            code //= 8
    return {"phases": phases.value, "row_items": row_items.value, "gemm_rounds": rounds.value,
            "items": items[:phases.value], "rounds": phase_rounds[:phases.value], "picks": picks}


def _error(lib, rc: int) -> str:
    return f"CUDA error {rc} ({lib.iltpu_sac_error(rc).decode()})"


def entry_args(h: SACHyper, ptrs, shape, scratch: torch.Tensor) -> tuple:
    """The C entries' arguments before their own tail (the stream; the
    phase timer's stamps, then the stream): the pointer array (`pack`),
    the shape (B, S, A, H), the scalars, the scratch."""
    return (ptrs, *shape, *scalars(h), scratch.data_ptr())


def launch(lib, h: SACHyper, ptrs, shape, outs: List[torch.Tensor], scratch: torch.Tensor,
           stream: int) -> Dict[str, torch.Tensor]:
    """Call the library's C entry on `stream` with `ptrs` (`pack`, `outs`
    its outputs) and `scratch` (`iltpu_sac_scratch_floats` floats): one
    cooperative launch; raises if it failed or was refused. Returns the
    aux."""
    rc = lib.iltpu_sac_update(*entry_args(h, ptrs, shape, scratch), stream)
    if rc != 0:
        raise RuntimeError(f"sac_update kernel launch failed: {_error(lib, rc)}")
    lp, min_q, alpha = outs
    return {"log_probs": lp, "Q_values": min_q, "alpha": alpha[0]}


sac_update.launches = 0
sac_update.binds = 0
