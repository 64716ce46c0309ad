"""K sequential GAIL+SAC micro-updates in one kernel: the port of
`iltpu/ops/pallas_fused_block.py` (`_kblock_kernel`).

  K x (GAIL step + reward head -> SAC step on those rewards), micro-update
  k+1 seeing micro-update k's parameters, as K calls of the two per-update
  kernels would.

`kblock_update` is the entry. On CUDA tensors it makes ONE cooperative,
persistent launch of `csrc/kblock_update.cu` (built by nvcc at first use),
which runs the arithmetic of the two per-update kernels (`csrc/*.cuh`), the
GAIL steps on one block beside the SAC steps on the others, and
raises if the launch fails or the grid is refused; on CPU tensors it runs
`kblock_update_plain`, the two plain updates K times in order.

The states are `ops.sac_update`'s and `ops.gail_update`'s dicts, updated IN
PLACE. The batches are K-stacked and contiguous: `batches` holds states,
actions, next_states (K, B, .), terminals, weights, absorbing (K, B);
`expert_batches` states, actions (K, B, .) and weights (K, B); `noise`
eps_gp (K, B), eps2 and eps_new (K, B, A) and, for the Mixup loss only, mix
(K, B). The return is the LAST micro-update's aux: loss (1,), rewards,
log_probs, Q_values (B,) and the pre-update alpha.
"""

import ctypes
from typing import Dict

import torch

from iltpu_torch.ops import build, operands
from iltpu_torch.ops import gail_update as gu
from iltpu_torch.ops import sac_update as su

POLICY_KEYS = ("states", "actions", "next_states", "terminals", "weights", "absorbing")
EXPERT_KEYS = ("states", "actions", "weights")
NOISE_KEYS = ("eps_gp", "eps2", "eps_new")


@torch.no_grad()
def kblock_update_plain(
    sac_hyper: su.SACHyper, gail_hyper: gu.GAILHyper, sac_st: Dict, disc_st: Dict,
    batches: Dict[str, torch.Tensor], expert_batches: Dict[str, torch.Tensor],
    noise: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """K x (gail_update_plain -> sac_update_plain) in place, in order."""
    mix = noise.get("mix")
    for k in range(batches["states"].shape[0]):
        tb = {key: batches[key][k] for key in POLICY_KEYS}
        eb = {key: expert_batches[key][k] for key in EXPERT_KEYS}
        loss, tb["rewards"] = gu.gail_update_plain(
            gail_hyper, disc_st, eb["states"], eb["actions"], eb["weights"],
            tb["states"], tb["actions"], tb["weights"], noise["eps_gp"][k],
            None if mix is None else mix[k],
        )
        aux = su.sac_update_plain(sac_hyper, sac_st, tb, noise["eps2"][k], noise["eps_new"][k])
    return {"loss": loss, "rewards": tb["rewards"], **aux}


def _bind(lib):
    """Set the C signatures once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        lib.iltpu_kblock_update.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_float] * 11
            + [ctypes.c_void_p] * 2
        )
        lib.iltpu_kblock_update.restype = ctypes.c_int
        lib.iltpu_kblock_scratch_floats.argtypes = [ctypes.c_int] * 5
        lib.iltpu_kblock_scratch_floats.restype = ctypes.c_longlong
        lib.iltpu_kblock_grid.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
        lib.iltpu_kblock_grid.restype = ctypes.c_int
        lib.iltpu_kblock_error.argtypes = [ctypes.c_int]
        lib.iltpu_kblock_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _batch_operands(batches, expert_batches, noise):
    mix = noise.get("mix")
    return (
        [batches[k] for k in POLICY_KEYS] + [expert_batches[k] for k in EXPERT_KEYS]
        + [noise[k] for k in NOISE_KEYS] + ([mix] if mix is not None else [])
    )


def kblock_update(
    sac_hyper: su.SACHyper, gail_hyper: gu.GAILHyper, sac_st: Dict, disc_st: Dict,
    batches: Dict[str, torch.Tensor], expert_batches: Dict[str, torch.Tensor],
    noise: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """K micro-updates in place: one kernel launch on CUDA tensors, the
    plain version on CPU tensors; the K-stacked shapes are checked on
    both. Returns the last micro-update's aux."""
    mix = noise.get("mix")
    gu.check_hyper(gail_hyper, mix)
    ops = (su.state_tensors(sac_st) + gu.state_tensors(disc_st)
           + _batch_operands(batches, expert_batches, noise))
    device = operands.placement("kblock_update", ops)
    K, B, S = batches["states"].shape
    A = batches["actions"].shape[-1]
    H = sac_st["a"][0].shape[1]
    D, Hd = disc_st["p"][0].shape
    if D != S + A:
        raise ValueError(f"discriminator input {D} != state {S} + action {A}")
    rows, cols = (K, B), (K, B, S)
    operands.check("kblock_update", ops, (
        su.state_shapes(S, A, H) + gu.state_shapes(D, Hd, bool(disc_st["sn"]))
        + [cols, (K, B, A), cols, rows, rows, rows]  # policy
        + [cols, (K, B, A), rows]  # expert
        + [rows, (K, B, A), (K, B, A)] + ([rows] if mix is not None else [])  # noise
    ))
    if device == "cpu":
        return kblock_update_plain(sac_hyper, gail_hyper, sac_st, disc_st, batches,
                                   expert_batches, noise)
    gu.smem_bytes(B, D, Hd)  # raises where the GAIL step cannot take the shape
    aux = launch(_bind(build.load("kblock_update")), sac_hyper, gail_hyper, sac_st, disc_st,
                 batches, expert_batches, noise, torch.cuda.current_stream(ops[0].device).cuda_stream)
    kblock_update.launches += 1
    return aux


def grid(lib, B: int, S: int, A: int, H: int, Hd: int):
    """(co-resident blocks per SM, SMs, dynamic shared memory bytes): the
    launch's grid is the product of the first two."""
    per_sm, sms, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    rc = _bind(lib).iltpu_kblock_grid(B, S, A, H, Hd, ctypes.byref(per_sm), ctypes.byref(sms),
                                      ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"kblock_update occupancy query failed: {_error(lib, rc)}")
    return per_sm.value, sms.value, smem.value


def _error(lib, rc: int) -> str:
    return f"CUDA error {rc} ({lib.iltpu_kblock_error(rc).decode()})"


def launch(lib, sac_hyper, gail_hyper, sac_st, disc_st, batches, expert_batches, noise,
           stream: int):
    """Pack the two per-update pointer layouts (batch and noise pointers at
    the slab bases, the SAC rewards at the GAIL rewards output) and call
    the library's C entry on `stream`; raises if the launch failed or was
    refused. Outputs and scratch come from torch.empty."""
    K, B, S = batches["states"].shape
    A = batches["actions"].shape[2]
    H = sac_st["a"][0].shape[1]
    Hd = disc_st["p"][0].shape[1]
    mix = noise.get("mix")
    bce = int(mix is None)
    dev = batches["states"].device
    loss, alpha = torch.empty(1, device=dev), torch.empty(1, device=dev)
    rewards, lp, min_q = (torch.empty(B, device=dev) for _ in range(3))
    scratch = torch.empty(lib.iltpu_kblock_scratch_floats(K, B, S, A, H), device=dev)
    tb, eb = batches, expert_batches
    sac_ptrs = [t.data_ptr() for t in su.state_tensors(sac_st)] + [
        t.data_ptr() for t in (tb["states"], tb["actions"], rewards, tb["next_states"],
                               tb["terminals"], tb["weights"], tb["absorbing"], noise["eps2"],
                               noise["eps_new"], lp, min_q, alpha)
    ]
    gail_ptrs = gu.state_pointers(disc_st) + [
        t.data_ptr() for t in (eb["states"], eb["actions"], eb["weights"], tb["states"],
                               tb["actions"], tb["weights"], noise["eps_gp"])
    ] + [0 if mix is None else mix.data_ptr(), loss.data_ptr(), rewards.data_ptr()]
    h, g = sac_hyper, gail_hyper
    rc = lib.iltpu_kblock_update(
        (ctypes.c_void_p * len(sac_ptrs))(*sac_ptrs), (ctypes.c_void_p * len(gail_ptrs))(*gail_ptrs),
        K, B, S, A, H, Hd, int(bool(disc_st["sn"])), bce,
        gu.REWARD_FUNCTIONS.index(g.reward_function),
        h.lr, h.weight_decay, h.alpha_lr, h.discount, h.entropy_target, h.polyak, h.min_alpha,
        g.grad_penalty, g.lr, g.weight_decay, g.entropy_bonus, scratch.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"kblock_update kernel launch failed: {_error(lib, rc)}")
    return {"loss": loss, "rewards": rewards, "log_probs": lp, "Q_values": min_q, "alpha": alpha[0]}


kblock_update.launches = 0
