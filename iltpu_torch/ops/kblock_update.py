"""K sequential GAIL+SAC micro-updates in one kernel: the port of
`iltpu/ops/pallas_fused_block.py` (`_kblock_kernel`).

  K x (GAIL step + reward head -> SAC step on those rewards), micro-update
  k+1 seeing micro-update k's parameters, as K calls of the two per-update
  kernels would.

`kblock_update` is the entry. On CUDA tensors it makes ONE cooperative,
persistent launch of `csrc/kblock_update.cu` (built by nvcc at first use),
which runs the arithmetic of the two per-update kernels (`csrc/*.cuh`), the
GAIL steps on the first blocks (one for a tiled step, a few for a wide one:
`grid`) beside the SAC steps on the others, and
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
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_float] * 12
            + [ctypes.c_void_p] * 2
        )
        lib.iltpu_kblock_update.restype = ctypes.c_int
        lib.iltpu_kblock_scratch_floats.argtypes = [ctypes.c_int] * 6
        lib.iltpu_kblock_scratch_floats.restype = ctypes.c_longlong
        lib.iltpu_kblock_grid.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
        lib.iltpu_kblock_grid.restype = ctypes.c_int
        lib.iltpu_kblock_error.argtypes = [ctypes.c_int]
        lib.iltpu_kblock_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


SAC_TABLE, GAIL_TABLE = operands.Table(), operands.Table()  # the kernel's launch tables


def pointers(sac_table: operands.Table, gail_table: operands.Table, sac_st: Dict, disc_st: Dict,
             batches: Dict[str, torch.Tensor], expert_batches: Dict[str, torch.Tensor],
             noise: Dict[str, torch.Tensor], outs):
    """The C entry's two pointer arrays: `sac_update.pack`'s in `sac_table`
    and `gail_update.pack`'s in `gail_table`, with the batch and noise
    pointers at the K-stacked slabs' bases (checked at those shapes) and
    the SAC batch's rewards at the GAIL step's rewards output, which each
    micro-update's GAIL step writes and its SAC step reads. `outs`: loss
    (1,), rewards, log_probs, Q_values (B,), alpha (1,). As in the
    per-update wrappers, each state is checked and packed once a table."""
    loss, rewards, lp, min_q, alpha = outs
    K, B, S = batches["states"].shape
    A = batches["actions"].shape[-1]
    mix = noise.get("mix")
    sac_shapes = su.batch_shapes(S, A, B, (K,))
    sac_shapes[su.BATCH_KEYS.index("rewards")] = (B,)  # one micro-update's, not a slab
    sac = su.pack(sac_table, sac_st, {**batches, "rewards": rewards}, noise["eps2"],
                  noise["eps_new"], [lp, min_q, alpha], sac_shapes)
    gail = gu.pack(gail_table, disc_st, expert_batches["states"], expert_batches["actions"],
                   expert_batches["weights"], batches["states"], batches["actions"],
                   batches["weights"], noise["eps_gp"], mix, (loss, rewards),
                   gu.batch_shapes(B, S, A, mix is not None, (K,)))
    return sac, gail


def entry_args(sac_hyper: su.SACHyper, gail_hyper: gu.GAILHyper, disc_st: Dict, mix, ptrs, shape,
               scratch: torch.Tensor) -> tuple:
    """The C entry's arguments before the stream: the two pointer arrays
    (`pointers`), the shape (K, B, S, A, H, Hd), the GAIL step's options,
    the SAC scalars, the GAIL scalars, the scratch."""
    return (*ptrs, *shape, *gu.options(gail_hyper, disc_st, mix), *su.scalars(sac_hyper),
            *gu.scalars(gail_hyper), scratch.data_ptr())


def kblock_update(
    sac_hyper: su.SACHyper, gail_hyper: gu.GAILHyper, sac_st: Dict, disc_st: Dict,
    batches: Dict[str, torch.Tensor], expert_batches: Dict[str, torch.Tensor],
    noise: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """K micro-updates in place: one kernel launch on CUDA tensors, the
    plain version on CPU tensors; the K-stacked shapes are checked on
    both (`pointers` on `SAC_TABLE` and `GAIL_TABLE`, the states once a
    table). Returns the last micro-update's aux."""
    mix = noise.get("mix")
    gu.check_hyper(gail_hyper, mix)
    K, B, S = batches["states"].shape
    dev = batches["states"].device
    outs = [torch.empty(n, device=dev) for n in (1, B, B, B, 1)]
    ptrs = pointers(SAC_TABLE, GAIL_TABLE, sac_st, disc_st, batches, expert_batches, noise, outs)
    if dev.type == "cpu":
        return kblock_update_plain(sac_hyper, gail_hyper, sac_st, disc_st, batches,
                                   expert_batches, noise)
    A = batches["actions"].shape[2]
    H = sac_st["a"][0].shape[1]
    Hd = disc_st["p"][0].shape[1]
    gu.smem_bytes(B, S + A, Hd)  # raises where no GAIL variant can take the shape
    lib = _bind(build.load("kblock_update"))
    scratch = torch.empty(lib.iltpu_kblock_scratch_floats(K, B, S, A, H, Hd), device=dev)
    rc = lib.iltpu_kblock_update(
        *entry_args(sac_hyper, gail_hyper, disc_st, mix, ptrs, (K, B, S, A, H, Hd), scratch),
        operands.stream(dev))
    if rc != 0:
        raise RuntimeError(f"kblock_update kernel launch failed: {_error(lib, rc)}")
    kblock_update.launches += 1
    loss, rewards, lp, min_q, alpha = outs
    return {"loss": loss, "rewards": rewards, "log_probs": lp, "Q_values": min_q, "alpha": alpha[0]}


def grid(lib, B: int, S: int, A: int, H: int, Hd: int):
    """(co-resident blocks per SM, SMs, dynamic shared memory bytes, the
    blocks that run GAIL): the launch's grid is the product of the first
    two; SAC runs on the blocks GAIL leaves."""
    per_sm, sms, smem, gail = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_int(0)
    rc = _bind(lib).iltpu_kblock_grid(B, S, A, H, Hd, ctypes.byref(per_sm), ctypes.byref(sms),
                                      ctypes.byref(smem), ctypes.byref(gail))
    if rc != 0:
        raise RuntimeError(f"kblock_update occupancy query failed: {_error(lib, rc)}")
    return per_sm.value, sms.value, smem.value, gail.value


def _error(lib, rc: int) -> str:
    return f"CUDA error {rc} ({lib.iltpu_kblock_error(rc).decode()})"


kblock_update.launches = 0
