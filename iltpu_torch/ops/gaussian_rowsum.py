"""Weighted two-bandwidth Gaussian row sums, GMMIL's witness reward: the
port of `iltpu/ops/pallas_pairwise.py` (`_rowsum_kernel`).

  rowsum(x, y, w)[i] = sum_j (exp(-g1 d2[i, j]) + exp(-g2 d2[i, j])) w[j],
  d2[i, j] = max(|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>, 0) / D

on x and y shifted by a shared centre. Two entries over one hand-written
kernel (`csrc/gaussian_rowsum.cu`, built by nvcc at first use), which never
writes the (n_x, n_y) matrix:

- `gmmil_witness_reward`, GMMIL's whole reward w~_i (rowsum(sa, esa, ew~)
  - rowsum(sa, sa, w~)) with normalised weights: on CUDA tensors ONE launch
  that also centres both pairs and normalises both weights;
- `gaussian_rowsum`, one row sum: it centres in plain PyTorch (as iltpu does
  outside its kernel), then launches the kernel.

Each counts its own launches; on CPU tensors each runs its plain version
(`gmmil_witness_reward_plain`, `rowsums_plain`), and on CUDA tensors it
launches or raises. The bandwidths are 0-d or (1,) tensors and stay on the
device.
"""

import ctypes

import torch

from iltpu_torch.ops import build, operands
from iltpu_torch.ops.pairwise import centre


def rowsums_plain(x, y, w_y, gamma_1, gamma_2) -> torch.Tensor:
    """The kernel's row sum on centred x (n_x, D) and y (n_y, D)."""
    x_sq = (x * x).sum(-1, keepdim=True)
    y_sq = (y * y).sum(-1, keepdim=True).T
    d2 = torch.clamp_min(x_sq + y_sq - 2.0 * (x @ y.T), 0.0) * (1.0 / x.shape[1])
    k = torch.exp(-gamma_1.reshape(()) * d2) + torch.exp(-gamma_2.reshape(()) * d2)
    return k @ w_y


def gaussian_rowsum_plain(x, y, w_y, gamma_1, gamma_2) -> torch.Tensor:
    return rowsums_plain(*centre(x, y), w_y, gamma_1, gamma_2)


def gmmil_witness_reward_plain(sa, esa, w, ew, gamma_1, gamma_2) -> torch.Tensor:
    """The fused kernel's function: both centrings, both normalisations,
    both row sums and the weighted difference."""
    w_norm = w / w.sum()
    ew_norm = ew / ew.sum()
    sim = rowsums_plain(*centre(sa, esa), ew_norm, gamma_1, gamma_2)
    self_sim = rowsums_plain(*centre(sa, sa), w_norm, gamma_1, gamma_2)
    return w_norm * (sim - self_sim)


def _bind(lib):
    """Set the C signatures once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.iltpu_gaussian_rowsum.argtypes = [P] * 5 + [I] * 3 + [ctypes.c_float] + [P] * 3
        lib.iltpu_gaussian_rowsum.restype = I
        lib.iltpu_gmmil_reward.argtypes = [P] * 6 + [I] * 3 + [ctypes.c_float] + [P] * 3
        lib.iltpu_gmmil_reward.restype = I
        lib.iltpu_rowsum_scratch_floats.argtypes = [I] * 4
        lib.iltpu_rowsum_scratch_floats.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _scratch(lib, nx: int, ny: int, D: int, fused: int, device) -> torch.Tensor:
    """The chunks' partial sums and the tiles' counters (zeroed by the C
    entry on the stream)."""
    n = lib.iltpu_rowsum_scratch_floats(nx, ny, D, fused)
    if n < 0:
        raise ValueError(f"the row-sum kernel cannot take {nx} x {ny} rows of {D} features")
    return torch.empty(n, device=device)


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def gaussian_rowsum(x, y, w_y, gamma_1, gamma_2) -> torch.Tensor:
    """(n_x,) row sums: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    xc, yc = centre(x, y)
    g1, g2 = gamma_1.reshape(1), gamma_2.reshape(1)
    ops = [xc, yc, w_y, g1, g2]
    if operands.placement("gaussian_rowsum", ops) == "cpu":
        return rowsums_plain(xc, yc, w_y, g1, g2)
    (nx, D), ny = xc.shape, yc.shape[0]
    operands.check("gaussian_rowsum", ops, [(nx, D), (ny, D), (ny,), (1,), (1,)])
    out = launch(_bind(build.load("gaussian_rowsum")), xc, yc, w_y, g1, g2,
                 torch.cuda.current_stream(xc.device).cuda_stream)
    gaussian_rowsum.launches += 1
    return out


def launch(lib, x, y, w_y, gamma_1, gamma_2, stream: int) -> torch.Tensor:
    """Call the single row sum's C entry on centred, checked operands."""
    (nx, D), ny = x.shape, y.shape[0]
    out = torch.empty(nx, device=x.device)
    scratch = _scratch(lib, nx, ny, D, 0, x.device)
    _check_rc("gaussian_rowsum", lib.iltpu_gaussian_rowsum(
        x.data_ptr(), y.data_ptr(), w_y.data_ptr(), gamma_1.data_ptr(), gamma_2.data_ptr(),
        nx, ny, D, 1.0 / D, out.data_ptr(), scratch.data_ptr(), stream))
    return out


gaussian_rowsum.launches = 0


def gmmil_witness_reward(sa, esa, w, ew, gamma_1, gamma_2) -> torch.Tensor:
    """GMMIL's reward w~_i [rowsum_expert(i) - rowsum_self(i)] with
    normalised weights and both bandwidths: one kernel launch on CUDA
    tensors, the plain version on CPU tensors."""
    g1, g2 = gamma_1.reshape(1), gamma_2.reshape(1)
    ops = [sa, esa, w, ew, g1, g2]
    if operands.placement("gmmil_witness_reward", ops) == "cpu":
        return gmmil_witness_reward_plain(sa, esa, w, ew, g1, g2)
    (B, D), E = sa.shape, esa.shape[0]
    operands.check("gmmil_witness_reward", ops, [(B, D), (E, D), (B,), (E,), (1,), (1,)])
    out = launch_reward(_bind(build.load("gaussian_rowsum")), sa, esa, w, ew, g1, g2,
                        torch.cuda.current_stream(sa.device).cuda_stream)
    gmmil_witness_reward.launches += 1
    return out


def launch_reward(lib, sa, esa, w, ew, gamma_1, gamma_2, stream: int) -> torch.Tensor:
    """Call the fused reward's C entry on checked operands."""
    (B, D), E = sa.shape, esa.shape[0]
    out = torch.empty(B, device=sa.device)
    scratch = _scratch(lib, B, E, D, 1, sa.device)
    _check_rc("gmmil_witness_reward", lib.iltpu_gmmil_reward(
        sa.data_ptr(), esa.data_ptr(), w.data_ptr(), ew.data_ptr(), gamma_1.data_ptr(),
        gamma_2.data_ptr(), B, E, D, 1.0 / D, out.data_ptr(), scratch.data_ptr(), stream))
    return out


gmmil_witness_reward.launches = 0
