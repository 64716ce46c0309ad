"""Weighted two-bandwidth Gaussian row sums, GMMIL's witness reward: the
port of `iltpu/ops/pallas_pairwise.py` (`_rowsum_kernel`).

  out[i] = sum_j (exp(-g1 d2[i, j]) + exp(-g2 d2[i, j])) w[j],
  d2[i, j] = max(|x_i|^2 + |y_j|^2 - 2 <x_i, y_j>, 0) / D

on x and y shifted by a shared centre. `gaussian_rowsum` is the entry: it
centres in plain PyTorch (as iltpu does outside its kernel), then on CUDA
tensors launches the hand-written kernel of `csrc/gaussian_rowsum.cu`
(built by nvcc at first use), which never writes the (n_x, n_y) matrix, and
raises if the launch fails; on CPU tensors it runs `rowsums_plain`, which
does. The bandwidths are 0-d or (1,) tensors and stay on the device.
"""

import ctypes

import torch

from iltpu_torch.ops import build, operands
from iltpu_torch.ops.pairwise import centre


def rowsums_plain(x, y, w_y, gamma_1, gamma_2) -> torch.Tensor:
    """The kernel's function on centred x (n_x, D) and y (n_y, D)."""
    x_sq = (x * x).sum(-1, keepdim=True)
    y_sq = (y * y).sum(-1, keepdim=True).T
    d2 = torch.clamp_min(x_sq + y_sq - 2.0 * (x @ y.T), 0.0) * (1.0 / x.shape[1])
    k = torch.exp(-gamma_1.reshape(()) * d2) + torch.exp(-gamma_2.reshape(()) * d2)
    return k @ w_y


def gaussian_rowsum_plain(x, y, w_y, gamma_1, gamma_2) -> torch.Tensor:
    return rowsums_plain(*centre(x, y), w_y, gamma_1, gamma_2)


def _bind(lib):
    """Set the C signature once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        lib.iltpu_gaussian_rowsum.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
            + [ctypes.c_void_p] * 2
        )
        lib.iltpu_gaussian_rowsum.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    """Call the library's C entry on centred, checked operands."""
    (nx, D), ny = x.shape, y.shape[0]
    out = torch.empty(nx, device=x.device)
    rc = lib.iltpu_gaussian_rowsum(
        x.data_ptr(), y.data_ptr(), w_y.data_ptr(), gamma_1.data_ptr(), gamma_2.data_ptr(),
        nx, ny, D, 1.0 / D, out.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"gaussian_rowsum kernel launch failed with CUDA error {rc}")
    return out


gaussian_rowsum.launches = 0


def gmmil_witness_reward(sa, esa, w, ew, gamma_1, gamma_2) -> torch.Tensor:
    """GMMIL's reward w_i [rowsum_expert(i) - rowsum_self(i)] with
    normalised weights and both bandwidths."""
    w_norm = w / w.sum()
    ew_norm = ew / ew.sum()
    sim = gaussian_rowsum(sa, esa, ew_norm, gamma_1, gamma_2)
    self_sim = gaussian_rowsum(sa, sa, w_norm, gamma_1, gamma_2)
    return w_norm * (sim - self_sim)
