"""The benchmark's weights: made from the seed on the device, in float32 (the
type the trainer trains in), and handed the same to the program and to the
plain reference.

Each matrix is orthogonal with its activation's gain (sqrt 2 under relu, 1
for a last layer), biases zero, as iltpu initialises its networks; a
spectral-norm layer gets the vectors of one power iteration from a random
unit vector. All Gaussian draws come from one call on one generator on the
device.
"""

import math
from typing import Dict, List, Sequence, Tuple

import torch

RELU_GAIN = math.sqrt(2.0)


def _orthogonal(a: torch.Tensor, rows: int, cols: int, gain: float) -> torch.Tensor:
    """(rows, cols) with orthonormal columns (rows >= cols) or rows, from the
    Gaussian block `a` of shape (max, min)."""
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (gain * (q.T if rows < cols else q)).contiguous()


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + 1e-12)


def make(seed: int, actor: Sequence[Tuple], critic: Sequence[Tuple], disc: Sequence[Tuple],
         spectral_norm: bool, device) -> Dict[str, List[torch.Tensor]]:
    """Weights for leaf shapes [W1, b1, W2, b2, ...]: `actor` (in, out)
    matrices, `critic` (2, in, out) twin matrices, `disc` (in, out)
    matrices. Returns {"actor", "critic", "disc", "sn"} leaf lists ("sn":
    [u1, v1, u2, v2, ...] when `spectral_norm`)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mats = [(s, k) for k, shapes in (("actor", actor), ("critic", critic), ("disc", disc))
            for s in shapes[0::2]]
    sizes = []
    for s, k in mats:
        n = 2 if k == "critic" else 1
        rows, cols = s[-2:]
        sizes.append(n * max(rows, cols) * min(rows, cols))
    sn_sizes = [s[-1] for s in disc[0::2]] if spectral_norm else []
    draws = torch.randn(sum(sizes) + sum(sn_sizes), generator=g, device=device)
    chunks = list(torch.split(draws, sizes + sn_sizes))
    out = {"actor": [], "critic": [], "disc": [], "sn": []}
    # relu's gain on every layer but the last, 1 on the last
    gains = {k: [RELU_GAIN] * (len(v) // 2 - 1) + [1.0]
             for k, v in (("actor", actor), ("critic", critic), ("disc", disc))}
    index = {"actor": 0, "critic": 0, "disc": 0}
    for (s, k), a in zip(mats, chunks):
        rows, cols = s[-2:]
        gain = gains[k][index[k]]
        index[k] += 1
        shape = (max(rows, cols), min(rows, cols))
        if k == "critic":
            a = a.reshape((2,) + shape)
            w = torch.stack([_orthogonal(a[i], rows, cols, gain) for i in range(2)])
            b = torch.zeros((2, cols), device=device)
        else:
            w = _orthogonal(a.reshape(shape), rows, cols, gain)
            b = torch.zeros(cols, device=device)
        out[k] += [w, b]
    for w, u0 in zip(out["disc"][0::2], chunks[len(mats):]):
        u = _unit(u0)
        v = _unit(w @ u)
        out["sn"] += [_unit(w.T @ v), v]
    return out
