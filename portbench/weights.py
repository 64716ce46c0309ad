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


def make(seed: int, nets: Dict[str, Sequence[Tuple]], spectral: Sequence[str],
         device) -> Dict[str, List[torch.Tensor]]:
    """Weights for each network of `nets` (in order; leaf shapes [W1, b1,
    W2, b2, ...], (in, out) matrices, or (2, in, out) for a twin such as
    the critic). Returns {name: leaves} and "sn": the vectors [u1, v1, u2,
    v2, ...] of the matrices of the networks named in `spectral`."""
    g = torch.Generator(device=device).manual_seed(seed)
    mats = [(s, k) for k, shapes in nets.items() for s in shapes[0::2]]
    sizes = []
    for s, k in mats:
        n = 2 if len(s) == 3 else 1
        rows, cols = s[-2:]
        sizes.append(n * max(rows, cols) * min(rows, cols))
    sn_sizes = [s[-1] for k in spectral for s in nets[k][0::2]]
    draws = torch.randn(sum(sizes) + sum(sn_sizes), generator=g, device=device)
    chunks = list(torch.split(draws, sizes + sn_sizes))
    out = {k: [] for k in nets}
    out["sn"] = []
    # relu's gain on every layer but the last, 1 on the last
    gains = {k: [RELU_GAIN] * (len(v) // 2 - 1) + [1.0] for k, v in nets.items()}
    index = {k: 0 for k in nets}
    for (s, k), a in zip(mats, chunks):
        rows, cols = s[-2:]
        gain = gains[k][index[k]]
        index[k] += 1
        shape = (max(rows, cols), min(rows, cols))
        if len(s) == 3:
            a = a.reshape((2,) + shape)
            w = torch.stack([_orthogonal(a[i], rows, cols, gain) for i in range(2)])
            b = torch.zeros((2, cols), device=device)
        else:
            w = _orthogonal(a.reshape(shape), rows, cols, gain)
            b = torch.zeros(cols, device=device)
        out[k] += [w, b]
    spectral_mats = [w for k in spectral for w in out[k][0::2]]
    for w, u0 in zip(spectral_mats, chunks[len(mats):]):
        u = _unit(u0)
        v = _unit(w @ u)
        out["sn"] += [_unit(w.T @ v), v]
    return out
