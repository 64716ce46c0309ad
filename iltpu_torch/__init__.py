"""iltpu_torch — the PyTorch and CUDA port of iltpu for one NVIDIA H100.

The same GAIL/SAC training path as `iltpu`, with the same config tree and
override syntax, parameter layouts and replay rules. Tensors live on the
card; the two update kernels of the fused update loop (SAC and GAIL) are
hand-written CUDA C++ for Hopper (`csrc/`), each with a plain PyTorch
version beside it. The package imports neither JAX nor `iltpu`.
"""

__version__ = "0.1.0"
