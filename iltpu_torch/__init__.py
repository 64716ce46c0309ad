"""iltpu_torch — the PyTorch and CUDA port of iltpu for one NVIDIA H100.

SAC, BC, AdRIL/SQIL, DRIL, RED, GAIL/AIRL/FAIRL and GMMIL training, with the
same config tree and override syntax, parameter layouts and replay rules as
`iltpu`. Tensors live on the card; the SAC update, the GAIL update, the
K-blocked GAIL+SAC update and GMMIL's row sums are hand-written CUDA C++ for
Hopper (`csrc/`), each with a plain PyTorch version beside it, and the SAC
and GAIL updates also run in autograd (`updates/`). The package imports
neither JAX nor `iltpu`.
"""

__version__ = "0.1.0"
