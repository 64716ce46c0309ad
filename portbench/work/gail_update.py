"""The work of one GAIL discriminator step with its reward head
(`gail_kernel`, `gail_wide_kernel`), from its shapes: a frozen copy of the
arithmetic the port's kernel table was built on, every product and
elementwise term counted at one rate whatever unit the kernel runs.

B batch rows, D = S + A inputs, Hd the discriminator's width, one hidden
layer. `active` is the share of hidden units the penalty's interpolated
rows switch on (the W~1^T g product runs only over those): the work
depends on the data, so count what the inputs give. `mixup`: B loss rows
(convex combinations), else 2B (expert | policy).
"""

KERNEL = r"\bgail(_wide)?_kernel\b"  # the CUDA kernels' names in a device trace


def flops(B: int, D: int, Hd: int, active: float, mixup: bool) -> float:
    """The loss rows' forward and backward, the penalty rows' forward, g
    and W~1^T g, the weight gradients, the reward rows, and the width-Hd
    terms with the power iteration."""
    R = B if mixup else 2 * B
    products = 2 * D * Hd * (R + B * (2 + active) + (R + B) + B)
    rest = 2 * Hd * (R + (R + B) + B) + 4 * D * Hd
    return products + rest


def nbytes(B: int, S: int, A: int, Hd: int, sn: bool, mixup: bool) -> float:
    """The state (parameters, moments, spectral-norm vectors, clock) read
    and written, the expert and policy rows with weights, the penalty
    draw (and Mixup's) read, the loss and rewards written."""
    D = S + A
    params = D * Hd + 2 * Hd + 1
    state = 3 * params + (2 * Hd + D + 1 if sn else 0) + 1
    batch = 2 * B * (D + 1) + B + (B if mixup else 0)
    return 4 * (2 * state + batch + B + 1)


def active_share(gx, W1, b1) -> float:
    """The share of hidden units on over the penalty rows `gx` (B, D):
    the sign of gx W1 + b1, which dividing by sigma > 0 keeps."""
    return float(((gx @ W1 + b1) > 0).float().mean())
