"""The work of one SAC update (`sac_kernel`), from its shapes: a frozen copy
of the arithmetic the port's kernel table was built on, every operation
counted at one rate.

S state features, A action size, B batch rows, H hidden width (actor and
twin critic, depth 2). Products at 2 FLOP a multiply-add; the elementwise
work (under 1% of the products) is left out, so the count is a floor.
Bytes: each input read once and each output written once, in float32.
"""

KERNEL = r"\bsac_kernel\b"  # the CUDA kernel's name in a device trace


def flops(S: int, A: int, B: int, H: int) -> float:
    """The products of one update: the actor on s and s', the twin critic
    on (s, a), (s', a') and (s, a~), the critic's backward, the input
    gradient of the updated critic, the actor's backward."""
    X, O = S + A, 2 * A
    actor_fwd = 2 * B * (S * H + H * H + H * O)
    twin_fwd = 2 * 2 * B * (X * H + H * H + H)
    critic_bwd = 2 * 2 * (H * B + B * H + H * H * B + B * H * H + X * H * B)
    input_grad = 2 * 2 * (B * H + B * H * H + B * A * H)
    actor_bwd = 2 * (H * O * B + B * H * O + H * H * B + B * H * H + S * H * B)
    return 2 * actor_fwd + 3 * twin_fwd + critic_bwd + input_grad + actor_bwd


def nbytes(S: int, A: int, B: int, H: int) -> float:
    """The state read and written (parameters, moments, target, log alpha
    and clocks), the batch and both noise draws read, the outputs
    (log-probs, Q-values, alpha) written."""
    X, O = S + A, 2 * A
    actor = S * H + H + H * H + H + H * O + O
    critic = 2 * (X * H + H + H * H + H + H + 1)
    state = 3 * actor + 4 * critic + 6
    batch = B * (2 * S + A + 4) + 2 * B * A
    return 4 * (2 * state + batch + 2 * B + 1)
