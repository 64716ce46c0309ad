"""The work of one launch of the K-blocked kernel (`kblock_kernel`): K
micro-updates, each a GAIL discriminator step with its reward head and
then a SAC update on those rewards, from their shapes, every operation
counted at one rate as `work/gail_update.py` and `work/sac_update.py`
count them.

K micro-updates, S state features, A action size, B batch rows, H the
SAC networks' width, Hd the discriminator's. `active`: the share of the
discriminator's hidden units the penalty's rows switch on (one reading
stands for all K). Bytes: both states read and written once a launch (a
lower bound: the kernel may go back to them between micro-updates), each
micro-update's batch and draws read once, the last micro-update's outputs
written, in float32.
"""

from portbench.work import gail_update, sac_update

KERNEL = r"\bkblock_kernel\b"  # the CUDA kernel's name in a device trace


def flops(K: int, S: int, A: int, B: int, H: int, Hd: int, active: float, mixup: bool) -> float:
    return K * (sac_update.flops(S, A, B, H) + gail_update.flops(B, S + A, Hd, active, mixup))


def nbytes(K: int, S: int, A: int, B: int, H: int, Hd: int, sn: bool, mixup: bool) -> float:
    D, O = S + A, 2 * A
    actor = S * H + H + H * H + H + H * O + O
    critic = 2 * (D * H + H + H * H + H + H + 1)
    sac_state = 3 * actor + 4 * critic + 6  # parameters and moments, target, log alpha, clocks
    params = D * Hd + 2 * Hd + 1
    gail_state = 3 * params + (2 * Hd + D + 1 if sn else 0) + 1
    policy = B * (2 * S + A + 3)  # states, actions, next states, terminals, weights, absorbing
    expert = B * (D + 1)
    draws = B + 2 * B * A + (B if mixup else 0)  # penalty, SAC's two, Mixup's
    out = 1 + 3 * B + 1  # loss, rewards, log-probs, Q-values, alpha
    return 4 * (2 * (sac_state + gail_state) + K * (policy + expert + draws) + out)
