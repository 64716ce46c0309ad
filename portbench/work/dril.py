"""The model FLOPs of one update of DRIL's training step (`Trainer.update`
with `algorithm=DRIL`): the ensemble's reward, the BC auxiliary step on the
SAC actor, then one SAC update. Counted from shapes, products at 2 FLOP a
multiply-add, the elementwise work left out, as `work/sac_update.py`
counts: a floor.

B batch rows, S state features, A action size, H the SAC networks' width
(actor depth 2); `ensemble`: the (in, out) shape of each of the dropout
MLP's layers, run once for each of the `MEMBERS` members on every row.
"""

from typing import Sequence, Tuple

from portbench.work import sac_update

MEMBERS = 5


def reward_flops(B: int, ensemble: Sequence[Tuple[int, int]]) -> float:
    """The members' forwards over the batch."""
    return 2 * MEMBERS * B * sum(i * o for i, o in ensemble)


def bc_flops(S: int, A: int, B: int, H: int) -> float:
    """The actor's forward on B rows, and its backward: every layer's weight
    gradient, and the input gradient of all but the first layer."""
    layers = ((S, H), (H, H), (H, 2 * A))
    forward = 2 * B * sum(i * o for i, o in layers)
    backward = 2 * B * (2 * sum(i * o for i, o in layers) - S * H)
    return forward + backward


def flops(S: int, A: int, B: int, H: int, ensemble: Sequence[Tuple[int, int]]) -> float:
    return reward_flops(B, ensemble) + bc_flops(S, A, B, H) + sac_update.flops(S, A, B, H)
