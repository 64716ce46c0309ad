"""PWIL's greedy transport: the hand-written kernel behind the PWIL reward.

It replaces iltpu's `lax.while_loop` (`iltpu/rewards/pwil.py:107`), vmapped
over the envs (`iltpu/trainer.py:495-510`), and the expert relabelling's
`lax.scan` (`:512-533`). One entry serves both:

  pwil_transport(atoms (N, d), pools (P, N), queries (R, d), offsets (P+1,)
                 int32, reset (R,) bool, *, atom_weight, agent_weight,
                 bandwidth, scale) -> rewards (R,)

Pool p takes the query rows offsets[p] .. offsets[p+1]-1 in order. For each
row: its distances to the atoms, then, while the agent's weight is > 0 and
an atom has mass left, the nearest such atom (the first on a tie) gives
consume = min(weight, mass): cost += consume * distance, mass -= consume,
weight -= consume. The reward is scale * exp(-bandwidth * cost). After a
row whose reset flag is set, its pool is refilled with `atom_weight`. The
pools are updated in place.

On CUDA tensors ONE launch of `csrc/pwil_transport.cu` (built by nvcc at
first use), counted in `pwil_transport.launches`; it raises if the launch
fails or its thread-block cluster cannot be scheduled. The kernel reads the
atoms feature-major, (d, N): `feature_major` makes that copy once and keeps
it on the atoms tensor until the tensor is written. A row's rounds take the
atoms in ascending (distance, index) order (a fully consumed atom is spent
exactly; only the last one is left partly consumed), so the kernel selects
each row's 32 smallest keys in one pass over the atoms and walks them, with
another pass only where the weight outlasts them. On CPU tensors
`pwil_transport_plain` runs: the same formulas in PyTorch over all pools at
once, one round of the greedy loop a step, with a host read per round to
stop. The weights are float32 throughout; the distances sum the squared
features in order, each product and sum rounded on its own, as the kernel
does, so both take the same nearest atoms and their pools agree bit for
bit.
"""

import ctypes
from typing import Tuple

import torch

from iltpu_torch.ops import build, operands

MAX_D = 128  # features per atom the kernel takes (ant's atoms: 120)


def distances(atoms: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(M, N) Euclidean distances of the query rows (M, d) to the atoms (N,
    d): the squared differences summed feature by feature, then the root."""
    acc = None
    for k in range(atoms.shape[1]):
        t = atoms[None, :, k] - queries[:, None, k]
        acc = t * t if acc is None else acc + t * t
    return torch.sqrt(acc)


@torch.no_grad()
def greedy_rows(pool: torch.Tensor, dist: torch.Tensor, agent_weight: float) -> Tuple[torch.Tensor, int]:
    """The greedy loop for M pools at once, one query row each: `pool` (M,
    N) is updated in place; returns (the cost (M,), the rounds run)."""
    M = pool.shape[0]
    rows = torch.arange(M, device=pool.device)
    weight = torch.full((M,), agent_weight, device=pool.device)
    cost = torch.zeros(M, device=pool.device)
    inf = torch.full((), float("inf"), device=pool.device)
    rounds = 0
    while True:
        alive = pool > 0.0
        active = (weight > 0.0) & alive.any(1)
        if not bool(active.any()):  # the host read of each round
            return cost, rounds
        i = torch.argmin(torch.where(alive, dist, inf), 1)  # the first minimum
        ew, d_i = pool[rows, i], dist[rows, i]
        consume = torch.where(active, torch.minimum(weight, ew), 0.0)
        cost = cost + consume * d_i
        pool[rows, i] = ew - consume
        weight = weight - consume
        rounds += 1


@torch.no_grad()
def pwil_transport_plain(
    atoms, pools, queries, offsets, reset, *, atom_weight: float, agent_weight: float,
    bandwidth: float, scale: float, count_rounds: bool = False,
):
    """The kernel's function in PyTorch: the segments' k-th rows of every
    pool at once, k = 0, 1, ...; with `count_rounds`, also the greedy
    rounds run over all rows (the work a launch does depends on them)."""
    off = offsets.tolist()
    P, R = pools.shape[0], queries.shape[0]
    lengths = [max(0, min(off[p + 1], R) - max(off[p], 0)) for p in range(P)]
    rewards = torch.zeros(R, device=queries.device)
    rounds = 0
    for k in range(max(lengths, default=0)):
        live = [p for p in range(P) if lengths[p] > k]
        pidx = torch.tensor(live, device=pools.device)
        ridx = torch.tensor([off[p] + k for p in live], device=pools.device)
        pool = pools[pidx]
        cost, n = greedy_rows(pool, distances(atoms, queries[ridx]), agent_weight)
        rounds += n * len(live)
        rewards[ridx] = scale * torch.exp(cost * -bandwidth)
        pool = torch.where(reset[ridx][:, None], torch.full_like(pool, atom_weight), pool)
        pools[pidx] = pool
    return (rewards, rounds) if count_rounds else rewards


# The C entry's argument types before its own tail, as `entry_args` lays them out.
ENTRY_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4


def _bind(lib):
    """Set the C signatures once, so no pointer is cut to 32 bits."""
    if not hasattr(lib, "_typed"):
        I = ctypes.c_int
        lib.iltpu_pwil_transport.argtypes = ENTRY_ARGTYPES + [ctypes.c_void_p]
        lib.iltpu_pwil_transport.restype = I
        lib.iltpu_pwil_cluster_size.argtypes = [I, I]
        lib.iltpu_pwil_cluster_size.restype = I
        lib.iltpu_pwil_error.argtypes = [I]
        lib.iltpu_pwil_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def feature_major(atoms: torch.Tensor) -> torch.Tensor:
    """The atoms (N, d) as a contiguous (d, N) copy, made once and kept on
    the atoms tensor until it is written (its version counter moves)."""
    kept = getattr(atoms, "_iltpu_feature_major", None)
    if kept is None or kept[0] != atoms._version:
        kept = (atoms._version, atoms.t().contiguous())
        atoms._iltpu_feature_major = kept
    return kept[1]


def cluster_size(P: int, N: int) -> int:
    """CTAs the kernel gives each of P pools of N atoms (1: no cluster)."""
    lib = _bind(build.load("pwil_transport"))
    c = lib.iltpu_pwil_cluster_size(P, N)
    if c < 1:
        raise RuntimeError(f"pwil_transport cluster size: {lib.iltpu_pwil_error(c).decode()}")
    return c


def _check(atoms, pools, queries, offsets, reset) -> None:
    (N, d), P, R = atoms.shape, pools.shape[0], queries.shape[0]
    operands.check("pwil_transport", [atoms, pools, queries], [(N, d), (P, N), (R, d)])
    for name, t, dtype, shape in (("offsets", offsets, torch.int32, (P + 1,)),
                                  ("reset", reset, torch.bool, (R,))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"pwil_transport {name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if d > MAX_D:
        raise NotImplementedError(f"the pwil_transport kernel takes atoms of at most {MAX_D} "
                                  f"features, got {d}")


def pwil_transport(atoms, pools, queries, offsets, reset, *, atom_weight: float,
                   agent_weight: float, bandwidth: float, scale: float) -> torch.Tensor:
    """The rewards (R,), the pools updated in place: one kernel launch on
    CUDA tensors, the plain version on CPU tensors."""
    args = dict(atom_weight=atom_weight, agent_weight=agent_weight, bandwidth=bandwidth,
                scale=scale)
    ops = [atoms, pools, queries, offsets, reset]
    if operands.placement("pwil_transport", ops) == "cpu":
        return pwil_transport_plain(*ops, **args)
    _check(*ops)
    out = launch(_bind(build.load("pwil_transport")), *ops, **args,
                 stream=torch.cuda.current_stream(atoms.device).cuda_stream)
    pwil_transport.launches += 1
    return out


def entry_args(atoms, pools, queries, offsets, reset, rewards, *, atom_weight, agent_weight,
               bandwidth, scale) -> tuple:
    """The C entry's arguments before its own tail (the stream; the phase
    timer's: the stream, then stamps): the operands' and the rewards'
    pointers, the atoms in `feature_major` order, then the sizes (P, N, d,
    R) and the weights."""
    (N, d), P, R = atoms.shape, pools.shape[0], queries.shape[0]
    return (feature_major(atoms).data_ptr(), pools.data_ptr(), queries.data_ptr(),
            offsets.data_ptr(), reset.data_ptr(), rewards.data_ptr(), P, N, d, R, atom_weight,
            agent_weight, bandwidth, scale)


def launch(lib, atoms, pools, queries, offsets, reset, *, atom_weight, agent_weight, bandwidth,
           scale, stream: int) -> torch.Tensor:
    """Call the C entry on checked operands; the rewards come from
    torch.empty."""
    rewards = torch.empty(queries.shape[0], device=atoms.device)
    rc = lib.iltpu_pwil_transport(
        *entry_args(atoms, pools, queries, offsets, reset, rewards, atom_weight=atom_weight,
                    agent_weight=agent_weight, bandwidth=bandwidth, scale=scale), stream)
    if rc != 0:
        raise RuntimeError(f"pwil_transport kernel launch failed: CUDA error {rc} "
                           f"({lib.iltpu_pwil_error(rc).decode()})")
    return rewards


pwil_transport.launches = 0
