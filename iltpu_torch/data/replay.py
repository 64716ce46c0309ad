"""Ring replay buffer on the device with DAC absorbing-state handling: the
port of `iltpu/data/replay.py`.

Same semantics: batched appends write each transition and, when it truly
terminates in an absorbing buffer, an absorbing self-loop row right after
it (the transition itself is redirected to the absorbing state with its
terminal cleared); ring offsets come from a cumsum over the valid rows;
sampling is uniform and never returns the most recent write; the
`absorbing` flag of a sampled row is its state's trailing bit.

Every column has one spare row past the ring (index `size`) that takes the
writes of invalid rows, so an append is one scatter per column with no host
synchronisation; sampling never reaches that row. The scalar fields stay on
the device as 0-d tensors. The buffer is updated in place, its scalars
too, so a CUDA graph that captured an append or a sample replays against
the live buffer.
"""

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

COLUMNS = ("step", "states", "actions", "rewards", "next_states", "terminals", "timeouts", "weights")


@dataclass
class ReplayState:
    step: torch.Tensor  # (size + 1,)
    states: torch.Tensor  # (size + 1, S)
    actions: torch.Tensor  # (size + 1, A)
    rewards: torch.Tensor  # (size + 1,)
    next_states: torch.Tensor  # (size + 1, S)
    terminals: torch.Tensor  # (size + 1,)
    timeouts: torch.Tensor  # (size + 1,)
    weights: torch.Tensor  # (size + 1,)
    idx: torch.Tensor  # int64 0-d: next write position
    full: torch.Tensor  # bool 0-d: has the ring wrapped
    num_trajectories: torch.Tensor  # int64 0-d
    size: int
    absorbing: bool

    def rows(self, name: str) -> torch.Tensor:
        """Column `name` without the spare row."""
        return getattr(self, name)[: self.size]


def replay_init(size: int, state_size: int, action_size: int, absorbing: bool, device=None) -> ReplayState:
    z = lambda *shape: torch.zeros(*shape, device=device)
    n = size + 1
    return ReplayState(
        step=z(n), states=z(n, state_size), actions=z(n, action_size), rewards=z(n),
        next_states=z(n, state_size), terminals=z(n), timeouts=z(n), weights=z(n),
        idx=torch.zeros((), dtype=torch.int64, device=device),
        full=torch.zeros((), dtype=torch.bool, device=device),
        num_trajectories=torch.zeros((), dtype=torch.int64, device=device),
        size=size,
        absorbing=absorbing,
    )


def replay_from_transitions(
    transitions: Dict[str, np.ndarray], num_trajectories: int, absorbing: bool, device=None
) -> ReplayState:
    """Expert buffer sized to the dataset, step column 1..N, marked full."""
    n = int(np.asarray(transitions["states"]).shape[0])

    def col(x):
        x = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return torch.cat([x, torch.zeros((1,) + x.shape[1:], device=device)])

    return ReplayState(
        step=col(np.arange(1, n + 1, dtype=np.float32)),
        **{k: col(transitions[k]) for k in COLUMNS[1:]},
        idx=torch.zeros((), dtype=torch.int64, device=device),
        full=torch.ones((), dtype=torch.bool, device=device),
        num_trajectories=torch.tensor(num_trajectories, dtype=torch.int64, device=device),
        size=n,
        absorbing=absorbing,
    )


def _absorbing_state(state_size: int, device) -> torch.Tensor:
    """Zeros with the indicator bit last, made on the device (no copy from
    the host, which a CUDA graph capture refuses)."""
    return (torch.arange(state_size, device=device) == state_size - 1).float()


def replay_append_batch(
    rs: ReplayState,
    step: torch.Tensor,  # (N,) global env-step of each transition
    states: torch.Tensor,  # (N, S)
    actions: torch.Tensor,  # (N, A)
    rewards: torch.Tensor,  # (N,)
    next_states: torch.Tensor,  # (N, S)
    terminals: torch.Tensor,  # (N,) true termination (excludes timeouts)
    timeouts: torch.Tensor,  # (N,) time-limit truncation
    valid: Optional[torch.Tensor] = None,  # (N,) mask for ragged batches
    keep: Optional[Dict[str, slice]] = None,  # columns that hold only a block of their width
) -> ReplayState:
    """Ring append of N transitions with inline absorbing wrapping, in place.
    A column named in `keep` holds only those columns of its rows (a rank's
    block under the tensor-parallel layout): the append writes them."""
    n, s_dim = states.shape
    dev = states.device
    valid = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else valid.bool()
    terminals = terminals.bool() & valid
    timeouts = timeouts.bool() & valid
    wrap = terminals if rs.absorbing else torch.zeros_like(terminals)
    absorbing_state = _absorbing_state(s_dim, dev)

    # row A: the transition, rewritten when wrapping; row B: the self-loop
    a_next = torch.where(wrap[:, None], absorbing_state[None, :], next_states)
    a_term = torch.where(wrap, 0.0, terminals.float())
    b_states = absorbing_state.expand(n, s_dim)
    rows_valid = torch.stack([valid, wrap], 1).reshape(-1)
    offsets = torch.cumsum(rows_valid.long(), 0) - 1
    write_idx = (rs.idx + offsets) % rs.size
    write_idx = torch.where(rows_valid, write_idx, rs.size)  # invalid -> spare row

    def il(a, b):
        return torch.stack([a, b], 1).reshape((2 * n,) + a.shape[1:])

    keep = keep or {}

    def put(k, rows):
        getattr(rs, k)[write_idx] = rows[..., keep[k]] if k in keep else rows

    stepf = step.float()
    zeros = torch.zeros(n, device=dev)
    ones = torch.ones(n, device=dev)
    put("step", il(stepf, stepf))
    put("states", il(states, b_states))
    put("actions", il(actions, torch.zeros_like(actions)))
    put("rewards", il(rewards.float(), zeros))
    put("next_states", il(a_next, b_states))
    put("terminals", il(a_term, zeros))
    put("timeouts", il(timeouts.float(), zeros))
    put("weights", il(ones, ones))
    count = rows_valid.sum()
    rs.full |= rs.idx + count >= rs.size
    rs.idx.copy_((rs.idx + count) % rs.size)
    rs.num_trajectories += (terminals | timeouts).sum()
    return rs


def replay_transfer(dst: ReplayState, src: ReplayState) -> ReplayState:
    """Prefill: append every row of `src` (an expert buffer, already
    absorbing-wrapped, so copied verbatim) into `dst` with weight 1, in
    place; rows past dst's size go to the spare row. Every episode end in
    src counts as a trajectory."""
    n = src.size
    count = min(n, dst.size)
    offsets = torch.arange(n, device=dst.idx.device)
    write_idx = torch.where(offsets < count, (dst.idx + offsets) % dst.size, dst.size)
    for k in COLUMNS:
        getattr(dst, k)[write_idx] = src.rows(k)
    dst.weights[write_idx] = 1.0
    dst.full |= dst.idx + count >= dst.size
    dst.idx.copy_((dst.idx + count) % dst.size)
    dst.num_trajectories += ((src.rows("terminals") > 0) | (src.rows("timeouts") > 0)).sum()
    return dst


def sample_limit(rs: ReplayState) -> torch.Tensor:
    """Raw sample integers are uniform on [0, limit)."""
    return torch.where(rs.full, rs.size - 1, torch.clamp_min(rs.idx - 1, 1))


def replay_sample(
    rs: ReplayState,
    n: int,
    generator: Optional[torch.Generator] = None,
    r: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Uniform sample of n transitions that never returns the last write.
    `r` injects the raw nonnegative integers, taken modulo the limit (another
    implementation's draws, already below it, pass unchanged); otherwise
    they come from `generator`."""
    if r is None:
        r = torch.randint(0, 2**62, (n,), generator=generator, device=rs.states.device)
    r = r.to(rs.idx.device) % sample_limit(rs)
    forbidden = (rs.idx - 1) % rs.size
    idxs = torch.where(rs.full, r + (r >= forbidden).long(), r)
    batch = {k: getattr(rs, k)[idxs] for k in COLUMNS}
    if rs.absorbing:
        batch["absorbing"] = batch["states"][:, -1].contiguous()
    else:
        batch["absorbing"] = torch.zeros_like(batch["terminals"])
    return batch
