"""The plain reference of the rows the training loop feeds: what the
replay ring holds after appending the stepper's outputs (with the DAC
absorbing-state wrap), and the expert rows a run's expert buffer draws
from. NumPy only; it imports nothing of the program.

The physics is MuJoCo's library, so the stepper's outputs are taken as
given: each env step's observations acted on, actions, rewards, next
observations, terminals and timeouts.
"""

from typing import Dict, List

import numpy as np

COLUMNS = ("step", "states", "actions", "rewards", "next_states", "terminals", "timeouts", "weights")


def absorbing_state(state_size: int) -> np.ndarray:
    """Zeros with the indicator bit last."""
    s = np.zeros(state_size, np.float32)
    s[-1] = 1.0
    return s


def ring_rows(calls: List[Dict[str, np.ndarray]], step_ids: List[int], absorbing: bool) -> Dict:
    """The rows consecutive env steps append, in write order: for each env
    its transition and, where it truly terminated and `absorbing` holds,
    the transition redirected to the absorbing state with its terminal
    cleared, followed by the absorbing self-loop row. `step_ids[k]` is
    the step column of call k's rows (the env step after it)."""
    out = {k: [] for k in COLUMNS}
    for call, sid in zip(calls, step_ids):
        obs, act = call["obs"], call["actions"]
        n, S = obs.shape
        term = call["terminals"] > 0
        wrap = term if absorbing else np.zeros(n, bool)
        ab = absorbing_state(S)
        a_next = np.where(wrap[:, None], ab[None, :], call["next_obs"])
        a_term = np.where(wrap, 0.0, term.astype(np.float32)).astype(np.float32)
        rows = {
            "step": np.full(n, sid, np.float32), "states": obs, "actions": act,
            "rewards": call["rewards"].astype(np.float32), "next_states": a_next,
            "terminals": a_term, "timeouts": (call["timeouts"] > 0).astype(np.float32),
            "weights": np.ones(n, np.float32),
        }
        loop = {
            "step": np.full(n, sid, np.float32), "states": np.broadcast_to(ab, (n, S)),
            "actions": np.zeros_like(act), "rewards": np.zeros(n, np.float32),
            "next_states": np.broadcast_to(ab, (n, S)), "terminals": np.zeros(n, np.float32),
            "timeouts": np.zeros(n, np.float32), "weights": np.ones(n, np.float32),
        }
        order = np.stack([np.ones(n, bool), wrap], 1).reshape(-1)
        for k in COLUMNS:
            both = np.stack([rows[k], loop[k]], 1).reshape((2 * n,) + rows[k].shape[1:])
            out[k].append(both[order])
    return {k: np.concatenate(v) for k, v in out.items()}


def expert_rows(data: Dict[str, np.ndarray], trajectories: int, absorbing: bool) -> np.ndarray:
    """(states | actions | weights) rows of the first `trajectories`
    trajectories of a D4RL-layout dataset (every one when 0), split at
    each terminal or timeout; with `absorbing`, states get the indicator
    column and a trajectory that did not end on its time limit gets the
    absorbing row (absorbing state, zero action)."""
    obs = np.asarray(data["observations"], np.float32)
    act = np.asarray(data["actions"], np.float32)
    ends = np.flatnonzero((np.asarray(data["terminals"]) > 0) | (np.asarray(data["timeouts"]) > 0))
    bounds = np.concatenate([[-1], ends])
    if len(bounds) - 1 > trajectories > 0:
        bounds = bounds[:trajectories + 1]
    S, A = obs.shape[1] + (1 if absorbing else 0), act.shape[1]
    rows = []
    for lo, hi in zip(bounds[:-1] + 1, bounds[1:] + 1):
        s = obs[lo:hi]
        if absorbing:
            s = np.concatenate([s, np.zeros((len(s), 1), np.float32)], 1)
        rows.append(np.concatenate([s, act[lo:hi], np.ones((len(s), 1), np.float32)], 1))
        if absorbing and not np.asarray(data["timeouts"])[hi - 1] > 0:
            rows.append(np.concatenate([absorbing_state(S), np.zeros(A, np.float32),
                                        np.ones(1, np.float32)])[None])
    return np.concatenate(rows)


def unknown_rows(rows: np.ndarray, known: np.ndarray) -> int:
    """How many of `rows` are not, bit for bit, a row of `known`."""
    as_bytes = lambda m: {r.tobytes() for r in np.ascontiguousarray(m, np.float32)}
    have = as_bytes(known)
    return sum(r.tobytes() not in have for r in np.ascontiguousarray(rows, np.float32))
