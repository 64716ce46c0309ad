"""Synthetic D4RL-format datasets: the port's copy of
`iltpu/data/synthetic.py` (numpy only)."""

from typing import Dict, Optional, Sequence

import numpy as np


def random_d4rl_dataset(
    rng: np.random.Generator,
    traj_lens: Sequence[int],
    state_size: int,
    action_size: int,
    timeout_flags: Optional[Sequence[bool]] = None,
) -> Dict[str, np.ndarray]:
    """Random-walk trajectories in D4RL array format.

    `timeout_flags[i]` marks trajectory i as ending by time limit rather
    than true termination (mirrors D4RL's terminals/timeouts split).
    """
    if timeout_flags is None:
        timeout_flags = [False] * len(traj_lens)
    obs_list, act_list, next_list, term_list, tout_list = [], [], [], [], []
    for length, is_timeout in zip(traj_lens, timeout_flags):
        obs = np.cumsum(
            rng.normal(size=(length + 1, state_size)).astype(np.float32), axis=0
        )
        act = np.tanh(rng.normal(size=(length, action_size))).astype(np.float32)
        obs_list.append(obs[:-1])
        next_list.append(obs[1:])
        act_list.append(act)
        term = np.zeros(length, np.float32)
        tout = np.zeros(length, np.float32)
        if is_timeout:
            tout[-1] = 1.0
        else:
            term[-1] = 1.0
        term_list.append(term)
        tout_list.append(tout)
    return {
        "observations": np.concatenate(obs_list, axis=0),
        "actions": np.concatenate(act_list, axis=0),
        "next_observations": np.concatenate(next_list, axis=0),
        "terminals": np.concatenate(term_list, axis=0),
        "timeouts": np.concatenate(tout_list, axis=0),
    }
