"""Expert demonstrations (D4RL-format arrays -> transitions): the port's
copy of `load_d4rl_hdf5` and `build_expert_transitions` from
`iltpu/data/dataset.py`, numpy only.

`load_d4rl_hdf5` reads a D4RL HDF5 file through the port's own reader of
the format (`data/hdf5.py` and its sibling modules: what h5py writes under
every `libver`, no h5py). `build_expert_transitions` does the
trajectory splitting at terminal/timeout indices, truncation to the first N
trajectories, DAC absorbing-state wrapping, within-trajectory subsampling
that keeps the absorbing pair, weights 1/subsample on absorbing transitions,
and all-zero rewards.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from iltpu_torch.data.hdf5 import read_datasets

D4RL_KEYS = ("observations", "actions", "next_observations", "terminals", "timeouts")


def load_d4rl_hdf5(path: str) -> Dict[str, np.ndarray]:
    """A D4RL-format HDF5 file's arrays, as iltpu's h5py loader gives them.

    Where `next_observations` is missing it is the observations shifted by
    one, each terminal-or-timeout boundary patched back to its own
    observation (the shift must not cross into the next trajectory), and
    `weights` zero the timeouts that are not terminals: their self-loop is
    not a real transition. A missing file raises FileNotFoundError.
    """
    data = read_datasets(path, D4RL_KEYS)
    if "next_observations" not in data:
        obs = data["observations"]
        next_obs = np.concatenate([obs[1:], obs[-1:]], axis=0)
        terminals = np.asarray(data["terminals"]).reshape(-1).astype(bool)
        timeouts = np.asarray(data["timeouts"]).reshape(-1).astype(bool)
        ends = np.flatnonzero(terminals | timeouts)
        next_obs[ends] = obs[ends]
        data["next_observations"] = next_obs
        weights = np.ones(len(obs), np.float32)
        weights[timeouts & ~terminals] = 0.0
        data["weights"] = weights
    return data


def build_expert_transitions(
    dataset: Dict[str, np.ndarray],
    trajectories: int = 0,
    subsample: int = 1,
    absorbing: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Dict[str, np.ndarray], int]:
    """Returns (transitions dict, num_trajectories).

    Transitions keys: states, actions, next_states, terminals, timeouts,
    weights, rewards (all f32; rewards all-zero). Mirrors
    environments.py:63-125 exactly — see the stage comments.
    """
    assert subsample >= 1 and trajectories >= 0
    if rng is None:
        rng = np.random.default_rng(0)

    states = np.asarray(dataset["observations"], np.float32)
    actions = np.asarray(dataset["actions"], np.float32)
    next_states = np.asarray(dataset["next_observations"], np.float32)
    terminals = np.asarray(dataset["terminals"], np.float32).reshape(-1)
    timeouts = np.asarray(dataset["timeouts"], np.float32).reshape(-1)
    # Optional per-row base weights (e.g. load_d4rl_hdf5's zero-weighting of
    # reconstructed self-loop timeout boundaries); default all-ones matches
    # the reference, which has no such channel (environments.py:63-125).
    row_weights = np.asarray(
        dataset.get("weights", np.ones(len(states))), np.float32
    ).reshape(-1)
    state_size, action_size = states.shape[1], actions.shape[1]

    # Split into trajectories at terminal-or-timeout indices (env.py:72-81).
    end_idxs = np.sort(
        np.concatenate(
            [np.flatnonzero(terminals), np.flatnonzero(timeouts)]
        )
    )
    end_idxs = np.unique(np.concatenate([[-1], end_idxs]))
    traj = []
    for i in range(len(end_idxs) - 1):
        lo, hi = end_idxs[i] + 1, end_idxs[i + 1] + 1
        traj.append(
            dict(
                states=states[lo:hi],
                actions=actions[lo:hi],
                next_states=next_states[lo:hi],
                terminals=terminals[lo:hi],  # true terminations only
                timeouts=timeouts[lo:hi],
                weights=row_weights[lo:hi].copy(),
            )
        )

    # Truncate to the first N trajectories (env.py:83-89).
    if trajectories > 0:
        traj = traj[:trajectories]
    num_trajectories = len(traj)

    # Absorbing-state wrapping (env.py:92-109).
    if absorbing:
        absorbing_state = np.concatenate(
            [np.zeros(state_size, np.float32), np.ones(1, np.float32)]
        )
        absorbing_action = np.zeros(action_size, np.float32)
        for t in traj:
            pad = np.zeros((len(t["states"]), 1), np.float32)
            t["states"] = np.concatenate([t["states"], pad], axis=1)
            t["next_states"] = np.concatenate([t["next_states"], pad], axis=1)
            if not t["timeouts"][-1]:  # did not end on the time limit
                t["next_states"][-1] = absorbing_state
                t["terminals"][-1] = 0.0
                t["weights"][-1] = 1.0 / subsample
                t["states"] = np.concatenate([t["states"], absorbing_state[None]], 0)
                t["actions"] = np.concatenate([t["actions"], absorbing_action[None]], 0)
                t["next_states"] = np.concatenate(
                    [t["next_states"], absorbing_state[None]], 0
                )
                t["terminals"] = np.concatenate([t["terminals"], [0.0]]).astype(
                    np.float32
                )
                t["timeouts"] = np.concatenate([t["timeouts"], [0.0]]).astype(
                    np.float32
                )
                t["weights"] = np.concatenate(
                    [t["weights"], [1.0 / subsample]]
                ).astype(np.float32)

    # Subsample within trajectories from a random offset, always keeping the
    # absorbing pair [T-2, T-1] (env.py:111-121).
    if subsample > 1:
        for t in traj:
            start = int(rng.integers(subsample))
            T = len(t["states"])
            idxs = set(range(start, T, subsample))
            if absorbing:
                idxs |= {T - 2, T - 1}
            idxs = sorted(idxs)
            for k in t:
                t[k] = t[k][idxs]

    transitions = {
        "states": np.concatenate([t["states"] for t in traj], axis=0),
        "actions": np.concatenate([t["actions"] for t in traj], axis=0),
        "next_states": np.concatenate([t["next_states"] for t in traj], axis=0),
        "terminals": np.concatenate([t["terminals"] for t in traj], axis=0),
        "timeouts": np.concatenate([t["timeouts"] for t in traj], axis=0),
        "weights": np.concatenate([t["weights"] for t in traj], axis=0),
    }
    # Zero rewards: env reward must not leak into the IL learner (env.py:124).
    transitions["rewards"] = np.zeros_like(transitions["terminals"])
    return transitions, num_trajectories
