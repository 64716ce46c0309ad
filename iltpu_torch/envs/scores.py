"""Supported environments + D4RL score-normalisation table: the port's own
copy of `iltpu/envs/scores.py`.

Mirrors the reference's env whitelist (`environments.py:17`) and its use of
`env.ref_min_score`/`ref_max_score` for normalised scores (`train.py:58,215`).
The reference pulls these constants from the `d4rl` package
(d4rl/infos.py REF_MIN_SCORE / REF_MAX_SCORE); with zero egress we carry
them as literals.
"""

from typing import Dict, NamedTuple

ENVS = ["ant", "halfcheetah", "hopper", "walker2d"]


class EnvSpec(NamedTuple):
    gym_id: str
    gym_kwargs: dict
    obs_size: int  # without the absorbing indicator bit
    action_size: int
    ref_min_score: float
    ref_max_score: float
    time_limit: int


# gym_id mapping: the reference uses gym 0.23 `<name>-expert-v2` (v3-dynamics
# MuJoCo envs via mujoco-py). Gymnasium v4 envs on the mujoco 3.x bindings
# are the closest available dynamics; ant keeps contact forces in the
# observation for D4RL's 111-dim layout.
SPECS: Dict[str, EnvSpec] = {
    "ant": EnvSpec(
        "Ant-v4", {"use_contact_forces": True}, 111, 8, -325.6, 3879.7, 1000
    ),
    "halfcheetah": EnvSpec(
        "HalfCheetah-v4", {}, 17, 6, -280.178953, 12135.0, 1000
    ),
    "hopper": EnvSpec("Hopper-v4", {}, 11, 3, -20.272305, 3234.3, 1000),
    "walker2d": EnvSpec("Walker2d-v4", {}, 17, 6, 1.629008, 4592.3, 1000),
}


def d4rl_normalized_score(env_name: str, ret: float) -> float:
    """(return - ref_min) / (ref_max - ref_min) — train.py:58,215."""
    spec = SPECS[env_name]
    return (ret - spec.ref_min_score) / (spec.ref_max_score - spec.ref_min_score)
