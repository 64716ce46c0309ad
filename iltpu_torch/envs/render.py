"""What gymnasium's `rgb_array` rendering of a MuJoCo v4 env starts from, as
the port's own copies: the image size, the viewer's camera and the state
`env.reset(seed=s)` draws.

- The size: `mujoco_env.py:19` (DEFAULT_SIZE 480, both sides).
- The camera. gymnasium's `MujocoRenderer` builds its `OffScreenViewer` at
  the first `render()`, which in a rollout comes after the first step:
  `mjv_defaultCamera`, then `_init_camera` (FREE, fixedcamid -1, lookat the
  median of `geom_xpos`, distance `stat.extent`), then `_set_cam_config`
  with the env's `DEFAULT_CAMERA_CONFIG` (`hopper_v4.py:8-13`,
  `walker2d_v4.py:8-13`, `ant_v4.py:8-10`, `half_cheetah_v4.py:10-12`;
  each sets `distance`, so the extent never survives). Every `render()`
  then passes the model's camera named "track" (`MujocoRenderer.__init__`:
  no camera given means "track"; it is camera 0 of all four models), so
  `OffScreenViewer.render` sets the type to FIXED and `fixedcamid` to 0:
  the picture is the trackcom camera's, and the free-camera fields ride
  along unused.
- The reset: `np.random.Generator(PCG64(SeedSequence(s)))`, then the v4
  `reset_model` draws (`hopper_v4.py`/`walker2d_v4.py`: uniform +-5e-3 on
  qpos, then on qvel; `ant_v4.py`/`half_cheetah_v4.py`: uniform +-0.1 on
  qpos, then 0.1 standard normals on qvel), around `qpos0` and zero
  velocities.
"""

from typing import Tuple

import numpy as np

WIDTH = HEIGHT = 480  # gymnasium/envs/mujoco/mujoco_env.py:19

# mjtCamera
CAMERA_FREE, CAMERA_FIXED = 0, 2
TRACK_CAMERA_ID = 0  # the models' "track" camera

# each v4 env's DEFAULT_CAMERA_CONFIG
CAMERA_CONFIG = {
    "hopper": {"trackbodyid": 2, "distance": 3.0, "lookat": (0.0, 0.0, 1.15), "elevation": -20.0},
    "walker2d": {"trackbodyid": 2, "distance": 4.0, "lookat": (0.0, 0.0, 1.15), "elevation": -20.0},
    "halfcheetah": {"distance": 4.0},
    "ant": {"distance": 4.0},
}

# reset_model's noise: (kind of the qvel draw, scale)
RESET_NOISE = {
    "hopper": ("uniform", 5e-3),
    "walker2d": ("uniform", 5e-3),
    "halfcheetah": ("normal", 0.1),
    "ant": ("normal", 0.1),
}


def camera(env_name: str, geom_xpos: np.ndarray) -> np.ndarray:
    """The mjvCamera gymnasium's viewer hands `mjv_updateScene`, as the
    float64 (10,) array `NativeVecEnv.scene` takes: (type, fixedcamid,
    trackbodyid, lookat[3], distance, azimuth, elevation, orthographic).
    `geom_xpos` is the env's (ngeom, 3) geom positions when the viewer is
    built (after the first step of a rollout)."""
    # mjv_defaultCamera
    cam = {"trackbodyid": -1, "distance": 2.0, "azimuth": 90.0, "elevation": -45.0}
    # _init_camera (its distance, stat.extent, is overridden by every config)
    cam["lookat"] = tuple(np.median(geom_xpos[:, i]) for i in range(3))
    cam.update(CAMERA_CONFIG[env_name])
    return np.array([CAMERA_FIXED, TRACK_CAMERA_ID, cam["trackbodyid"], *cam["lookat"],
                     cam["distance"], cam["azimuth"], cam["elevation"], 0], np.float64)


def reset_state(env_name: str, seed: int, qpos0: np.ndarray, nv: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(qpos, qvel) that gymnasium's `env.reset(seed=seed)` sets."""
    rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
    kind, scale = RESET_NOISE[env_name]
    qpos = qpos0 + rng.uniform(low=-scale, high=scale, size=qpos0.size)
    if kind == "uniform":
        qvel = np.zeros(nv) + rng.uniform(low=-scale, high=scale, size=nv)
    else:
        qvel = np.zeros(nv) + scale * rng.standard_normal(nv)
    return qpos, qvel
