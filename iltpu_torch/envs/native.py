"""ctypes bindings for the native C++ vectorised MuJoCo stepper: the port of
`iltpu/envs/native.py`.

`NativeVecEnv` has `HostVecEnv`'s constructor and step contract, backed by
the port's copy of the stepper (`iltpu_torch/native/vecenv.cc`): one C call
per batched step does the physics (a thread pool over envs), gymnasium
v4's reward, termination and observation, auto-reset and the absorbing
bit.

`ensure_built()` compiles it at first use with g++ against the MuJoCo C
library and headers committed in `third_party/mujoco/` into
`iltpu_torch/_build/vecenv-<hash>/` (the hash covers the source and the
library's path), with an absolute rpath to that library, so the build runs
wherever the checkout lies. The library is committed as text (gzip in
base64); `unpack_libmujoco()` decodes it into
`iltpu_torch/_build/mujoco-3.10.0/` and checks its sha256 first. The env models are gymnasium's, from
`third_party/gym_mujoco_assets/`. Neither MuJoCo's Python bindings nor
gymnasium are needed. A failed build raises.
"""

import base64
import ctypes
import gzip
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from iltpu_torch.envs.scores import SPECS

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
SRC = os.path.join(_PKG_DIR, "native", "vecenv.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
MUJOCO_DIR = os.path.join(_REPO_ROOT, "third_party", "mujoco")
LIBMUJOCO_PACKED = os.path.join(MUJOCO_DIR, "libmujoco-3.10.0.gz.b64")
LIBMUJOCO_SHA256 = "872b2954e9760b1df122e3c807a907ff806e1980099b00e15789ae67e08b75d5"
LIBMUJOCO = os.path.join(BUILD_DIR, "mujoco-3.10.0", "libmujoco.so.3.10.0")
ASSETS_DIR = os.path.join(_REPO_ROOT, "third_party", "gym_mujoco_assets")

# env_type enum in vecenv.cc + gymnasium asset/frame_skip mapping
# (frame skips: hopper_v4.py:84, walker2d_v4.py MujocoEnv.__init__ arg 4,
# half_cheetah_v4.py / ant_v4.py arg 5).
NATIVE_SPEC = {
    "hopper": (0, "hopper.xml", 4),
    "walker2d": (1, "walker2d.xml", 4),
    "halfcheetah": (2, "half_cheetah.xml", 5),
    "ant": (3, "ant.xml", 5),
}
# each model's (nq, nv): the lengths of qpos and qvel the state hooks copy
STATE_SIZES = {"hopper": (6, 6), "walker2d": (9, 9), "halfcheetah": (9, 9), "ant": (15, 14)}


def library_path() -> str:
    """Where the stepper's library is built: keyed by the source and the
    MuJoCo library's path."""
    h = hashlib.sha256(LIBMUJOCO.encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"vecenv-{h.hexdigest()[:16]}", "libvecenv.so")


def unpack_libmujoco() -> str:
    """Decode the committed MuJoCo library unless done; return its path.
    A copy whose sha256 is not MuJoCo 3.10.0's raises."""
    if os.path.exists(LIBMUJOCO):
        return LIBMUJOCO
    with open(LIBMUJOCO_PACKED, "rb") as f:
        data = gzip.decompress(base64.b64decode(f.read()))
    got = hashlib.sha256(data).hexdigest()
    if got != LIBMUJOCO_SHA256:
        raise RuntimeError(f"{LIBMUJOCO_PACKED} decodes to sha256 {got}, "
                           f"not libmujoco 3.10.0's {LIBMUJOCO_SHA256}")
    os.makedirs(os.path.dirname(LIBMUJOCO), exist_ok=True)
    tmp = f"{LIBMUJOCO}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, LIBMUJOCO)
    return LIBMUJOCO


def ensure_built() -> str:
    """Compile the stepper unless built; return its path. Both libraries
    land by rename, so processes building at once never load a partial
    file."""
    unpack_libmujoco()
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        f"-I{os.path.join(MUJOCO_DIR, 'include')}", SRC, LIBMUJOCO,
        f"-Wl,-rpath,{os.path.dirname(LIBMUJOCO)}", "-lpthread", "-o", tmp,
    ]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build the MuJoCo stepper (rc {r.returncode}):\n"
                           f"{r.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _bind(lib):
    """Set every C signature, so no pointer is cut to 32 bits."""
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    h = ctypes.c_void_p
    lib.vecenv_create.restype = h
    lib.vecenv_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.vecenv_obs_size.restype = ctypes.c_int
    lib.vecenv_obs_size.argtypes = [h]
    lib.vecenv_action_size.restype = ctypes.c_int
    lib.vecenv_action_size.argtypes = [h]
    lib.vecenv_dt.restype = ctypes.c_double
    lib.vecenv_dt.argtypes = [h]
    lib.vecenv_reset.restype = None
    lib.vecenv_reset.argtypes = [h, ctypes.c_uint64, f32]
    lib.vecenv_step.restype = None
    lib.vecenv_step.argtypes = [h, f32, f32, f32, f32, f32, f32]
    lib.vecenv_set_state.restype = None
    lib.vecenv_set_state.argtypes = [h, ctypes.c_int, f64, f64]
    lib.vecenv_get_state.restype = None
    lib.vecenv_get_state.argtypes = [h, ctypes.c_int, f64, f64]
    lib.vecenv_destroy.restype = None
    lib.vecenv_destroy.argtypes = [h]
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.vecenv_set_auto_reset.restype = None
    lib.vecenv_set_auto_reset.argtypes = [h, ctypes.c_int]
    lib.vecenv_obs.restype = None
    lib.vecenv_obs.argtypes = [h, ctypes.c_int, f32]
    lib.vecenv_qpos0.restype = None
    lib.vecenv_qpos0.argtypes = [h, f64]
    lib.vecenv_render_sizes.restype = None
    lib.vecenv_render_sizes.argtypes = [h, i64]
    lib.vecenv_geom_xpos.restype = None
    lib.vecenv_geom_xpos.argtypes = [h, ctypes.c_int, f64]
    lib.vecenv_textures.restype = None
    lib.vecenv_textures.argtypes = [h, i64, u8, i32, f32, i32]
    lib.vecenv_scene.restype = ctypes.c_int
    lib.vecenv_scene.argtypes = [h, ctypes.c_int, f64, ctypes.c_int, f32, f32,
                                 ctypes.POINTER(ctypes.c_int), f32]
    return lib


_lib = None


def load():
    """The stepper's library, built first if needed."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(ensure_built()))
    return _lib


class NativeVecEnv:
    """N MuJoCo envs stepped by one native call (HostVecEnv-compatible)."""

    def __init__(self, env_name: str, num_envs: int = 1, *, absorbing: bool = True,
                 seed: int = 0):
        if env_name not in NATIVE_SPEC:
            raise ValueError(f"unsupported env {env_name}; one of {list(NATIVE_SPEC)}")
        lib = load()
        self.env_name = env_name
        self.spec = SPECS[env_name]
        self.num_envs = num_envs
        self.absorbing = absorbing
        self._seed = seed
        env_type, xml, frame_skip = NATIVE_SPEC[env_name]
        err = ctypes.create_string_buffer(512)
        self._h = lib.vecenv_create(
            os.path.join(ASSETS_DIR, xml).encode(), env_type, num_envs, frame_skip,
            self.spec.time_limit, int(absorbing), seed, err, len(err),
        )
        if not self._h:
            raise RuntimeError(f"vecenv_create failed: {err.value.decode()}")
        sizes = (lib.vecenv_obs_size(self._h), lib.vecenv_action_size(self._h))
        if sizes != (self.obs_size, self.action_size):
            self.close()
            raise RuntimeError(f"the {xml} model gives (obs, action) sizes {sizes}, the spec "
                               f"{(self.obs_size, self.action_size)}")
        S = self.obs_size
        self._next_obs = np.zeros((num_envs, S), np.float32)
        self._rewards = np.zeros(num_envs, np.float32)
        self._terminals = np.zeros(num_envs, np.float32)
        self._timeouts = np.zeros(num_envs, np.float32)
        self._obs_after = np.zeros((num_envs, S), np.float32)

    @property
    def obs_size(self) -> int:
        return self.spec.obs_size + (1 if self.absorbing else 0)

    @property
    def action_size(self) -> int:
        return self.spec.action_size

    @property
    def max_episode_steps(self) -> int:
        return self.spec.time_limit

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        base = self._seed if seed is None else seed
        self._seed = base + self.num_envs
        obs = np.zeros((self.num_envs, self.obs_size), np.float32)
        _lib.vecenv_reset(self._h, base, obs)
        return obs

    def step(self, actions: np.ndarray):
        """(next_obs, rewards, terminals, timeouts, obs_after), fresh numpy
        arrays: the pre-reset successor and the observation to act on next."""
        actions = np.ascontiguousarray(actions, np.float32)
        if actions.shape != (self.num_envs, self.action_size):
            raise ValueError(f"actions of shape {actions.shape}, want "
                             f"{(self.num_envs, self.action_size)}")
        _lib.vecenv_step(
            self._h, actions, self._next_obs, self._rewards,
            self._terminals, self._timeouts, self._obs_after,
        )
        return (
            self._next_obs.copy(),
            self._rewards.copy(),
            self._terminals.copy(),
            self._timeouts.copy(),
            self._obs_after.copy(),
        )

    # ------------------------------------------------------- test hooks
    def _check_state(self, i: int, nq: int, nv: int):
        if not 0 <= i < self.num_envs or (nq, nv) != STATE_SIZES[self.env_name]:
            raise ValueError(f"env {i} of {self.num_envs}, (nq, nv) {(nq, nv)}: the model has "
                             f"{STATE_SIZES[self.env_name]}")

    def set_state(self, i: int, qpos: np.ndarray, qvel: np.ndarray):
        """Env i's qpos and qvel, then mj_forward (gym's set_state)."""
        qpos = np.ascontiguousarray(qpos, np.float64).ravel()
        qvel = np.ascontiguousarray(qvel, np.float64).ravel()
        self._check_state(i, qpos.size, qvel.size)
        _lib.vecenv_set_state(self._h, i, qpos, qvel)

    def get_state(self, i: int, nq: int, nv: int):
        self._check_state(i, nq, nv)
        qpos = np.zeros(nq, np.float64)
        qvel = np.zeros(nv, np.float64)
        _lib.vecenv_get_state(self._h, i, qpos, qvel)
        return qpos, qvel

    # ------------------------------------------------------- rendering
    def set_auto_reset(self, on: bool):
        """Off: a finished env keeps its last state (and obs_after is the
        step's observation), so the frame of that state can be drawn."""
        _lib.vecenv_set_auto_reset(self._h, int(on))

    def _render_sizes(self):
        out = np.zeros(6, np.int64)
        _lib.vecenv_render_sizes(self._h, out)
        return dict(zip(("ngeom", "ntex", "ntexdata", "nmat", "ntexrole", "maxlight"),
                        out.tolist()))

    def observation(self, i: int) -> np.ndarray:
        """Env i's observation of its state as it stands, (obs_size,)."""
        out = np.zeros(self.obs_size, np.float32)
        _lib.vecenv_obs(self._h, i, out)
        return out

    def qpos0(self) -> np.ndarray:
        out = np.zeros(STATE_SIZES[self.env_name][0], np.float64)
        _lib.vecenv_qpos0(self._h, out)
        return out

    def geom_xpos(self, i: int) -> np.ndarray:
        """Env i's geom positions, (ngeom, 3) float64."""
        out = np.zeros((self._render_sizes()["ngeom"], 3), np.float64)
        _lib.vecenv_geom_xpos(self._h, i, out)
        return out

    def textures(self) -> dict:
        """The model's textures and materials: `tex` (ntex, 5) int64 rows of
        (type, height, width, nchannel, adr), `data` uint8, `mat_texid`
        (nmat, ntexrole), `mat_texrepeat` (nmat, 2), `mat_texuniform` (nmat)."""
        n = self._render_sizes()
        out = {
            "tex": np.zeros((n["ntex"], 5), np.int64),
            "data": np.zeros(n["ntexdata"], np.uint8),
            "mat_texid": np.zeros((n["nmat"], n["ntexrole"]), np.int32),
            "mat_texrepeat": np.zeros((n["nmat"], 2), np.float32),
            "mat_texuniform": np.zeros(n["nmat"], np.int32),
        }
        _lib.vecenv_textures(self._h, out["tex"], out["data"], out["mat_texid"],
                             out["mat_texrepeat"], out["mat_texuniform"])
        return out

    def scene(self, i: int, camera: np.ndarray, maxgeom: int = 1000) -> dict:
        """MuJoCo's abstract scene of env i as it stands (mjv_updateScene,
        mjCAT_ALL, no mj_forward), seen through `camera`, a float64 (10,)
        array (type, fixedcamid, trackbodyid, lookat[3], distance, azimuth,
        elevation, orthographic) that mjv_updateScene may update in place.
        Returns `geoms` (ngeom, 25), `lights` (nlight, 23) and `cameras`
        (2, 16) float32 rows, laid out as `vecenv_scene` says."""
        if camera.dtype != np.float64 or camera.shape != (10,) or not camera.flags.c_contiguous:
            raise ValueError("camera must be a contiguous float64 array of 10")
        n = self._render_sizes()
        geoms = np.zeros((maxgeom, 25), np.float32)
        lights = np.zeros((n["maxlight"], 23), np.float32)
        cameras = np.zeros((2, 16), np.float32)
        nlight = ctypes.c_int(0)
        ngeom = _lib.vecenv_scene(self._h, i, camera, maxgeom, geoms, lights,
                                  ctypes.byref(nlight), cameras)
        if ngeom > maxgeom:
            raise RuntimeError(f"the scene has {ngeom} geoms, past maxgeom {maxgeom}")
        return {"geoms": geoms[:ngeom], "lights": lights[:nlight.value], "cameras": cameras}

    def close(self):
        if getattr(self, "_h", None):
            _lib.vecenv_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
