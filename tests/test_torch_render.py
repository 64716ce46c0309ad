"""The port's rendering (`envs.render`, the stepper's scene export,
`utils.raycast`, `utils.gif`, `envs.host.render_rollout`, `render=true` and
`python -m iltpu_torch.render_rollout`) against iltpu's and gymnasium's on
the CPU, where there is no OpenGL: gymnasium's GL calls are replaced by a
copy of the `mjvScene` its own `mjv_updateScene` built (and, where pixels
are wanted, the port's ray cast of it), and iltpu's `render_rollout` runs
unmodified on top. The scene, the GL cameras and the camera are held to
gymnasium's bit for bit, the reset draw exactly, a 30-frame rollout's frame
count and pixels against iltpu's, the GIF's frames, delays and loop against
iltpu's PIL writer; the ray caster on hand-made scenes against their
geometry."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from iltpu_torch.envs import host, native, render
from iltpu_torch.envs.native import STATE_SIZES, NativeVecEnv
from iltpu_torch.envs.scores import SPECS
from iltpu_torch.models import SoftActor
from iltpu_torch.models.host_inference import host_greedy_fn
from iltpu_torch.utils import gif, raycast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = ("hopper", "walker2d", "halfcheetah", "ant")
SIZES = {"hopper": (11, 3), "walker2d": (17, 6), "halfcheetah": (17, 6), "ant": (111, 8)}


def frame_files(npz: str, gif_path: str) -> int:
    """An npz of (N, 480, 480, 3) uint8 `frames` and a GIF of N frames of
    480 x 480 (read by PIL); returns N."""
    from PIL import Image

    with np.load(npz) as data:
        frames = data["frames"]
    assert frames.dtype == np.uint8 and frames.ndim == 4 and frames.shape[1:] == (480, 480, 3)
    with Image.open(gif_path) as im:
        assert im.n_frames == len(frames) and im.size == (480, 480)
    return len(frames)


def rollout_files(out_dir: str, prefix: str = "") -> int:
    """A run's `<prefix>rollout.npz` and `<prefix>rollout.gif` (`frame_files`)."""
    return frame_files(os.path.join(out_dir, prefix + "rollout.npz"),
                       os.path.join(out_dir, prefix + "rollout.gif"))


# ------------------------------------------------------------ gymnasium, no GL

def scene_of(scn) -> dict:
    """The port's scene layout (`NativeVecEnv.scene`) of a `mujoco.MjvScene`."""
    g = np.zeros((scn.ngeom, 25), np.float32)
    for k in range(scn.ngeom):
        x = scn.geoms[k]
        g[k, :2] = x.type, x.matid
        g[k, 2:5], g[k, 5:8], g[k, 8:17], g[k, 17:21] = x.size, x.pos, x.mat.ravel(), x.rgba
        g[k, 21:25] = x.emission, x.specular, x.shininess, x.reflectance
    lights = np.zeros((scn.nlight, 23), np.float32)
    for k in range(scn.nlight):
        x = scn.lights[k]
        lights[k, 0:3], lights[k, 3:6] = x.pos, x.dir
        lights[k, 6:9] = x.type, x.castshadow, x.headlight
        lights[k, 9:12], lights[k, 12:14] = x.attenuation, (x.cutoff, x.exponent)
        lights[k, 14:17], lights[k, 17:20], lights[k, 20:23] = x.ambient, x.diffuse, x.specular
    cams = np.zeros((2, 16), np.float32)
    for k in range(2):
        x = scn.camera[k]
        cams[k, 0:3], cams[k, 3:6], cams[k, 6:9] = x.pos, x.forward, x.up
        cams[k, 9:16] = (x.frustum_center, x.frustum_width, x.frustum_bottom, x.frustum_top,
                         x.frustum_near, x.frustum_far, x.orthographic)
    return {"geoms": g, "lights": lights, "cameras": cams}


def camera_of(cam) -> np.ndarray:
    """A `mujoco.MjvCamera` as the port's (10,) camera array."""
    return np.array([cam.type, cam.fixedcamid, cam.trackbodyid, *cam.lookat, cam.distance,
                     cam.azimuth, cam.elevation, cam.orthographic], np.float64)


class NoGL:
    """gymnasium's GL calls replaced: `mjr_render` keeps a copy of the scene
    it is handed and, with `textures` set, the port's ray cast of it, which
    `mjr_readPixels` hands back upside down, as OpenGL does."""

    def __init__(self, monkeypatch):
        import mujoco
        from gymnasium.envs.mujoco import mujoco_rendering

        class Context:
            def make_current(self):
                pass

            def free(self):
                pass

        def backend(viewer, width, height):
            viewer.opengl_context, viewer.backend = Context(), "raycast"

        self.scenes, self.textures, self.frame = [], None, None
        monkeypatch.setattr(mujoco_rendering.OffScreenViewer, "_get_opengl_backend", backend)
        monkeypatch.setattr(mujoco, "MjrContext", lambda *a, **k: object())
        monkeypatch.setattr(mujoco, "mjr_setBuffer", lambda *a, **k: None)
        monkeypatch.setattr(mujoco, "mjr_render", self._render)
        monkeypatch.setattr(mujoco, "mjr_readPixels", self._read)

    def _render(self, viewport, scn, con):
        s = scene_of(scn)
        self.scenes.append(s)
        self.frame = None
        if self.textures is not None:
            self.frame = raycast.render_scenes([s], self.textures, width=viewport.width,
                                               height=viewport.height)[0]

    def _read(self, rgb, depth, viewport, con):
        if self.frame is not None:
            rgb[:] = self.frame[::-1].ravel()


@pytest.fixture
def nogl(monkeypatch):
    pytest.importorskip("gymnasium")
    return NoGL(monkeypatch)


def gym_env(name):
    """gymnasium's env as iltpu's `render_rollout` makes it."""
    import gymnasium as gym

    return gym.make(SPECS[name].gym_id, render_mode="rgb_array", **SPECS[name].gym_kwargs)


def stepper(name) -> NativeVecEnv:
    env = NativeVecEnv(name, 1, absorbing=False)
    env.set_auto_reset(False)
    env.reset()
    return env


# ------------------------------------------------------------ scene and camera

@pytest.mark.parametrize("name", ENVS)
def test_scene_and_gl_camera_equal_gymnasium(nogl, name):
    """A state drawn from a seed, set on gymnasium's env and on the stepper
    (`set_state`: mj_forward both): the scene `mjv_updateScene` hands
    `mjr_render` (geoms, lights, both GL cameras) equals the stepper's export
    bit for bit, as do the textures the ray caster reads; the ray caster's
    average of the two cameras is `mjv_averageCamera`'s to float rounding."""
    import mujoco

    nq, nv = STATE_SIZES[name]
    rng = np.random.default_rng(7)
    qpos0 = stepper(name).qpos0()
    qpos = qpos0 + rng.uniform(-0.2, 0.2, nq)
    qvel = rng.normal(0, 1, nv)
    env = gym_env(name)
    env.reset(seed=3)
    env.unwrapped.set_state(qpos, qvel)
    env.render()
    viewer = env.unwrapped.mujoco_renderer.viewer
    port = stepper(name)
    port.set_state(0, qpos, qvel)
    cam = render.camera(name, port.geom_xpos(0))
    ours = port.scene(0, cam)
    theirs = nogl.scenes[-1]
    for key in ("geoms", "lights", "cameras"):
        assert ours[key].shape == theirs[key].shape, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    np.testing.assert_array_equal(cam, camera_of(viewer.cam))
    m = env.unwrapped.model
    tex = port.textures()
    np.testing.assert_array_equal(tex["data"], m.tex_data)
    np.testing.assert_array_equal(tex["tex"], np.stack([m.tex_type, m.tex_height, m.tex_width,
                                                        m.tex_nchannel, m.tex_adr], 1))
    np.testing.assert_array_equal(tex["mat_texid"], m.mat_texid)
    np.testing.assert_array_equal(tex["mat_texrepeat"], m.mat_texrepeat)
    np.testing.assert_array_equal(tex["mat_texuniform"], m.mat_texuniform)
    avg = mujoco.mjv_averageCamera(viewer.scn.camera[0], viewer.scn.camera[1])
    got = raycast.average_camera(torch.from_numpy(ours["cameras"][None]))
    for key, want in (("pos", avg.pos), ("forward", avg.forward), ("up", avg.up)):
        v = got[key]
        np.testing.assert_allclose([float(v.x[0]), float(v.y[0]), float(v.z[0])], want, atol=1e-6)
    for key in ("center", "width", "bottom", "top", "near", "far"):
        np.testing.assert_allclose(float(got[key][0]), getattr(avg, f"frustum_{key}"), rtol=1e-6)
    env.close()
    port.close()


@pytest.mark.parametrize("name", ENVS)
def test_camera_after_the_first_step_equals_gymnasium(nogl, name):
    """gymnasium builds its viewer at the first `render()`, after the first
    step of a rollout: the port's camera from the stepper's `geom_xpos` then
    is the viewer's (ant's and halfcheetah's lookat the median after that
    step), and it is the models' "track" camera that draws."""
    env = gym_env(name)
    env.reset(seed=11)
    action = np.linspace(-0.5, 0.5, SIZES[name][1]).astype(np.float32)
    env.step(action)
    env.render()
    viewer = env.unwrapped.mujoco_renderer.viewer
    port = stepper(name)
    nq, nv = STATE_SIZES[name]
    port.set_state(0, *render.reset_state(name, 11, port.qpos0(), nv))
    port.step(action[None])
    cam = render.camera(name, port.geom_xpos(0))
    np.testing.assert_array_equal(cam, camera_of(viewer.cam))
    assert cam[0] == render.CAMERA_FIXED and cam[1] == env.unwrapped.mujoco_renderer.camera_id
    if name in ("ant", "halfcheetah"):
        np.testing.assert_array_equal(cam[3:6], np.median(env.unwrapped.data.geom_xpos, axis=0))
    env.close()
    port.close()


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("name", ENVS)
def test_reset_draw_equals_gymnasium(name, seed):
    """`env.reset(seed=s)`'s qpos and qvel, exactly, and the observation
    the stepper gives of that state (float32) equals gymnasium's."""
    pytest.importorskip("gymnasium")
    env = gym_env(name)
    obs, _ = env.reset(seed=seed)
    port = stepper(name)
    nq, nv = STATE_SIZES[name]
    qpos, qvel = render.reset_state(name, seed, port.qpos0(), nv)
    np.testing.assert_array_equal(qpos, env.unwrapped.data.qpos)
    np.testing.assert_array_equal(qvel, env.unwrapped.data.qvel)
    port.set_state(0, qpos, qvel)
    np.testing.assert_array_equal(port.observation(0), obs.astype(np.float32))
    env.close()
    port.close()


# ------------------------------------------------------------ rollouts

def actor(name, seed):
    """iltpu's and the port's greedy functions of one small random actor
    (`convert.agent_tree`'s leaves from a seed; absorbing bit included)."""
    from iltpu.models import SoftActor as JaxActor
    from iltpu.models.host_inference import host_greedy_fn as jax_greedy
    from test_torch_expert_data import agent_tree

    S, A = SIZES[name]
    tree = agent_tree(S + 1, A, seed)
    params = [torch.from_numpy(np.asarray(layer[k])) for layer in tree["actor"]["layers"]
              for k in ("w", "b")]
    return (jax_greedy(JaxActor(S + 1, A, 32, 2), tree["actor"]),
            host_greedy_fn(SoftActor(S + 1, A, 32, 2), params))


@pytest.mark.parametrize("name,seed,frames", [("hopper", 1, 30), ("ant", 0, 30),
                                              ("hopper", 0, 500)])
def test_render_rollout_matches_iltpu(nogl, tmp_path, name, seed, frames):
    """iltpu's `render_rollout` (gymnasium stepped, its GL calls drawing the
    port's ray cast of gymnasium's own scene) against the port's (the
    stepper, its scenes cast in batches): the same frame count and at least
    99.9% of the pixels equal (they differ only where the stepper's 1e-5
    drift from gymnasium would move an edge), and GIFs of that many frames.
    Hopper under seed 0 terminates after 11 steps: the last frame is the
    state before any reset, as gymnasium draws it."""
    jax_greedy, port_greedy = actor(name, seed)
    from iltpu.envs.host import render_rollout as jax_render_rollout

    tex_env = stepper(name)
    nogl.textures = raycast.Textures(tex_env.textures(), "cpu")
    tex_env.close()
    kw = dict(absorbing=True, seed=5, max_frames=frames, fps=30)
    n_jax = jax_render_rollout(name, jax_greedy, str(tmp_path / "jax.npz"),
                               gif_path=str(tmp_path / "jax.gif"), **kw)
    n_port = host.render_rollout(name, port_greedy, str(tmp_path / "port.npz"),
                                 gif_path=str(tmp_path / "port.gif"), device="cpu", **kw)
    assert n_jax == n_port == len(nogl.scenes)
    assert n_port == frames if frames < 500 else n_port < 20
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        fa, fb = a["frames"], b["frames"]
    assert fa.shape == fb.shape == (n_port, 480, 480, 3) and fb.dtype == np.uint8
    same = (fa == fb).all(-1).mean()
    assert same >= 0.999, same
    from PIL import Image

    for path in ("jax.gif", "port.gif"):
        with Image.open(tmp_path / path) as im:
            assert im.n_frames == n_port
    if frames == 500:  # terminated: the last frame is gymnasium's, of the state before any reset
        np.testing.assert_array_equal(fb[-1], fa[-1])


def test_stepper_without_auto_reset_keeps_the_last_state():
    """With auto-reset off a finished env is not reset: obs_after is the
    step's observation and the state stays; on, it resets (the trainer's
    default, unchanged)."""
    for auto in (True, False):
        env = NativeVecEnv("hopper", 1, absorbing=False)
        env.set_auto_reset(auto)
        env.reset()
        env.set_state(0, env.qpos0() + np.array([0, -0.6, 0, 0, 0, 0]), np.zeros(6))
        nxt, _, term, _, after = env.step(np.zeros((1, 3), np.float32))
        assert term[0] == 1
        assert np.array_equal(nxt, after) != auto
        qpos, _ = env.get_state(0, *STATE_SIZES["hopper"])
        assert (qpos[1] < 0.7) != auto
        env.close()


# ------------------------------------------------------------ the ray caster

def pinhole(ngeom_rows, lights=None, size=96, pos=(0.0, -6.0, 0.0), forward=(0.0, 1.0, 0.0),
            up=(0.0, 0.0, 1.0), fovy=45.0, near=0.1, far=100.0):
    """A hand-made scene seen from a pinhole camera."""
    top = near * np.tan(np.radians(fovy / 2))
    cam = np.array([*pos, *forward, *up, 0, 0, -top, top, near, far, 0], np.float32)
    if lights is None:  # a headlight-like directional light, white, no ambient
        lights = [light(pos, forward, diffuse=0.0, ambient=0.0)]
    return {"geoms": np.array(ngeom_rows, np.float32).reshape(-1, 25),
            "lights": np.array(lights, np.float32).reshape(-1, 23),
            "cameras": np.stack([cam, cam])}, size


def geom(gtype, size, pos, rgba=(1, 1, 1, 1), emission=1.0, matid=-1, mat=None, reflectance=0.0):
    mat = np.eye(3).ravel() if mat is None else mat
    return [gtype, matid, *size, *pos, *mat, *rgba, emission, 0.0, 0.5, reflectance]


def light(pos, direction, diffuse=1.0, ambient=0.0, castshadow=0, kind=raycast.DIRECTIONAL):
    return [*pos, *direction, kind, castshadow, 0, 1, 0, 0, 180, 0, *[ambient] * 3,
            *[diffuse] * 3, 0, 0, 0]


NO_TEXTURES = {"tex": np.zeros((0, 5), np.int64), "data": np.zeros(0, np.uint8),
               "mat_texid": np.full((1, 10), -1, np.int32),
               "mat_texrepeat": np.ones((1, 2), np.float32),
               "mat_texuniform": np.zeros(1, np.int32)}


def cast(scene_size, textures=NO_TEXTURES):
    scene, size = scene_size
    return raycast.render_scenes([scene], textures, width=size, height=size)[0]


def rays(size, pos=(0.0, -6.0, 0.0), fovy=45.0):
    """float64 unit rays through the pixel centres of `pinhole`'s default
    camera (looking along +y, z up)."""
    t = np.tan(np.radians(fovy / 2))
    c = (np.arange(size) + 0.5) / size * 2 - 1
    x, z = np.meshgrid(c * t, -c * t)
    d = np.stack([x, np.ones_like(x), z], -1)
    return np.asarray(pos, np.float64), d / np.linalg.norm(d, axis=-1, keepdims=True)


def _segment_distance(o, d, a, b):
    """Distance from each unit ray o + s d (s >= 0) to the segment ab, in
    float64: the least of the interior stationary point and the three
    edges s = 0, u = 0, u = 1 of the convex problem."""
    e = b - a
    w = o - a
    be, ce = d @ e, e @ e
    dw, ew = d @ w, e @ w

    def dist(s, u):
        return np.linalg.norm(o + d * s[..., None] - (a + e * u[..., None]), axis=-1)

    denom = ce - be * be
    s_in = (be * ew - ce * dw) / denom
    u_in = (ew - be * dw) / denom
    best = np.where((s_in >= 0) & (u_in >= 0) & (u_in <= 1), dist(s_in, u_in), np.inf)
    best = np.minimum(best, dist(np.zeros_like(dw), np.clip(np.full_like(dw, ew / ce), 0, 1)))
    for u in (0.0, 1.0):
        s = np.clip(be * u - dw, 0, None)
        best = np.minimum(best, dist(s, np.full_like(dw, u)))
    return best


@pytest.mark.parametrize("shape", ["sphere", "capsule", "box", "ellipsoid", "cylinder"])
def test_silhouettes_match_their_projection(shape):
    """A white emissive geom before a pinhole camera covers the pixels whose
    ray meets it (computed in float64 here) to 1% of its area."""
    size = 96
    rot = np.array([[np.cos(0.4), 0, np.sin(0.4)], [0, 1, 0], [-np.sin(0.4), 0, np.cos(0.4)]])
    o, d = rays(size)
    if shape == "sphere":
        g = geom(raycast.SPHERE, (1.2, 1.2, 1.2), (0.3, 0, -0.2))
        want = np.linalg.norm(np.cross(d, np.array([0.3, 0, -0.2]) - o), axis=-1) <= 1.2
    elif shape == "capsule":
        g = geom(raycast.CAPSULE, (0.5, 0.5, 1.0), (0, 0, 0), mat=rot.ravel())
        axis = rot[:, 2]
        want = _segment_distance(o, d, -axis, axis) <= 0.5
    else:
        half = {"box": (0.8, 0.5, 1.1), "ellipsoid": (1.3, 0.6, 0.9), "cylinder": (0.7, 0.7, 1.2)}[shape]
        gtype = {"box": raycast.BOX, "ellipsoid": raycast.ELLIPSOID, "cylinder": raycast.CYLINDER}[shape]
        g = geom(gtype, half, (0, 0, 0), mat=rot.ravel())
        lo = (o @ rot)[None, None] * np.ones(d.shape)  # the local frame: rot^T v
        ld = d @ rot
        h = np.asarray(half)
        if shape == "box":
            t1, t2 = (-h - lo) / ld, (h - lo) / ld
            want = np.minimum(t1, t2).max(-1) <= np.maximum(t1, t2).min(-1)
        elif shape == "ellipsoid":
            so, sd = lo / h, ld / h
            a, b, c = (sd * sd).sum(-1), (so * sd).sum(-1), (so * so).sum(-1) - 1
            want = b * b - a * c >= 0
        else:  # the side's two roots and the caps
            a = ld[..., 0] ** 2 + ld[..., 1] ** 2
            b = lo[..., 0] * ld[..., 0] + lo[..., 1] * ld[..., 1]
            c = lo[..., 0] ** 2 + lo[..., 1] ** 2 - h[0] ** 2
            disc = np.clip(b * b - a * c, 0, None)
            want = np.zeros(d.shape[:2], bool)
            for root in ((-b - np.sqrt(disc)) / a, (-b + np.sqrt(disc)) / a):
                want |= (b * b - a * c >= 0) & (np.abs(lo[..., 2] + ld[..., 2] * root) <= h[2])
            for z in (-h[2], h[2]):
                t = (z - lo[..., 2]) / ld[..., 2]
                want |= (lo[..., 0] + ld[..., 0] * t) ** 2 + (lo[..., 1] + ld[..., 1] * t) ** 2 <= h[0] ** 2
    img = cast(pinhole([g], size=size))
    got = img.max(-1) > 0
    assert want.sum() > 200
    assert (got != want).sum() <= 0.01 * want.sum(), ((got != want).sum(), want.sum())


def test_depth_order():
    """Where two spheres overlap on screen the nearer one shows, in either
    order of the geoms; where only the farther one lies, it shows."""
    centres = {(255, 0, 0): np.array([-0.4, -1.0, 0.0]), (0, 255, 0): np.array([0.4, 1.0, 0.0])}
    near, far = (geom(raycast.SPHERE, (1, 1, 1), c, rgba=(*np.array(k) / 255, 1))
                 for k, c in centres.items())
    o, d = rays(64)
    dist = {k: np.linalg.norm(np.cross(d, c - o), axis=-1) for k, c in centres.items()}
    both = (dist[(255, 0, 0)] < 0.97) & (dist[(0, 255, 0)] < 0.97)
    only_far = (dist[(0, 255, 0)] < 0.97) & (dist[(255, 0, 0)] > 1.03)
    assert both.sum() > 50 and only_far.sum() > 50
    for order in ([near, far], [far, near]):
        img = cast(pinhole(order, size=64))
        assert (img[both] == (255, 0, 0)).all()
        assert (img[only_far] == (0, 255, 0)).all()


def checker(n=100):
    """MuJoCo's builtin checker: 2 x 2 squares, black and 0.8 grey."""
    half = (np.arange(n) >= n // 2)
    grid = (half[:, None] ^ half[None, :]).astype(np.uint8) * 204
    return np.repeat(grid[..., None], 3, -1)


def test_checker_period_follows_texrepeat():
    """A 20 x 20 m plane (size 10) with texrepeat (10, 10) seen from
    straight above: a repeat spans 20 / 10 = 2 m and holds two squares, so
    the squares' edges along the image's centre row lie 1 m apart."""
    tex = {"tex": np.array([[raycast.TEX_2D, 100, 100, 3, 0]], np.int64),
           "data": checker().ravel(), "mat_texid": np.array([[-1, 0] + [-1] * 8], np.int32),
           "mat_texrepeat": np.array([[10, 10]], np.float32), "mat_texuniform": np.zeros(1, np.int32)}
    plane = geom(raycast.PLANE, (10, 10, 1), (0.3, 0, 0), matid=0)
    size, height = 240, 10.0
    img = cast(pinhole([plane], size=size, pos=(0, 0, height), forward=(0, 0, -1), up=(0, 1, 0)), tex)
    row = img[size // 2, :, 0].astype(float)
    edges = np.flatnonzero(np.diff((row > 102).astype(int)) != 0)
    px_per_m = size / (2 * height * np.tan(np.radians(22.5)))
    gaps = np.diff(edges) / px_per_m
    assert len(edges) >= 6 and np.allclose(gaps, 1.0, atol=1.5 / px_per_m), gaps


def test_shadow_lies_where_the_light_says():
    """A sphere 2 m above a lit plane, the light coming down at 45 degrees
    along +x: the plane is dark under (2, 0, 0) (only the ambient term) and
    lit at (-2, 0, 0) and beside the shadow."""
    plane = geom(raycast.PLANE, (10, 10, 1), (0, 0, 0), emission=0.0)
    ball = geom(raycast.SPHERE, (0.5, 0.5, 0.5), (0, 0, 2), emission=0.0)
    d = np.array([1, 0, -1]) / np.sqrt(2)
    lights = [light((0, 0, 5), d, diffuse=0.8, ambient=0.1, castshadow=1)]
    size, height = 200, 10.0
    img = cast(pinhole([plane, ball], lights=lights, size=size, pos=(0, 0, height),
                       forward=(0, 0, -1), up=(0, 1, 0)))
    px_per_m = size / (2 * height * np.tan(np.radians(22.5)))

    def at(x, y):  # the pixel over the plane point (x, y)
        return img[int(size / 2 - y * px_per_m), int(size / 2 + x * px_per_m), 0]

    assert at(2, 0) == round(0.1 * 255)
    lit = round(min(1.0, 0.1 + 0.8 * np.sqrt(0.5)) * 255)
    assert at(-2, 0) == at(2, 1.5) == lit


def test_batched_frames_equal_single_frames():
    """Casting frames in batches gives the frames cast one at a time."""
    env = stepper("ant")
    env.set_state(0, *render.reset_state("ant", 2, env.qpos0(), 14))
    cam, scenes = None, []
    for k in range(3):
        env.step(np.full((1, 8), 0.3 * (k - 1), np.float32))
        cam = render.camera("ant", env.geom_xpos(0)) if cam is None else cam
        scenes.append(env.scene(0, cam))
    tex = raycast.Textures(env.textures(), "cpu")
    env.close()
    batched = raycast.render_scenes(scenes, tex, width=120, height=90, batch=3)
    single = np.concatenate([raycast.render_scenes([s], tex, width=120, height=90) for s in scenes])
    np.testing.assert_array_equal(batched, single)
    assert batched.shape == (3, 90, 120, 3)


# ------------------------------------------------------------ the GIF

def read_gif(path):
    from PIL import Image

    with Image.open(path) as im:
        frames, durations = [], []
        for k in range(im.n_frames):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGB")))
            durations.append(im.info.get("duration"))
        return np.stack(frames), durations, im.info.get("loop"), im.size


@pytest.mark.parametrize("fps", [30, 40, 200])
def test_gif_matches_iltpus_pil_writer(tmp_path, fps):
    """The same frames through iltpu's `save_frames_gif` (PIL) and the
    port's: equal frame counts, size, per-frame durations and loop; the
    port's mean absolute error against the frames at most 1.25 x PIL's."""
    pytest.importorskip("PIL")
    from iltpu.envs.host import save_frames_gif as jax_save

    env = stepper("hopper")
    env.set_state(0, *render.reset_state("hopper", 4, env.qpos0(), 6))
    cam, scenes = None, []
    for k in range(3):
        env.step(np.full((1, 3), 0.8 * (k - 1), np.float32))
        cam = render.camera("hopper", env.geom_xpos(0)) if cam is None else cam
        scenes.append(env.scene(0, cam))
    frames = raycast.render_scenes(scenes, env.textures(), batch=3)
    env.close()
    jax_save(frames, str(tmp_path / "pil.gif"), fps=fps)
    host.save_frames_gif(frames, str(tmp_path / "port.gif"), fps=fps)
    a, b = read_gif(tmp_path / "pil.gif"), read_gif(tmp_path / "port.gif")
    assert a[1:] == b[1:] and len(a[0]) == len(b[0]) == 3
    err_pil = np.abs(a[0].astype(int) - frames).mean()
    err_port = np.abs(b[0].astype(int) - frames).mean()
    assert err_port <= 1.25 * err_pil, (err_port, err_pil)


def test_gif_of_few_colours_is_lossless(tmp_path):
    """Frames of at most 256 colours keep them exactly: noise of 256 colours
    (which fills the LZW table again and again) and a flat frame decode, in
    PIL, to the frames."""
    pytest.importorskip("PIL")
    rng = np.random.default_rng(0)
    colours = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    noise = colours[rng.integers(0, 256, (2, 97, 131))]
    flat = np.full((1, 97, 131, 3), 17, np.uint8)
    frames = np.concatenate([noise, flat])
    gif.save_frames_gif(frames, str(tmp_path / "x.gif"), fps=25)
    back, durations, loop, size = read_gif(tmp_path / "x.gif")
    np.testing.assert_array_equal(back, frames)
    assert durations == [40] * 3 and loop == 0 and size == (131, 97)


def test_gif_blocks_decode_to_the_quantized_frames(tmp_path):
    """The port's GIF walked block by block with chip_smoke's strict parser
    (header, loop block, one control block and one image a frame, trailer):
    each image's LZW data decodes to `quantize`'s indices and its local
    table is the palette."""
    sys.path.insert(0, REPO)
    import chip_smoke

    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)  # thousands of colours
    frames[1] = frames[1] // 64 * 64  # and one of 64 colours
    gif.save_frames_gif(frames, str(tmp_path / "x.gif"), fps=30)
    size, loop, delays, images = chip_smoke.gif_blocks(str(tmp_path / "x.gif"))
    assert size == (56, 40) and loop == 0 and delays == [3, 3, 3] and len(images) == 3
    for frame, (palette, code_size, body) in zip(frames, images):
        want_palette, want_idx = gif.quantize(frame)
        idx = np.frombuffer(chip_smoke.lzw_decode(body, code_size, 40 * 56), np.uint8)
        assert code_size == 8 and palette == want_palette.tobytes()
        np.testing.assert_array_equal(idx.reshape(40, 56), want_idx)


# ------------------------------------------------------------ the entry points

def _train(tmp_path, *extra):
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    args = ["algorithm=GAIL", "steps=160", "training.start=64", "num_envs=4",
            "evaluation.interval=1000", "evaluation.episodes=1", "logging.interval=0",
            "memory.size=1000", "imitation.trajectories=4", "training.batch_size=16",
            "reinforcement.actor.hidden_size=16", "reinforcement.critic.hidden_size=16",
            "render=true", "save_trajectories=true", "platform=cpu", *extra]
    t = Trainer(load_config(args), out_dir=str(tmp_path))
    t.run()
    return t


HOPPER = ["env=hopper", f"expert_data.source={os.path.join(REPO, 'data', 'hopper_expert.npz')}"]


@pytest.mark.parametrize("backend", ["native", "mujoco"])
def test_trainer_renders_after_training(tmp_path, backend):
    """`render=true` on hopper writes rollout.npz ((N, 480, 480, 3) uint8)
    and rollout.gif (N frames) after training, before trajectories.pkl;
    the stepper renders whatever the env backend."""
    if backend == "mujoco":
        pytest.importorskip("gymnasium")
    t = _train(tmp_path, *HOPPER, f"env_backend={backend}")
    n = rollout_files(t.out_dir)
    assert 1 <= n <= 500
    times = [os.path.getmtime(os.path.join(t.out_dir, f))
             for f in ("rollout.npz", "rollout.gif", "trajectories.pkl")]
    assert times == sorted(times)
    # the frames are the rollout of the trained actor from iltpu's seed
    scenes, _ = host.rollout_scenes("hopper", t._greedy_fn(), seed=t.cfg.seed + 39916801)
    assert len(scenes) == n


def test_array_env_renders_nothing(tmp_path):
    """An array env (`env_backend=jax`) renders nothing, as in iltpu."""
    t = _train(tmp_path, "env=pointmass", "env_backend=jax")
    assert not glob.glob(os.path.join(t.out_dir, "rollout.*"))


def test_render_script_on_a_runs_agent(tmp_path):
    """`python -m iltpu_torch.render_rollout` (the port of
    scripts/render_rollout.py, same flags) on a hopper run's `agent/`, in a
    process of its own: both files, with the frame count it prints."""
    t = _train(tmp_path / "run", *HOPPER, "env_backend=native", "render=false",
               "save_trajectories=false")
    out = str(tmp_path / "roll")
    r = subprocess.run([sys.executable, "-m", "iltpu_torch.render_rollout", "--env", "hopper",
                        "--agent", os.path.join(t.out_dir, "agent"), "--out", out,
                        "--hidden-size", "16", "--max-frames", "10", "--platform", "cpu"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))  # one thread beside the suite's
    assert r.returncode == 0, r.stderr[-3000:]
    n = int(re.search(r"\((\d+) frames\)", r.stdout).group(1))
    assert r.stdout.strip() == f"wrote {out}.npz / {out}.gif ({n} frames)"
    assert frame_files(out + ".npz", out + ".gif") == n <= 10
