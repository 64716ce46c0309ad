"""The port's MuJoCo envs against iltpu's: the files committed under
`third_party/` (hashes, and the models byte-equal to gymnasium's), the
port's copy of the C++ stepper (`iltpu_torch/envs/native.py`) bit-equal to
iltpu's `NativeVecEnv` on all four envs with and without the absorbing bit,
the MuJoCo library a fresh process maps, gymnasium's `HostVecEnv` and
`evaluate_policy` against iltpu's, and `HostEnv`, the trainer's device
adapter, on the CPU."""

import base64
import gzip
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import iltpu.envs.host as jax_host
import iltpu.envs.native as jax_native
from iltpu_torch.envs import host, native
from iltpu_torch.envs.vecenv import HostEnv, make_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIRD_PARTY = os.path.join(REPO, "third_party")
ENVS = ("hopper", "walker2d", "halfcheetah", "ant")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("folder", ["mujoco", "gym_mujoco_assets"])
def test_vendored_files_match_their_readme(folder):
    """Every file under the folder but its README is listed in the README
    with its sha256, and hashes to it; the models are byte-equal to the
    installed gymnasium's assets, and the library, committed as gzip in
    base64, decodes to the mujoco package's byte for byte."""
    root = os.path.join(THIRD_PARTY, folder)
    with open(os.path.join(root, "README.md")) as f:
        listed = dict((p, h) for h, p in re.findall(r"^([0-9a-f]{64})  (\S+)$", f.read(), re.M))
    present = sorted(os.path.relpath(os.path.join(d, n), root)
                     for d, _, names in os.walk(root) for n in names if n != "README.md")
    assert sorted(listed) == present
    for path, want in listed.items():
        assert _sha256(os.path.join(root, path)) == want, path
    if folder == "mujoco":
        assert native.LIBMUJOCO_SHA256 == (
            "872b2954e9760b1df122e3c807a907ff806e1980099b00e15789ae67e08b75d5")
        with open(os.path.join(root, "README.md")) as f:
            assert native.LIBMUJOCO_SHA256 in f.read()
        import mujoco

        pip_lib = os.path.join(os.path.dirname(mujoco.__file__), "libmujoco.so.3.10.0")
        with open(native.LIBMUJOCO_PACKED, "rb") as f:
            decoded = gzip.decompress(base64.b64decode(f.read()))
        with open(pip_lib, "rb") as f:
            assert decoded == f.read()
        assert _sha256(native.unpack_libmujoco()) == native.LIBMUJOCO_SHA256
    else:
        import gymnasium.envs.mujoco as gym_mujoco

        assets = os.path.join(os.path.dirname(gym_mujoco.__file__), "assets")
        for _, xml, _ in native.NATIVE_SPEC.values():
            with open(os.path.join(assets, xml), "rb") as a, open(os.path.join(root, xml), "rb") as b:
                assert a.read() == b.read(), xml


def _random_actions(rng, n, A):
    # wide actions: hoppers and walkers fall, so episodes end and reset
    return rng.uniform(-1.5, 1.5, (n, A)).astype(np.float32)


@pytest.mark.parametrize("absorbing", [True, False], ids=["absorbing", "plain"])
@pytest.mark.parametrize("name", ENVS)
def test_stepper_bit_equal_to_iltpu(name, absorbing):
    """16 envs x 300 steps of seeded random actions (with falls and
    resets), a state set in the middle: every output bit-equal to iltpu's
    stepper, and the states read back equal."""
    N, steps = 16, 300
    ours = native.NativeVecEnv(name, N, absorbing=absorbing, seed=5)
    ref = jax_native.NativeVecEnv(name, N, absorbing=absorbing, seed=5)
    np.testing.assert_array_equal(ours.reset(), ref.reset())
    rng = np.random.default_rng(1)
    model_nq, model_nv = native.STATE_SIZES[name]
    ends = 0
    for t in range(steps):
        if t == steps // 2:
            for i in (0, N - 1):
                qpos, qvel = ref.get_state(i, model_nq, model_nv)
                qpos = qpos + rng.uniform(-0.05, 0.05, model_nq)
                qvel = qvel + rng.uniform(-0.05, 0.05, model_nv)
                ours.set_state(i, qpos, qvel)
                ref.set_state(i, qpos, qvel)
        actions = _random_actions(rng, N, ref.action_size)
        got, want = ours.step(actions), ref.step(actions)
        for g, w, what in zip(got, want, ("next_obs", "rewards", "terminals", "timeouts",
                                          "obs_after")):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} step {t} {what}")
        ends += int((want[2] + want[3]).sum())
    for i in range(N):
        for g, w in zip(ours.get_state(i, model_nq, model_nv), ref.get_state(i, model_nq, model_nv)):
            np.testing.assert_array_equal(g, w)
    if name != "halfcheetah":  # it never terminates, and 300 steps end no episode
        assert ends > 0, f"{name}: no episode ended in {steps} steps"
    ours.close()
    ref.close()


def test_stepper_loads_the_vendored_libmujoco(tmp_path):
    """In a fresh process that never imported the mujoco package (iltpu's
    build and the port's share the soname, so in one process the loader
    maps whichever copy came first), the port's stepper maps libmujoco
    decoded from third_party/, and importing and stepping it brings in neither
    mujoco's bindings nor gymnasium."""
    code = """
import sys
import numpy as np
from iltpu_torch.envs.native import NativeVecEnv
env = NativeVecEnv("hopper", 2, seed=0)
env.reset()
env.step(np.zeros((2, 3), np.float32))
maps = sorted({l.split()[-1] for l in open("/proc/self/maps") if "libmujoco" in l})
print(maps)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("mujoco", "gymnasium", "jax", "iltpu"))
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    maps = eval(r.stdout.strip().splitlines()[-1])
    assert maps == [native.LIBMUJOCO], maps
    assert native.LIBMUJOCO.startswith(os.path.join(REPO, "iltpu_torch", "_build") + os.sep)


@pytest.mark.parametrize("name", ["hopper", "ant"])
def test_gymnasium_host_env_bit_equal_to_iltpu(name):
    """gymnasium's envs on the port's thread pool against iltpu's, 4 envs x
    100 steps with resets."""
    ours = host.HostVecEnv(name, 4, seed=3)
    ref = jax_host.HostVecEnv(name, 4, seed=3)
    np.testing.assert_array_equal(ours.reset(), ref.reset())
    rng = np.random.default_rng(2)
    for t in range(100):
        actions = _random_actions(rng, 4, ref.action_size)
        for g, w in zip(ours.step(actions), ref.step(actions)):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} step {t}")
    ours.close()
    ref.close()


@pytest.mark.parametrize("stepper", ["native", "gymnasium"])
def test_evaluate_policy_matches_iltpu(stepper):
    """One fixed numpy policy: the same returns and trajectories."""
    W = np.random.default_rng(4).normal(0, 0.5, (12, 3)).astype(np.float32)

    def policy(obs):
        return np.tanh(obs @ W)

    ours = native.NativeVecEnv if stepper == "native" else None
    ref = jax_native.NativeVecEnv if stepper == "native" else None
    kw = dict(absorbing=True, seed=11)
    got = host.evaluate_policy("hopper", policy, 3, env_cls=ours, return_trajectories=True, **kw)
    want = jax_host.evaluate_policy("hopper", policy, 3, env_cls=ref, return_trajectories=True,
                                    **kw)
    assert got[0] == want[0]
    for g, w in zip(got[1], want[1]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert host.evaluate_policy("hopper", policy, 3, env_cls=ours, **kw) == want[0]


def test_host_env_adapter_packs_iltpus_block():
    """`HostEnv` over the stepper on the CPU: its outputs are the env's, in
    iltpu's packed layout, the state's observations follow the env's, and
    actions given on the device, as numpy, or fetched give the same step;
    the torch generator is ignored (the env is seeded with an int)."""
    N, A = 8, 3
    env = make_env("hopper", N, absorbing=True, backend="native", seed=9)
    ref = jax_native.NativeVecEnv("hopper", N, absorbing=True, seed=9)
    assert isinstance(env, HostEnv) and env.obs_size == 12 and env.action_size == A
    state = env.reset(torch.Generator().manual_seed(123))
    obs = ref.reset(9)
    np.testing.assert_array_equal(state["obs"].numpy(), obs)
    rng = np.random.default_rng(0)
    for t in range(60):
        a = _random_actions(rng, N, A)
        given = (torch.from_numpy(a), a, env.fetch(torch.from_numpy(a)))[t % 3]
        _, out = env.step(state, given)
        next_obs, r, term, tout, after = ref.step(a)
        packed = np.concatenate([obs, a, r[:, None], next_obs, term[:, None], tout[:, None], after],
                                axis=1)
        for k, col in (("obs", packed[:, :12]), ("actions", packed[:, 12:15]),
                       ("reward", r), ("next_obs", next_obs), ("terminal", term),
                       ("timeout", tout)):
            np.testing.assert_array_equal(out[k].numpy(), col, err_msg=f"step {t} {k}")
        np.testing.assert_array_equal(out["done"].numpy(), (term + tout) > 0)
        np.testing.assert_array_equal(state["obs"].numpy(), after)
        np.testing.assert_array_equal(out["host"]["obs"], after)
        np.testing.assert_array_equal(out["host"]["reward"], r)
        obs = after
    env.close()
    ref.close()


def test_make_env_backends():
    """`jax` has the array envs only; an unknown backend is refused;
    `auto` takes the stepper where it builds; `mujoco` takes gymnasium's."""
    with pytest.raises(NotImplementedError, match="env_backend=native, auto or mujoco"):
        make_env("hopper", 2, absorbing=True)
    with pytest.raises(ValueError, match="unknown env_backend"):
        make_env("hopper", 2, absorbing=True, backend="brax")
    auto = make_env("walker2d", 2, absorbing=False, backend="auto")
    gym = make_env("walker2d", 2, absorbing=False, backend="mujoco")
    assert isinstance(auto.env, native.NativeVecEnv) and isinstance(gym.env, host.HostVecEnv)
    assert auto.obs_size == gym.obs_size == 17
    auto.close()
    gym.close()


def test_stepper_refuses_malformed_input():
    """The C calls get no buffer of the wrong size: actions, states and env
    indices are checked before the pointers are passed."""
    env = native.NativeVecEnv("hopper", 2, seed=0)
    env.reset()
    for call in (lambda: env.step(np.zeros((2, 4), np.float32)),
                 lambda: env.step(np.zeros((3, 3), np.float32)),
                 lambda: env.set_state(0, np.zeros(5), np.zeros(6)),
                 lambda: env.get_state(2, 6, 6),
                 lambda: native.NativeVecEnv("humanoid", 1)):
        with pytest.raises(ValueError):
            call()
    env.close()
