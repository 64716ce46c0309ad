"""The port's replay ring and expert pipeline (iltpu_torch/data) against
iltpu's: identical ring contents after the same appends, including
wrap-around and absorbing rows; equal samples given the same raw integers;
equal expert transitions on data/hopper_expert_v2.npz."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iltpu.data import dataset as JDS
from iltpu.data import replay as JR
from iltpu.data.synthetic import random_d4rl_dataset as j_random
from iltpu_torch.data import build_expert_transitions, random_d4rl_dataset
from iltpu_torch.data import replay as TR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLS = ("step", "states", "actions", "rewards", "next_states", "terminals", "timeouts", "weights")


def _assert_same_ring(t, j):
    for c in COLS:
        np.testing.assert_array_equal(t.rows(c).numpy(), np.asarray(getattr(j, c)), err_msg=c)
    assert int(t.idx) == int(j.idx)
    assert bool(t.full) == bool(j.full)
    assert int(t.num_trajectories) == int(j.num_trajectories)


@pytest.mark.parametrize("absorbing", [True, False])
def test_ring_identical_after_appends_with_wrap(absorbing):
    S, A, size, n = 5, 2, 23, 6
    j = JR.replay_init(size, S, A, absorbing)
    t = TR.replay_init(size, S, A, absorbing)
    rng = np.random.default_rng(0)
    for it in range(9):  # 9 x up to 12 rows wraps the 23-row ring several times
        d = {
            "step": np.full(n, it * n + 1, np.float32),
            "states": rng.normal(size=(n, S)).astype(np.float32),
            "actions": rng.normal(size=(n, A)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_states": rng.normal(size=(n, S)).astype(np.float32),
            "terminals": (rng.uniform(size=n) < 0.4).astype(np.float32),
            "timeouts": (rng.uniform(size=n) < 0.2).astype(np.float32),
        }
        valid = rng.uniform(size=n) < 0.85
        j = JR.replay_append_batch(j, *(jnp.asarray(d[k]) for k in d), valid=jnp.asarray(valid))
        TR.replay_append_batch(t, *(torch.from_numpy(d[k]) for k in d), valid=torch.from_numpy(valid))
        _assert_same_ring(t, j)
    assert bool(t.full)


@pytest.mark.parametrize("fill", [3, 40])
def test_sample_equal_given_raw_integers(fill):
    S, A, size = 4, 2, 30
    j = JR.replay_init(size, S, A, True)
    t = TR.replay_init(size, S, A, True)
    rng = np.random.default_rng(1)
    for _ in range(fill // 2):
        d = [np.full(2, 1.0, np.float32), rng.normal(size=(2, S)).astype(np.float32),
             rng.normal(size=(2, A)).astype(np.float32), rng.normal(size=2).astype(np.float32),
             rng.normal(size=(2, S)).astype(np.float32), (rng.uniform(size=2) < 0.3).astype(np.float32),
             np.zeros(2, np.float32)]
        j = JR.replay_append_batch(j, *map(jnp.asarray, d))
        TR.replay_append_batch(t, *map(torch.from_numpy, d))
    key = jax.random.key(3)
    want = JR.replay_sample(j, key, 64)
    limit = int(TR.sample_limit(t))
    r = np.array(jax.random.randint(key, (64,), 0, limit))
    got = TR.replay_sample(t, 64, r=torch.from_numpy(r))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # drawn by the port itself: in range, never the last write
    if bool(t.full):
        drawn = TR.replay_sample(t, 4096, torch.Generator().manual_seed(0))
        last = (int(t.idx) - 1) % size
        assert not (drawn["states"] == t.states[last]).all(1).any()


@pytest.mark.parametrize("trajectories,subsample", [(5, 1), (3, 4), (0, 20)])
def test_expert_transitions_on_hopper_data(trajectories, subsample):
    with np.load(os.path.join(REPO, "data", "hopper_expert_v2.npz")) as f:
        data = {k: f[k] for k in f.files}
    for absorbing in (True, False):
        got, n = build_expert_transitions(data, trajectories, subsample, absorbing, np.random.default_rng(7))
        want, m = JDS.build_expert_transitions(data, trajectories, subsample, absorbing, np.random.default_rng(7))
        assert n == m and got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        t = TR.replay_from_transitions(got, n, absorbing)
        jr = JR.replay_from_transitions(want, m, absorbing)
        _assert_same_ring(t, jr)


def test_synthetic_dataset_equal():
    a = random_d4rl_dataset(np.random.default_rng(4), [7, 9], 5, 2, [False, True])
    b = j_random(np.random.default_rng(4), [7, 9], 5, 2, [False, True])
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
