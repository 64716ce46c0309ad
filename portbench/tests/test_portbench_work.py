"""The work counts give the port's kernel table's bounds (PERF.md), every
product at the float32 rate."""

import pytest

from portbench import peaks
from portbench.work import gail_update, sac_update, step


@pytest.mark.parametrize("S, A, B, ms", [(12, 3, 256, 0.0084), (112, 8, 256, 0.0107),
                                         (112, 8, 1024, 0.0429)])
def test_sac_bounds(S, A, B, ms):
    bound = 1e3 * peaks.bound_s(sac_update.flops(S, A, B, 256), sac_update.nbytes(S, A, B, 256))
    assert round(bound, 4) == ms
    # operations bound it: the products over the float32 rate
    assert sac_update.flops(S, A, B, 256) / peaks.FP32_FLOPS > sac_update.nbytes(S, A, B, 256) / peaks.HBM_BYTES


def test_gail_and_step_counts():
    # hopper (256, 15, 64), BCE: half the hidden units on
    f = gail_update.flops(256, 15, 64, 0.5, False)
    assert f == 2 * 15 * 64 * (512 + 256 * 2.5 + 768 + 256) + 2 * 64 * (512 + 768 + 256) + 4 * 15 * 64
    assert 1e3 * peaks.bound_s(f, gail_update.nbytes(256, 12, 3, 64, True, False)) == pytest.approx(
        6.53e-5, rel=1e-2)
    assert step.flops(12, 3, 256, 256, 64, 0.5, False) == pytest.approx(0.5672e9, rel=1e-3)
    assert step.flops(112, 8, 1024, 256, 64, 0.5, True) == pytest.approx(2.978e9, rel=1e-3)
    # Mixup has B loss rows, BCE 2B: fewer products
    assert gail_update.flops(1024, 120, 64, 0.5, True) < gail_update.flops(1024, 120, 64, 0.5, False)


def test_active_share():
    import torch

    gx = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    W1 = torch.tensor([[1.0, -1.0], [1.0, 1.0]])
    assert gail_update.active_share(gx, W1, torch.zeros(2)) == 0.75


def test_kblock_bound():
    from portbench.work import kblock_update

    # hopper, K = 16: the SAC bound sixteen times (PERF.md's table: 0.0084 ms an
    # update) and the GAIL steps' at the float32 rate; operations bound it
    f = kblock_update.flops(16, 12, 3, 256, 256, 64, 0.5, False)
    b = kblock_update.nbytes(16, 12, 3, 256, 256, 64, True, False)
    assert f == 16 * (sac_update.flops(12, 3, 256, 256) + gail_update.flops(256, 15, 64, 0.5, False))
    assert 1e3 * peaks.bound_s(f, b) == pytest.approx(0.1355, rel=1e-3)
    assert f / peaks.FP32_FLOPS > b / peaks.HBM_BYTES
    # the states once a launch, the batches once a micro-update
    assert kblock_update.nbytes(2, 12, 3, 256, 256, 64, True, False) - \
        kblock_update.nbytes(1, 12, 3, 256, 256, 64, True, False) == 4 * 256 * (2 * 12 + 3 + 3 + 16 + 7)


def test_dril_update_count():
    from portbench.work import dril

    # ant, batch 1024, the ensemble 112 -> 64 -> 16: the reward's 5 forwards,
    # the BC step's forward and backward of the 2 x 256 actor, the SAC update
    ens = [(112, 64), (64, 16)]
    assert dril.reward_flops(1024, ens) == 2 * 5 * 1024 * (112 * 64 + 64 * 16)
    fwd = 2 * 1024 * (112 * 256 + 256 * 256 + 256 * 16)
    assert dril.bc_flops(112, 8, 1024, 256) == fwd + 2 * fwd - 2 * 1024 * 112 * 256
    assert dril.flops(112, 8, 1024, 256, ens) == (dril.reward_flops(1024, ens) + dril.bc_flops(
        112, 8, 1024, 256) + sac_update.flops(112, 8, 1024, 256))
    # the SAC update is most of it
    assert 0.7 < sac_update.flops(112, 8, 1024, 256) / dril.flops(112, 8, 1024, 256, ens) < 0.9
