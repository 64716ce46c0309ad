"""The algorithm adapters and the K-blocked path, at a small size on the CPU:

- the existing cells' readings of `correct`, pinned bit for bit on fixed
  seeds (the values of the tree before the adapters were split out);
- a configuration of another algorithm (SAC) driven from files alone: its
  configuration and limits written where the harness finds them by name,
  through `run.py`, `harness.py` and `correct.py` as they are;
- the K-blocked traffic at K = 4, `correct` true, and false under the
  K-blocked kernel's faults and an altered ring;
- the BC auxiliary step (`imitation.bc_aux_loss`) on the SAC configuration,
  and DRIL with a reward model trained in set-up (20 pretraining steps
  here): `correct` true, and false under each of their faults and the
  shared ones.
"""

import contextlib
import json
import os

import pytest

from portbench import algorithms, calibrate, faults, harness, run
from portbench.tests.conftest import SMALL

BENCH = run.load_benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}

# (cell, extra overrides, seed) -> every number compared, as repr, and the
# program's losses
PINNED = {
    ("gail_hopper.pipelined-512", (), 7): (
        {"start_state_gap": "0.0", "batch_rows_unknown": "0", "expert_rows_unknown": "0",
         "ring_rows_wrong": "0", "loss_gap": "0.0", "grad_gap": "5.4789454082807484e-08",
         "change_gap": "0.0"},
        "[1.5614930391311646, 1.7466360330581665, 1.71440589427948]"),
    ("gail_hopper.pipelined-512", (), 2147485111): (
        {"start_state_gap": "0.0", "batch_rows_unknown": "0", "expert_rows_unknown": "0",
         "ring_rows_wrong": "0", "loss_gap": "0.0", "grad_gap": "1.6955303609298512e-08",
         "change_gap": "0.0"},
        "[1.217458963394165, 1.189479947090149, 1.2258094549179077]"),
    ("gail_ant_tuned5.pipelined-64", ("training.start=256",), 7): (
        {"start_state_gap": "0.0", "batch_rows_unknown": "0", "expert_rows_unknown": "0",
         "ring_rows_wrong": "0", "loss_gap": "0.0", "grad_gap": "7.746579633328048e-08",
         "change_gap": "0.0"},
        "[0.6977800726890564, 0.8405544757843018, 0.7220444679260254]"),
    ("gail_ant_tuned5.pipelined-64", ("training.start=256",), 2147485111): (
        {"start_state_gap": "0.0", "batch_rows_unknown": "0", "expert_rows_unknown": "0",
         "ring_rows_wrong": "0", "loss_gap": "0.0", "grad_gap": "3.6530635125807095e-08",
         "change_gap": "0.0"},
        "[0.7384797930717468, 0.6938601732254028, 0.6540960073471069]"),
}


def _run(workload, seed=7, extra=(), fault=None, bench=BENCH):
    plant = faults.planted(fault) if fault else contextlib.nullcontext()
    with plant:
        return run.measure(bench, workload, seed, 0.5, False, extra=SMALL + list(extra))


@pytest.mark.parametrize("cell, extra, seed", list(PINNED), ids=lambda x: str(x))
def test_existing_cells_read_as_before(cell, extra, seed):
    r = calibrate.reading(CELLS[cell], "program", seed, 0.5, SMALL + list(extra))
    numbers, losses = PINNED[(cell, extra, seed)]
    assert {k: repr(v) for k, v in r["numbers"].items()} == numbers
    assert repr(r["detail"]["losses"]) == losses
    assert r["correct"] is True and r["detail"]["lead_units"] == 0 and r["detail"]["unit"] == 1


# ------------------------------------------------------------------ SAC

SAC_CONFIG = {
    "name": "_test_sac_hopper",
    "source": "https://github.com/Kaixhin/imitation-learning/blob/master/conf/algorithm/SAC.yaml",
    "why": "a configuration of another algorithm, from files alone",
    "use_tuned": False,
    "overrides": ["algorithm=SAC", "env=hopper", "env_backend=native", "platform=gpu",
                  "imitation.trajectories=5", "memory.size=1000000", "training.start=1000",
                  "training.sac_pallas=true"],
    "expert_file": "data/hopper_expert.npz", "sizes": {}, "reduced": [], "assumed": [],
}
SAC_LIMITS = {"limits": {"loss_gap": 8e-7, "grad_gap": 8e-6, "change_gap": 1e-7},
              "set_from": {"loss_gap": "the CPU test's own", "grad_gap": "the CPU test's own",
                           "change_gap": "the CPU test's own"}}


@pytest.fixture(scope="module")
def sac_cell():
    """The SAC configuration's files where the harness finds them by name,
    removed after."""
    paths = [os.path.join(harness.HERE, kind, f"{SAC_CONFIG['name']}.json")
             for kind in ("configs", "limits")]
    try:
        for path, body in zip(paths, (SAC_CONFIG, SAC_LIMITS)):
            with open(path, "w") as f:
                json.dump(body, f)
        yield {"name": f"{SAC_CONFIG['name']}.pipelined-512", "config": SAC_CONFIG["name"],
               "traffic": "pipelined-512", "chips": 1, "why": "test"}
    finally:
        for path in paths:
            if os.path.exists(path):
                os.remove(path)


def test_sac_config_runs_from_files(sac_cell):
    result, lines, _ = _run(sac_cell)
    assert result["correct"] is True, lines
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert algorithms.adapter("SAC").PARAMS is None


@pytest.mark.parametrize("fault", ["sac_unchanged", "sac_half", "reward_altered", "ring_altered"])
def test_sac_config_faults_fail(sac_cell, fault):
    result, lines, _ = _run(sac_cell, fault=fault)
    assert result["correct"] is False, lines


def test_sac_run_holds_no_discriminator(sac_cell):
    config = harness.load_named("configs", sac_cell["config"])
    traffic = harness.load_named("traffic", sac_cell["traffic"])
    out = harness.run_cell(config, traffic, 7, 0.5, False, 0.0, SMALL)
    assert out["run"].model is algorithms.adapter("SAC")
    assert set(out["weights"]) == {"actor", "critic", "sn"} and out["weights"]["sn"] == []
    assert set(out["run"].state_before) == {"a", "am", "c", "cm", "t", "la", "lam"}


# ------------------------------------------------------------ K-blocked

KBLOCK = "gail_hopper.kblock16-512"
K4 = ["training.update_block=4"]


def test_kblock_cell_is_correct():
    result, lines, _ = _run(CELLS[KBLOCK], extra=K4)
    assert result["correct"] is True, lines


def test_kblock_units_are_checked():
    config = harness.load_named("configs", "gail_hopper")
    traffic = harness.load_named("traffic", "kblock16-512")
    out = harness.run_cell(config, traffic, 11, 0.5, False, 0.0, SMALL + K4)
    r = out["run"]
    # 8 envs from training.start=64: the first iteration owes 1 update, the next 8 (2 units)
    assert r.K == 4 and r.lead == 1 and r.checked == 3
    assert [x["tb"]["states"].shape[0] for x in r.captured] == [1, 4, 4, 4]
    assert out["checks"]["correct"] is True


@pytest.mark.parametrize("fault", ["kblock_unchanged", "kblock_half", "ring_altered"])
def test_kblock_faults_fail(fault):
    result, lines, _ = _run(CELLS[KBLOCK], extra=K4, fault=fault)
    assert result["correct"] is False, lines


def test_limits_by_cell_then_by_config():
    from portbench import correct

    assert correct.limits_of("gail_hopper", "pipelined-512")["loss_gap"] == 8e-7
    with open(os.path.join(harness.HERE, "limits", "gail_hopper.kblock16-512.json")) as f:
        own = json.load(f)["limits"]
    assert {k: correct.limits_of("gail_hopper", "kblock16-512")[k] for k in own} == own


@pytest.mark.cuda
def test_kblock_control_fails_on_the_card(card):
    for seed in (101, 102, 103):
        r = calibrate.reading(CELLS[KBLOCK], "control", seed, 1.0)
        assert r["correct"] is False, r["numbers"]


# ----------------------------------------------------- the BC auxiliary step

BC_AUX = ["imitation.bc_aux_loss=true"]


def test_sac_config_with_bc_aux_is_correct(sac_cell):
    result, lines, _ = _run(sac_cell, extra=BC_AUX)
    assert result["correct"] is True, lines


@pytest.mark.parametrize("fault", ["bc_aux_skipped", "bc_aux_half"])
def test_sac_config_with_bc_aux_faults_fail(sac_cell, fault):
    result, lines, _ = _run(sac_cell, extra=BC_AUX, fault=fault)
    assert result["correct"] is False, lines


# ------------------------------------------------------------------ DRIL

DRIL = "dril_ant_tuned5.pipelined-64"  # queued: its files, not yet a cell of BENCHMARK.json
DRIL_SMALL = ["imitation.pretraining.iterations=20"]
DRIL_NUMBERS = ("pretrain_steps_wrong", "pretrain_gap", "threshold_gap", "reward_rows_wrong")


def test_dril_cell_is_correct():
    config = harness.load_named("configs", "dril_ant_tuned5")
    traffic = harness.load_named("traffic", "pipelined-64")
    out = harness.run_cell(config, traffic, 7, 0.5, False, 0.0, SMALL + DRIL_SMALL)
    checks, setup = out["checks"], out["run"].setup
    assert checks["correct"] is True, checks["numbers"]
    assert set(DRIL_NUMBERS) <= set(checks["numbers"])
    assert checks["numbers"]["pretrain_steps_wrong"][0] == 0
    # the first three pretraining steps and the threshold's masks, over every expert row
    assert len(setup["batches"]) == len(setup["masks"]) == 3
    assert setup["thr_masks"][0].shape[:2] == (5, 5000)
    assert int(setup["end"]["t"].item()) == 20 and float(setup["threshold"]) > 0
    # the reward calls of the loop's last iteration, after the window's close: 8 envs, 8 updates
    assert len(setup["closing"]) == 8 and setup["closing"][0]["rewards"].shape == (32,)


@pytest.mark.parametrize("fault", [f for f in faults.SHARED + algorithms.adapter("DRIL").FAULTS
                                   if f != "control"])
def test_dril_faults_fail(fault):
    result, lines, _ = _run(calibrate.workload_of(DRIL), extra=DRIL_SMALL, fault=fault)
    assert result["correct"] is False, lines


@pytest.mark.cuda
def test_dril_control_fails_on_the_card(card):
    for seed in (101, 102, 103):
        r = calibrate.reading(calibrate.workload_of(DRIL), "control", seed, 1.0)
        assert r["correct"] is False, r["numbers"]
