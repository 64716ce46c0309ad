"""A whole run of each cell at a small size on the CPU, past the harness's
look for a card: the result's last line, and `correct` false under every
planted fault of its algorithm (the other adapters' faults touch what
this cell does not run). The control (TF32) runs only on the card."""

import contextlib
import json

import pytest

from portbench import algorithms, faults, run
from portbench.tests.conftest import SMALL

BENCH = run.load_benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}
HOPPER = "gail_hopper.pipelined-512"


def _measure(name, seed=7, seconds=0.5, extra=(), fault=None):
    plant = faults.planted(fault) if fault else contextlib.nullcontext()
    with plant:
        return run.measure(BENCH, CELLS[name], seed, seconds, False, extra=SMALL + list(extra))


def test_result_line_keys():
    result, lines, record = _measure(HOPPER)
    assert result["correct"] is True
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {l.split(":")[0].split()[1] for l in lines if l.startswith("check ")}
    assert {"cpu", "logical_cores", "loadavg", "probe_ms", "nvidia_smi"} <= set(record)
    json.dumps(result)


def test_ant_cell_runs():
    result, _, _ = _measure("gail_ant_tuned5.pipelined-64", extra=["training.start=256"])
    assert result["correct"] is True


@pytest.mark.parametrize("fault", [f for f in faults.SHARED + algorithms.adapter("GAIL").FAULTS
                                   if f != "control" and not f.startswith("kblock")])
def test_fault_fails(fault):
    result, lines, _ = _measure(HOPPER, fault=fault)
    assert result["correct"] is False, lines


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", HOPPER, "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_control_fails_on_the_card(card):
    from portbench import calibrate

    for seed in (101, 102, 103):
        r = calibrate.reading(CELLS[HOPPER], "control", seed, 1.0)
        assert r["correct"] is False, r["numbers"]
