"""Every file the benchmark finds by a name loads, and BENCHMARK.json keeps
to the contract's shape."""

import json
import os
import re

import pytest

from portbench import harness, run

ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(w):
    config = harness.load_named("configs", w["config"])
    traffic = harness.load_named("traffic", w["traffic"])
    assert config["name"] == w["config"] and traffic["name"] == w["traffic"]
    assert os.path.exists(os.path.join(ROOT, config["expert_file"]))
    assert {"num_envs", "overrides", "warmup_iterations", "profile"} <= set(traffic)
    entry = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert entry["source"] == config["source"] and entry["reduced"] == config["reduced"]


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_loads(m):
    assert callable(run.reader(m["name"]))
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert any(w["name"] in p.get("workloads", [w["name"]]) for p in BENCH["per_layer"])
    assert 1 <= BENCH["run_seconds"] <= 51


def test_queued_cell_files_load():
    """The queued DRIL cell (`PERF.md` §7): its configuration, traffic and
    limits load by name, as a later entry in BENCHMARK.json would find them."""
    from portbench import calibrate, correct

    w = calibrate.workload_of("dril_ant_tuned5.pipelined-64")
    assert w["name"] not in {c["name"] for c in BENCH["workloads"]}
    config = harness.load_named("configs", w["config"])
    assert config["name"] == w["config"] and config["reduced"] == []
    assert "algorithm=DRIL" in config["overrides"] and config["use_tuned"] is True
    assert os.path.exists(os.path.join(ROOT, config["expert_file"]))
    lim = correct.limits_of(w["config"], w["traffic"])
    own = {"pretrain_steps_wrong", "pretrain_gap", "threshold_gap", "reward_rows_wrong"}
    assert own <= set(lim)
    assert lim["pretrain_steps_wrong"] == 0
