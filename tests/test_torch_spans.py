"""The host loop's span recorder (`iltpu_torch/utils/spans.py`) on the CPU:
the spans of short GAIL runs on the native hopper stepper nest as the loop
runs (plain and pipelined, per update and K-blocked), a recorder left off
calls nothing and reads no clock, the same seed gives the same bits with it
on and off, `profile_acting`'s parts add up, and each of the benchmark's
span readers (`portbench/metrics/`) gives a known answer on synthetic
spans and a synthetic parsed trace."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from iltpu_torch.config import load_config
from iltpu_torch.trainer import Trainer
from iltpu_torch.utils import spans as spans_mod
from iltpu_torch.utils.spans import Recorder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
HOPPER = [
    "algorithm=GAIL", "env=hopper", "env_backend=native", "platform=cpu",
    f"expert_data.source={os.path.join(REPO, 'data', 'hopper_expert.npz')}",
    f"num_envs={N}", "steps=96", "training.start=32", "training.batch_size=16",
    "reinforcement.actor.hidden_size=32", "reinforcement.critic.hidden_size=32",
    "imitation.discriminator.hidden_size=16", "imitation.trajectories=2", "memory.size=1000",
    "training.sac_pallas=true", "training.disc_pallas=true", "training.fused_update_scan=true",
    "evaluation.interval=1000000", "logging.interval=0", "check_time_usage=false",
]
LOOPS = {"plain": [], "pipelined": ["training.pipeline=true"]}


def _trainer(tmp_path, name, extra=()):
    out = str(tmp_path / name)
    return Trainer(load_config(HOPPER + list(extra) + [f"output_dir={out}"]), out_dir=out)


def _run(tmp_path, name, extra=(), on=True):
    t = _trainer(tmp_path, name, extra)
    t.spans = Recorder() if on else None
    t.run()
    return t


def _children(spans, i, name):
    return [s for s in spans if s[3] == i and s[0] == name]


# ------------------------------------------------------------ the program's spans


@pytest.mark.parametrize("loop", list(LOOPS))
def test_spans_nest_as_the_loop_runs(tmp_path, loop):
    """Every update inside an updates inside an iteration, as many as the
    iteration's n_updates, one front an iteration; every span closed and
    inside its parent; each env step carries the id of the iteration whose
    front appends its transitions."""
    t = _trainer(tmp_path, loop, LOOPS[loop])
    rec = t.spans = Recorder()
    stepped, appended = [], []  # (span index open at the stepper's call, next_obs)
    stepper, front = t.env.env.step, t.front

    def step(actions):
        out = stepper(actions)
        stepped.append((rec._open[-1][0], out[0].copy()))
        return out

    def front_hook(step, obs, actions, rewards, next_obs, *args, **kwargs):
        appended.append((rec.spans[rec._open[-1][0]][4], next_obs.numpy().copy()))
        return front(step, obs, actions, rewards, next_obs, *args, **kwargs)

    t.env.env.step, t.front = step, front_hook
    t.run()
    sp = rec.spans
    iters = [i for i, s in enumerate(sp) if s[0] == "iteration"]
    assert [sp[i][4] for i in iters] == list(range(0, 96, N))
    assert sum(sp[i][5] for i in iters) == t.updates_done == 96 - 32 + 1
    for i in iters:
        assert sp[i][3] == -1
        (f,) = _children(sp, i, "front")
        assert f[5] == sp[i][5] * 16 and f[4] == sp[i][4]
        ups = _children(sp, i, "updates")
        assert len(ups) == (1 if sp[i][5] else 0)
        for u in ups:
            assert u[5] == sp[i][5]
            k = sp.index(u)
            assert [s[5] for s in _children(sp, k, "update")] == [1] * u[5]
    assert all(sp[s[3]][0] == "updates" for s in sp if s[0] == "update")
    for name, start, end, parent, _, _ in sp:
        assert start <= end
        if parent >= 0:
            assert sp[parent][1] <= start and end <= sp[parent][2], name
    assert not rec._open
    # each env step's id is the iteration whose front appends what it stepped
    env_ids = [sp[k][4] for k, _ in stepped]
    assert all(sp[k][0] == "env_step" and sp[k][5] == N for k, _ in stepped)
    assert sorted(env_ids) == [sp[i][4] for i in iters]
    by_id = dict(zip(env_ids, (o for _, o in stepped)))
    for it, next_obs in appended:
        np.testing.assert_array_equal(by_id[it], next_obs)
    if loop == "pipelined":  # the next iteration's env step runs inside this one
        assert all(sp[sp[k][3]][4] == sp[k][4] - N for k, _ in stepped[1:])
    else:
        assert all(sp[sp[k][3]][4] == sp[k][4] for k, _ in stepped)


def test_recorder_off_calls_nothing_and_reads_no_clock(tmp_path, monkeypatch):
    """With the recorder off the loop calls no function of the recorder's
    module (so reads no clock and allocates nothing there): the clock
    raises, and a profile of every call sees none into it."""

    def clock():
        raise AssertionError("the recorder's clock was read")

    monkeypatch.setattr(spans_mod, "now", clock)
    t = _trainer(tmp_path, "off", LOOPS["pipelined"])
    called = []

    def profile(frame, event, arg):
        if event == "call" and frame.f_code.co_filename == spans_mod.__file__:
            called.append(frame.f_code.co_name)

    sys.setprofile(profile)
    try:
        t.run()
    finally:
        sys.setprofile(None)
    assert t.spans is None and t.env.spans is None and not called
    assert t.updates_done == 96 - 32 + 1
    with pytest.raises(AssertionError, match="clock was read"):  # the clock the recorder reads
        Recorder().begin("front")


@pytest.mark.parametrize("loop", list(LOOPS))
def test_recorder_on_and_off_give_the_same_bits(tmp_path, loop):
    on = _run(tmp_path, "on", LOOPS[loop], on=True)
    off = _run(tmp_path, "off", LOOPS[loop], on=False)
    assert on.spans.spans and off.spans is None
    assert on.metrics == off.metrics and on.metrics["train_returns"]
    a, b = on.state_tensors(), off.state_tensors()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_kblocked_path_one_update_span_a_launch(tmp_path, monkeypatch):
    """update_block=16: one `update` span a K-blocked launch, attribute 16;
    the iteration whose count 16 does not divide runs per update."""
    import iltpu_torch.trainer as trainer_mod

    launches, kblock = [], trainer_mod.kblock_update
    t = _trainer(tmp_path, "k16", ["num_envs=16", "training.update_block=16",
                                   "training.pipeline=true"])
    rec = t.spans = Recorder()

    def counted(*args):
        launches.append(rec._open[-1][0])
        return kblock(*args)

    monkeypatch.setattr(trainer_mod, "kblock_update", counted)
    t.run()
    sp = rec.spans
    ups = [s for s in sp if s[0] == "update"]
    assert [s[5] for s in ups] == [1] + [16] * 4  # 1 update at start, then 16 an iteration
    assert [sp[k] for k in launches] == ups[1:]
    for k, s in enumerate(sp):
        if s[0] == "updates":
            assert sum(c[5] for c in _children(sp, k, "update")) == s[5]


def test_recorder_keep_false_keeps_nothing_and_nests_record_functions():
    rec = Recorder(keep=False)
    rec.top(0, 2)
    rec.begin("front")
    rec.profiling = True  # a window opening inside a span closes it cleanly
    rec.begin("updates", 2)
    rec.end()
    rec.profiling = False
    rec.end()
    rec.end()
    assert rec.spans == [] and rec._open == []


def test_profile_acting_parts_add_up(tmp_path):
    from iltpu_torch.profile_acting import PARTS, parts

    t = _run(tmp_path, "parts", LOOPS["pipelined"])
    ms, iters = parts(t.spans.spans)
    whole = sum(1e-6 * (e - s) for n, s, e, *_ in t.spans.spans if n == "iteration")
    assert iters == 96 // N and set(ms) == set(PARTS) | {"rest"}
    assert ms["front"] > 0 and ms["updates"] > 0 and ms["rest"] > 0
    assert sum(ms.values()) == pytest.approx(whole)


# ------------------------------------------------------------ the benchmark's readers

MS = 1_000_000  # ns


def _reader(name):
    """`portbench/metrics/<name>.py`'s `read`, loaded as the benchmark loads it."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", os.path.join(REPO, "portbench", "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _synthetic():
    """A host window of 10 ms (two iterations), a sub-window of 10 ms whose
    start, the trace's 1,000 us, falls at host 20 ms (one iteration), and its device
    events. Expected: updates of 1,000 us (three) and 600 us (two units of
    2; a mean would read 840), fronts of 0.5 and 0.7 ms, waits of 0.8 ms in
    10; in the sub-window 1,900 us idle in the updates, one gap running on
    past their end, and 3,500 us in the env step; 3 launches from its 4
    updates."""
    rows = [  # name, start ms, end ms, parent, attr
        ("iteration", 0.0, 5.0, -1, 3), ("front", 0.0, 0.5, 0, 64),
        ("updates", 0.5, 3.5, 0, 3), ("update", 0.5, 1.5, 2, 1), ("update", 1.5, 2.5, 2, 1),
        ("update", 2.5, 3.5, 2, 1), ("env_step", 3.5, 4.5, 0, 8), ("wait", 3.6, 3.8, 6, 1),
        ("wait", 4.6, 4.8, 0, 0),
        ("iteration", 5.0, 10.0, -1, 4), ("front", 5.0, 5.7, 9, 64),
        ("updates", 5.7, 8.1, 9, 4), ("update", 5.7, 6.9, 11, 2), ("update", 6.9, 8.1, 11, 2),
        ("env_step", 8.1, 9.5, 9, 8), ("wait", 8.2, 8.5, 14, 1), ("wait", 9.6, 9.7, 9, 0),
        # the sub-window's iteration, past the host window: left out of its metrics
        ("iteration", 20.0, 30.0, -1, 4), ("front", 20.0, 21.0, 17, 256),
        ("updates", 21.0, 25.0, 17, 4), ("update", 21.0, 22.0, 19, 1),
        ("update", 22.0, 23.0, 19, 1), ("update", 23.0, 24.0, 19, 1),
        ("update", 24.0, 25.0, 19, 1), ("env_step", 25.0, 28.0, 17, 8),
    ]
    spans = [(n, round(a * MS), round(b * MS), p, 0, attr) for n, a, b, p, attr in rows]
    kernels = [(1000.0, 1500.0), (1600.0, 2200.0), (2300.0, 3000.0), (3500.0, 5500.0),
               (6800.0, 7000.0), (10500.0, 11000.0)]
    launched = [990.0, 1550.0, 2100.0, 2500.0, 5900.0, 10400.0]
    # tied at the marker's launch call's end, 500 us after its kernel began
    trace = {"window_us": (1000.0, 11000.0), "h_marker": 0.0205, "tie_us": 1500.0,
             "kernels": [(s, e, "k") for s, e in kernels],
             "launches": sorted(zip((s for s, _ in kernels), launched)) + [(10600.0, None)]}
    return {"spans": {"spans": spans, "host_ns": (0, 10 * MS)}, "trace": trace}


def _edge():
    """Gaps across an `updates` span's edges: one opening 1 us before the
    span (in the front) and running into it, one opening inside it and
    running past its end."""
    spans = [("iteration", 0, 10 * MS, -1, 0, 2), ("front", 0, 2 * MS, 0, 0, 32),
             ("updates", 2 * MS, 6 * MS, 0, 0, 2), ("env_step", 6 * MS, 9 * MS, 0, 0, 8)]
    kernels = [(0.0, 1999.0), (2500.0, 5000.0), (9000.0, 10000.0)]
    trace = {"window_us": (0.0, 10000.0), "h_marker": 0.0, "tie_us": 0.0,
             "kernels": [(s, e, "k") for s, e in kernels], "launches": []}
    return {"spans": {"spans": spans, "host_ns": (0, 10 * MS)}, "trace": trace}


READINGS = [
    ("update_issue_us", _synthetic, 1000.0),
    ("launches_per_update", _synthetic, 0.75),
    ("front_ms", _synthetic, 0.6),
    ("host_wait_pct", _synthetic, 8.0),
    ("idle_in_issue_pct", _synthetic, 19.0),
    ("idle_in_env_pct", _synthetic, 35.0),
    ("idle_in_issue_pct", _edge, 40.0),  # 4,000 us from 5,000 (opened inside), not 501 from 1,999
    ("idle_in_env_pct", _edge, 0.0),  # the gap into the env step opened in the updates
]


@pytest.mark.parametrize("name,ctx,want", READINGS,
                         ids=[f"{n}-{c.__name__[1:]}" for n, c, _ in READINGS])
def test_span_reader_known_answer(name, ctx, want):
    assert _reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted({n for n, _, _ in READINGS}))
def test_span_reader_reads_nothing_without_spans(name):
    ctx = _synthetic()
    assert _reader(name)(dict(ctx, spans=None)) is None
    assert _reader(name)({"window": {}, "trace": None}) is None


def _raw(first_marker=True, runtime=True):
    """Raw Chrome trace events of a sub-window: the marker launched at 100
    us in a call returning at 500 (its kernel at 150), a kernel launched at
    600, a copy whose launch the trace lost, and the closing marker."""
    def dev(cat, name, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    def call(ts, dur, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    events = [dev("kernel", "void k()", 700.0, 50.0, 2), dev("gpu_memcpy", "Memcpy HtoD", 800.0, 10.0, 3),
              dev("kernel", "spin_kernel(long)", 1000.0, 1.0, 4)]
    if first_marker:
        events.append(dev("kernel", "spin_kernel(long)", 150.0, 1.0, 1))
    if runtime:
        events += [call(100.0, 400.0, 1), call(600.0, 5.0, 2), call(900.0, 5.0, 4)]
    return events


@pytest.mark.parametrize("first_marker,runtime,w0,tie", [
    (True, True, 150.0, 500.0),  # the marker's launch call's end, not its kernel's start
    (False, True, 700.0, 500.0),  # the first marker lost: the trace's first launch is its
    (True, False, 150.0, 150.0),  # no launch in the trace: the window's start
], ids=["marker", "marker-lost", "no-launches"])
def test_attach_ties_at_the_marker_launch(first_marker, runtime, w0, tie):
    from portbench import spans as bench_spans

    tr = bench_spans.attach({"window_us": (w0, 1001.0)}, _raw(first_marker, runtime), 2.0)
    assert tr["h_marker"] == 2.0 and tr["tie_us"] == tie
    assert tr["launches"] == [(700.0, 600.0 if runtime else None), (800.0, None)]
    assert bench_spans.to_host_ns(tr, tie + 1.0) == 2_000_001_000
