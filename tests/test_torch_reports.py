"""The port's analysis layer against iltpu's scripts, on the CPU at small
sizes: `iltpu_torch.analysis.seed_sweep_report` against
`scripts/print_plot_seed_sweep_results.py` on a runs tree and on results
rows under each filter; `iltpu_torch.analysis.hp_opt_report` against
`scripts/print_plot_hp_opt_results.py` (pandas, matplotlib); and
`iltpu_torch.validate_learning` against `scripts/validate_learning.py` with
one stub trainer in both. Then the reports and the harness run in a process
that never imports JAX, iltpu, pandas, matplotlib, PIL or PyYAML, and the
harness trains a real pointmass run whose row the seed-sweep report reads."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from iltpu.analysis import iqm as jax_iqm
from iltpu.analysis import stratified_bootstrap_ci as jax_ci
from iltpu_torch.analysis import collect_seed_sweep, hp_opt_report, seed_sweep_report
from test_analysis import _write_run
from test_torch_plotting import decode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = "300"


def run_both(capsys, jax_main, torch_main, args, tmp_path, png):
    """Each package's main on `args` plus its own `--out`: (results, printed
    lines, PNG path) of each, iltpu's first; the 'wrote' lines name the two
    paths and are compared apart."""
    out = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        path = str(tmp_path / f"{name}_{png}")
        result = main(args + ["--out", path])
        lines = capsys.readouterr().out.splitlines()
        out.append((result, lines, path))
    return out


# ------------------------------------------------------------ seed sweeps


def runs_tree(root):
    """3 seeds x 2 envs in iltpu's `<ALG>_<env>/<stamp>/metrics.pkl` layout."""
    for e, env in enumerate(("hopper", "walker2d")):
        for seed in range(3):
            _write_run(root, "BC", env, f"run{seed}", [0.2 + 0.1 * seed + 0.05 * e, 0.6 + 0.11 * seed - 0.03 * e])


def results_rows(path):
    """Rows of every variant the filters pick between: untuned and tuned,
    the base dataset, `<env>_expert_v2`, another dataset, an `--extra`
    variant, another trajectory count and num_envs, one untuned seed more
    than tuned on walker2d (`--tuned best`), and a curve on a coarser eval
    cadence (the step grids' intersection). Two evaluations a curve: each
    env panel's band is 1,000 bootstrap reps an evaluation."""
    rng = np.random.default_rng(3)
    rows = []

    def row(env, seed, tuned=True, dataset="", extra="", traj=10, num_envs=256, interval=10000, n=2):
        rows.append({
            "algorithm": "GAIL", "env": env, "trajectories": traj, "seed": seed, "steps": interval * n,
            "tuned": tuned, "num_envs": num_envs, "eval_interval": interval, "eval_episodes": 30,
            "data_fix": False, "dataset": dataset, "extra": extra,
            "final_normalized_score": float(rng.uniform()), "last_normalized_score": 0.0,
            "best_normalized_score": float(rng.uniform()),
            "eval_curve": [float(v) for v in rng.uniform(0, 1, n)],
            "out_dir": f"outputs/validation/GAIL_{env}/{seed}", "when": "01-01_00-00-00"})

    for env in ("hopper", "walker2d"):
        for seed in (1, 2, 3, 4):
            row(env, seed)
            row(env, seed, dataset=f"{env}_expert_v2")
            row(env, seed, dataset=f"{env}_expert_v2", extra="reinforcement.min_alpha=0.05")
            row(env, seed, tuned=False)
        row(env, 5, tuned=False)
        row(env, 1, traj=25)
        row(env, 1, num_envs=64)
    row("walker2d", 6, tuned=False)
    row("hopper", 5, dataset="hopper_expert_v2", interval=20000, n=1)  # the grid's 20k alone
    row("hopper", 9, dataset="other")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


ROW_FILTERS = {  # the filters that pool across envs on both, the rest on hopper
    "default": ["--envs", "hopper"],
    "tuned_yes": ["--tuned", "yes"],
    "tuned_no": ["--tuned", "no", "--envs", "walker2d"],
    "tuned_best": ["--tuned", "best"],
    "suffix_v2": ["--dataset", "_v2", "--tuned", "yes"],
    "dataset_full": ["--dataset", "hopper_expert_v2", "--envs", "hopper"],
    "extra": ["--dataset", "_v2", "--extra", "reinforcement.min_alpha=0.05", "--envs", "hopper"],
    "trajectories": ["--trajectories", "25", "--envs", "hopper"],
    "num_envs": ["--num-envs-filter", "64", "--tuned", "yes", "--envs", "walker2d"],
}


def check_report(capsys, tmp_path, args, n_envs):
    from scripts.print_plot_seed_sweep_results import main as jax_main

    (want, want_lines, want_png), (got, got_lines, got_png) = run_both(
        capsys, jax_main, seed_sweep_report.main, args + ["--json", "--reps", REPS], tmp_path, "fig.png")
    assert got == want
    assert got_lines[:-1] == want_lines[:-1]
    assert (want_lines[-1], got_lines[-1]) == (f"wrote {want_png}", f"wrote {got_png}")
    assert json.loads(got_lines[-2]) == json.loads(want_lines[-2]) == want
    w, h, img = decode_png(got_png)
    assert (w, h) == decode_png(want_png, pixels=False)[:2] == (480 * (n_envs + 1), 420)
    return img


def test_seed_sweep_report_runs_tree(tmp_path, capsys):
    root = str(tmp_path / "outputs")
    runs_tree(root)
    check_report(capsys, tmp_path, ["--root", root, "--algorithms", "BC", "--envs", "hopper", "walker2d"], 2)


@pytest.mark.parametrize("case", sorted(ROW_FILTERS))
def test_seed_sweep_report_from_results(tmp_path, capsys, case):
    rows = tmp_path / "RESULTS.jsonl"
    results_rows(rows)
    args = ["--from-results", str(rows), "--algorithms", "GAIL"] + ROW_FILTERS[case]
    if "--envs" not in args:
        args += ["--envs", "hopper", "walker2d"]
    check_report(capsys, tmp_path, args, len(args) - args.index("--envs") - 1)


def test_seed_sweep_report_missing_rows_raise_as_iltpu(tmp_path):
    from scripts.print_plot_seed_sweep_results import main as jax_main

    rows = tmp_path / "RESULTS.jsonl"
    results_rows(rows)
    args = ["--from-results", str(rows), "--algorithms", "GAIL", "--envs", "hopper", "ant",
            "--reps", REPS, "--out", str(tmp_path / "x.png")]
    with pytest.raises(FileNotFoundError) as want:
        jax_main(args)
    with pytest.raises(FileNotFoundError) as got:
        seed_sweep_report.main(args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("source", ["runs_tree", "random"])
def test_seed_sweep_panels_are_iltpus_formulas(tmp_path, source):
    """The numbers each panel draws: the env panels' IQM over seeds and
    1,000-rep band, the aggregate's per-eval point and CI at min(reps,
    2000) reps, by iltpu's functions; on the runs tree's tensor, and on 7
    random seeds, where each band's percentiles fall between resampled
    values (with 3 seeds they sit on the data's extremes, whatever the draws)."""
    if source == "runs_tree":
        runs_tree(str(tmp_path / "outputs"))
        _, tensor, _ = collect_seed_sweep(str(tmp_path / "outputs"), "BC", ["hopper", "walker2d"])
    else:
        tensor = np.random.default_rng(5).uniform(size=(7, 2, 2))
    for e in range(2):
        curve, band = seed_sweep_report.env_panel(tensor, e)
        np.testing.assert_array_equal(curve, jax_iqm(tensor[:, e, :], axis=0))
        np.testing.assert_array_equal(band, [jax_ci(tensor[:, e:e + 1, t], jax_iqm, reps=1000)
                                             for t in range(tensor.shape[-1])])
    for reps in (300, 5000):
        np.testing.assert_array_equal(
            seed_sweep_report.aggregate_curve(tensor, reps, 0.9),
            [jax_ci(tensor[..., t], jax_iqm, reps=min(reps, 2000), ci=0.9) for t in range(tensor.shape[-1])])


def test_parity_at_steps_is_the_reports_tensor(tmp_path, capsys):
    """`iltpu_torch.analysis.parity`: at each step of both files' common grid,
    each file's IQM and CI of the report's tensor there and their
    difference; a step past the grid missing."""
    from iltpu_torch.analysis import parity

    rows = str(tmp_path / "RESULTS.jsonl")
    results_rows(rows)
    args = ["--algorithms", "GAIL", "--envs", "hopper", "walker2d", "--tuned", "yes", "--reps", REPS]
    out = parity.main([rows, rows, *args, "--at", "10000", "30000"])
    steps, tensor = seed_sweep_report.tensor_from_rows(
        seed_sweep_report.parser().parse_args(args + ["--from-results", rows]), "GAIL")
    got = out["GAIL"]
    assert (got["seeds"], got["envs"], got["last_step"]) == ((4, 4), 2, 20000)
    assert got["at"][30000] is None
    for s, i in ((10000, 0), (20000, 1)):
        point, lo, hi = jax_ci(tensor[..., i], jax_iqm, reps=int(REPS))
        assert got["at"][s]["first"] == got["at"][s]["second"] == {"iqm": point, "ci_lo": lo, "ci_hi": hi}
        d = got["at"][s]["difference"]
        assert d["iqm"] == 0.0 and d["ci_lo"] < 0.0 < d["ci_hi"]
    assert len(capsys.readouterr().out.splitlines()) == 2


def difference_by_loop(a, b, reps, ci, seed=0):
    """The difference CI written out: the same draws (a's indices, then
    b's), each replicate's IQMs through iltpu's iqm one by one."""
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, a.shape[0], size=(reps, *a.shape))
    ib = rng.integers(0, b.shape[0], size=(reps, *b.shape))
    stats = [jax_iqm(np.take_along_axis(a, ia[r], 0)) - jax_iqm(np.take_along_axis(b, ib[r], 0))
             for r in range(reps)]
    lo, hi = np.percentile(stats, [50 * (1 - ci), 50 * (1 + ci)])
    return float(jax_iqm(a) - jax_iqm(b)), float(lo), float(hi)


@pytest.mark.parametrize("shape_a,shape_b,ci", [((10, 1), (10, 1), 0.95), ((3, 2), (5, 2), 0.9),
                                                ((7,), (4,), 0.95)])
def test_parity_difference_ci(shape_a, shape_b, ci):
    """The difference CI against its loop form on iltpu's iqm; a shift of the
    second sample by c moves the point and both ends by -c; samples far
    apart give a CI that excludes 0."""
    from iltpu_torch.analysis.parity import difference_ci

    rng = np.random.default_rng(len(shape_a) + shape_b[0])
    a, b = rng.normal(0.8, 0.1, shape_a), rng.normal(0.75, 0.2, shape_b)
    got = difference_ci(a, b, 400, ci)
    a2, b2 = (x.reshape(len(x), -1) for x in (a, b))
    np.testing.assert_allclose(got, difference_by_loop(a2, b2, 400, ci), rtol=0, atol=1e-12)
    np.testing.assert_allclose(difference_ci(a, b + 0.25, 400, ci), np.array(got) - 0.25,
                               rtol=0, atol=1e-12)
    far = difference_ci(a + 5.0, b, 400, ci)
    assert 0.0 < far[1] <= far[0] <= far[2]


# ------------------------------------------------------------------ HP-opt


def sweep_records(path, case):
    """tests/test_analysis.py's 8 records (float, bool and string
    parameters); `ties`: four equal min_scores; `missing`: a record without
    a parameter and one with a parameter of its own; `none`: no parameters."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for t in range(8):
            rec = {
                "trial": t,
                "params": {
                    "training.learning_rate": float(10 ** rng.uniform(-4, -3)),
                    "imitation.balanced": bool(t % 2),
                    "imitation.loss_function": ["BCE", "Mixup", "PUGAIL"][t % 3],
                },
                "min_score": float(rng.uniform()),
                "per_env": {"hopper": 0.5},
            }
            if case == "ties" and t in (1, 3, 4, 6):
                rec["min_score"] = 0.25
            if case == "missing":
                rec["method"] = "sobol" if t < 3 else "gp-ei"
                if t == 2:
                    del rec["params"]["imitation.balanced"]
                    del rec["params"]["imitation.loss_function"]
                if t == 5:
                    rec["params"]["imitation.grad_penalty"] = 1
                    rec["per_env"]["walker2d"] = 0.25
            if case == "none":
                rec["params"] = {}
            f.write(json.dumps(rec) + "\n")


@pytest.mark.parametrize("case", ["test_analysis", "ties", "missing", "none"])
@pytest.mark.parametrize("top", [10, 3])
def test_hp_opt_report_matches_iltpu(tmp_path, capsys, case, top):
    import pandas as pd
    from scripts.print_plot_hp_opt_results import _numeric, load_sweep, main as jax_main

    sweep = str(tmp_path / "sweep.jsonl")
    sweep_records(sweep, case)
    (ranked, want_lines, want_png), ((columns, rows), got_lines, got_png) = run_both(
        capsys, jax_main, hp_opt_report.main, [sweep, "--top", str(top)], tmp_path, "hp.png")
    assert columns == list(ranked.columns)
    assert [r["trial"] for r in rows] == ranked["trial"].tolist()
    # each cell as pandas prints it (here the very text)
    n = min(top, 8) + 1
    assert [line.split() for line in got_lines[:n]] == [line.split() for line in want_lines[:n]]
    assert got_lines[:n] == want_lines[:n]
    for row, (_, want) in zip(rows, ranked.iterrows()):
        for c in columns:
            assert (row[c] is None and pd.isna(want[c])) or row[c] == want[c], (c, row[c], want[c])
    df = load_sweep(sweep)
    params = [c for c in columns if c.startswith("param:")]
    _, records = hp_opt_report.load_sweep(sweep)
    for c in params:
        np.testing.assert_array_equal(hp_opt_report.numeric([r[c] for r in records]), _numeric(df[c]))
    if case == "none":
        assert not os.path.exists(got_png) and not os.path.exists(want_png)
        assert len(got_lines) == len(want_lines) == n
        return
    assert (want_lines[-1], got_lines[-1]) == (f"wrote {want_png}", f"wrote {got_png}")
    cols = min(len(params), 4)
    size = (round(3.5 * cols * 120), round(3 * (-(-len(params) // cols) + 1) * 120))
    assert decode_png(got_png)[:2] == decode_png(want_png, pixels=False)[:2] == size


def test_hp_opt_parallel_coordinates_are_iltpus_formulas(tmp_path):
    """The last panel's numbers: each parameter min-max normalised over
    `_numeric`, and each trial's colour position by iltpu's formula."""
    from scripts.print_plot_hp_opt_results import _numeric, load_sweep

    sweep = str(tmp_path / "sweep.jsonl")
    sweep_records(sweep, "missing")
    df = load_sweep(sweep)
    _, records = hp_opt_report.load_sweep(sweep)
    params = [c for c in df.columns if c.startswith("param:")]
    score = df["min_score"].to_numpy()
    mat, where = hp_opt_report.parallel_coordinates({c: [r[c] for r in records] for c in params}, score)
    want = []
    for c in params:
        v = _numeric(df[c])
        lo, hi = np.nanmin(v), np.nanmax(v)
        want.append((v - lo) / (hi - lo) if hi > lo else np.zeros_like(v))
    np.testing.assert_array_equal(mat, np.stack(want, axis=1))
    np.testing.assert_array_equal(where, (score - score.min()) / (score.max() - score.min()))


# --------------------------------------------------------------- harness


class StubTrainer:
    """What both harnesses train through: a fixed score and fixed eval
    curves (one evaluation empty, as a run's may be), the config kept."""

    configs = []

    def __init__(self, cfg, out_dir):
        self.cfg, self.out_dir = cfg, out_dir
        StubTrainer.configs.append(cfg)
        self.metrics = {"test_returns_normalized": [[0.25, 0.75], [], [0.5, 0.625, 1.0]]}

    def run(self):
        return 0.4375


def pointmass_npz(root):
    from iltpu_torch.data.synthetic import random_d4rl_dataset

    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    data = random_d4rl_dataset(np.random.default_rng(0), [50] * 6, 4, 2)
    np.savez(os.path.join(root, "data", "pointmass_expert.npz"), **data)


@pytest.fixture
def harnesses(tmp_path, monkeypatch):
    """Both harnesses' path globals at tmp_path (its data/ holding a
    pointmass .npz), both trainers the stub; iltpu's jax cache options put
    back after."""
    import jax

    import iltpu.trainer
    import iltpu_torch.trainer
    import iltpu_torch.validate_learning as torch_vl
    from scripts import validate_learning as jax_vl

    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    pointmass_npz(str(tmp_path))
    for module in (jax_vl, torch_vl):
        monkeypatch.setattr(module, "ROOT", str(tmp_path))
    monkeypatch.setattr(jax_vl, "RESULTS_JSONL", str(tmp_path / "RESULTS.jsonl"))
    monkeypatch.setattr(jax_vl, "RESULTS_MD", str(tmp_path / "RESULTS.md"))
    monkeypatch.setattr(torch_vl, "RESULTS_JSONL", str(tmp_path / "RESULTS_TORCH.jsonl"))
    monkeypatch.setattr(torch_vl, "RESULTS_MD", str(tmp_path / "RESULTS_TORCH.md"))
    monkeypatch.setattr(iltpu.trainer, "Trainer", StubTrainer)
    monkeypatch.setattr(iltpu_torch.trainer, "Trainer", StubTrainer)
    StubTrainer.configs = []
    yield jax_vl, torch_vl
    for k, v in saved.items():
        jax.config.update(k, v)


HARNESS_ARGS = [
    ["--algorithms", "GAIL,BC", "--envs", "pointmass,hopper", "--steps", "1000",
     "--trajectories", "4", "--num-envs", "4", "--eval-interval", "0"],
    ["--algorithms", "GAIL", "--envs", "pointmass", "--steps", "1000", "--trajectories", "4",
     "--tuned", "--extra", "reinforcement.min_alpha=0.05", "--seed", "3", "--data-fix"],
    ["--algorithms", "GAIL", "--envs", "pointmass", "--dataset-suffix", "_v2"],  # no such data
]


def test_harness_rows_match_iltpus(harnesses, tmp_path, capsys):
    """The same invocations through both harnesses: rows equal field by field
    but `out_dir`, `when` and the port's own `kernels` (the kernel flags the
    run resolved to), the skip messages equal (the results file's name
    aside), render_md's tables equal line by line below the title."""
    jax_vl, torch_vl = harnesses
    printed = {}
    for name, module in (("jax", jax_vl), ("torch", torch_vl)):
        lines = []
        for args in HARNESS_ARGS + HARNESS_ARGS[:2]:  # the second pass skips every cell
            extra = ["--platform", "cpu", "--env-backend", "jax"] if name == "torch" else []
            module.main(args + extra)
            lines += capsys.readouterr().out.splitlines()
        printed[name] = [line.replace("RESULTS_TORCH.jsonl", "RESULTS.jsonl") for line in lines
                         if line.startswith("skip")]
    assert printed["torch"] == printed["jax"]
    assert sum(line.endswith("(already in RESULTS.jsonl)") for line in printed["jax"]) == 3
    assert sum("no expert data at" in line for line in printed["jax"]) == 5
    want, got = jax_vl.load_results(), torch_vl.load_results()
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        assert g["out_dir"].startswith(os.path.join("outputs", "validation_torch", f"{g['algorithm']}_{g['env']}"))
        assert "kernels" not in w
        assert {k: v for k, v in g.items() if k not in ("out_dir", "when", "kernels")} == {
            k: v for k, v in w.items() if k not in ("out_dir", "when")}
        assert g["eval_curve"] == w["eval_curve"] and g["final_normalized_score"] == 0.4375
    # the tables, with the out_dir column (the stamps, the runs' directory) cut
    md = {}
    for name, path in (("jax", tmp_path / "RESULTS.md"), ("torch", tmp_path / "RESULTS_TORCH.md")):
        lines = path.read_text().splitlines()
        start = next(i for i, line in enumerate(lines) if line.startswith("| algorithm"))
        md[name] = [line.rsplit("|", 2)[0] if line.startswith("| ") and "outputs/" in line else line
                    for line in lines[start:]]
    assert md["torch"] == md["jax"]
    assert (tmp_path / "RESULTS_TORCH.md").read_text().startswith("# RESULTS_TORCH")
    # the port's own flags reach the config, outside the key; the kernels where the config takes them
    torch_cfgs = StubTrainer.configs[-3:]
    assert all(c.platform == "cpu" and c.env_backend == "jax" for c in torch_cfgs)
    assert [(c.algorithm, c.training.sac_pallas, c.training.disc_pallas, c.training.fused_update_scan)
            for c in torch_cfgs] == [("GAIL", True, True, True), ("BC", True, False, False),
                                     ("GAIL", True, True, True)]
    # each row keeps the flags its config resolved to
    assert [(g["algorithm"], *g["kernels"].values()) for g in got] == [
        (c.algorithm, c.training.sac_pallas, c.training.disc_pallas, c.training.fused_update_scan)
        for c in torch_cfgs]
    assert list(got[0]["kernels"]) == ["sac_pallas", "disc_pallas", "fused_update_scan"]
    assert torch_cfgs[2].reinforcement.min_alpha == 0.05 and torch_cfgs[2].expert_data.terminals_to_timeouts


def test_harness_extra_overrides_the_kernels(harnesses, tmp_path, capsys):
    """`--extra` comes after the kernel flags: a variant without them runs
    the autograd updates (and is a cell of its own)."""
    _, torch_vl = harnesses
    torch_vl.main(["--algorithms", "GAIL", "--envs", "pointmass", "--platform", "cpu",
                   "--env-backend", "jax", "--extra",
                   "training.fused_update_scan=false,training.disc_pallas=false"])
    cfg = StubTrainer.configs[-1]
    assert (cfg.training.sac_pallas, cfg.training.disc_pallas, cfg.training.fused_update_scan) == (
        True, False, False)
    (row,) = torch_vl.load_results()
    assert row["extra"] == "training.fused_update_scan=false,training.disc_pallas=false"
    assert row["kernels"] == {"sac_pallas": True, "disc_pallas": False, "fused_update_scan": False}
    assert ("kernels: training.sac_pallas=True, training.disc_pallas=False, "
            "training.fused_update_scan=False") in capsys.readouterr().out.splitlines()


# ------------------------------------------------------- imports, end to end


def test_reports_and_harness_import_neither_jax_pandas_nor_matplotlib(tmp_path):
    """In a process of its own: both reports on small inputs and the
    harness's stub path, then no module of jax, jaxlib, iltpu, pandas,
    matplotlib, PIL or yaml is loaded."""
    root = tmp_path / "outputs"
    runs_tree(str(root))
    results_rows(tmp_path / "RESULTS.jsonl")
    sweep_records(tmp_path / "sweep.jsonl", "missing")
    pointmass_npz(str(tmp_path))
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from iltpu_torch.analysis import hp_opt_report, seed_sweep_report
import iltpu_torch.trainer
import iltpu_torch.validate_learning as vl
seed_sweep_report.main(["--root", {str(root)!r}, "--algorithms", "BC", "--envs", "hopper",
                        "--reps", "200", "--out", {str(tmp_path / "a.png")!r}])
seed_sweep_report.main(["--from-results", {str(tmp_path / "RESULTS.jsonl")!r}, "--algorithms", "GAIL",
                        "--envs", "hopper", "--tuned", "best", "--reps", "200",
                        "--out", {str(tmp_path / "b.png")!r}])
hp_opt_report.main([{str(tmp_path / "sweep.jsonl")!r}, "--out", {str(tmp_path / "c.png")!r}])

class Stub:
    def __init__(self, cfg, out_dir):
        self.metrics = {{"test_returns_normalized": [[0.5]]}}
    def run(self):
        return 0.5

iltpu_torch.trainer.Trainer = Stub
vl.ROOT = {str(tmp_path)!r}
vl.RESULTS_JSONL, vl.RESULTS_MD = vl.ROOT + "/R.jsonl", vl.ROOT + "/R.md"
vl.main(["--envs", "pointmass", "--platform", "cpu", "--env-backend", "jax"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "iltpu", "pandas", "matplotlib", "PIL", "yaml"))
assert not bad, bad
print("clean")
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(tmp_path),
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().endswith("clean")
    for png in "abc":
        assert decode_png(tmp_path / f"{png}.png")[0] > 0


def test_harness_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    """One real run of the port's harness (GAIL on pointmass, the array env,
    300 steps, an evaluation every 100), then the seed-sweep report on the
    row it wrote, its numbers recomputed from the row."""
    import torch

    import iltpu_torch.validate_learning as vl

    torch.set_num_threads(1)
    pointmass_npz(str(tmp_path))
    monkeypatch.setattr(vl, "ROOT", str(tmp_path))
    monkeypatch.setattr(vl, "RESULTS_JSONL", str(tmp_path / "RESULTS_TORCH.jsonl"))
    monkeypatch.setattr(vl, "RESULTS_MD", str(tmp_path / "RESULTS_TORCH.md"))
    extra = "training.start=64,training.batch_size=16,memory.size=1000"
    vl.main(["--algorithms", "GAIL", "--envs", "pointmass", "--steps", "300", "--trajectories", "4",
             "--num-envs", "4", "--eval-interval", "100", "--eval-episodes", "2", "--platform", "cpu",
             "--env-backend", "jax", "--extra", extra])
    (row,) = vl.load_results()
    assert len(row["eval_curve"]) == 3 and np.isfinite(row["eval_curve"]).all()
    assert row["last_normalized_score"] == row["eval_curve"][-1]
    assert row["best_normalized_score"] == max(row["eval_curve"])
    run = tmp_path / row["out_dir"]
    assert (run / "metrics.pkl").is_file() and (run / "test_returns.png").is_file()
    capsys.readouterr()
    results = seed_sweep_report.main([
        "--from-results", vl.RESULTS_JSONL, "--algorithms", "GAIL", "--envs", "pointmass",
        "--trajectories", "4", "--num-envs-filter", "4", "--tuned", "no", "--extra", extra,
        "--reps", "200", "--out", str(tmp_path / "fig.png")])
    final = row["eval_curve"][-1]
    assert results["GAIL"] == {"iqm": final, "ci_lo": final, "ci_hi": final, "seeds": 1, "envs": 1,
                               "evals": 3}
    assert decode_png(tmp_path / "fig.png")[:2] == (960, 420)
