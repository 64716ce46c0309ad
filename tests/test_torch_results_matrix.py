"""The port's results matrix (`iltpu_torch.analysis.results_matrix`, no
matplotlib) against iltpu's `scripts/plot_results_matrix.py`, on the CPU:
the same picks, curves, variants and labels on `RESULTS.jsonl`,
`RESULTS_TORCH.jsonl` and synthetic rows that reach each branch; and each
panel's drawn numbers (lines, styles, notes, titles, labels, limits), the
legend and the suptitle equal to what the script hands matplotlib (its
`main` run here with `plt.subplots` wrapped to keep the figure), at the
same figure sizes."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from iltpu_torch.analysis import results_matrix as port
from iltpu_torch.utils.plotting import rgb
from scripts import plot_results_matrix as script
from test_torch_plotting import decode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS, RESULTS_TORCH = (os.path.join(REPO, f) for f in ("RESULTS.jsonl", "RESULTS_TORCH.jsonl"))


def synthetic_rows():
    """Rows that reach each branch of the variant policy: a cell with only
    the untuned variant of tuned-by-policy GAIL (the fallback pool, with a
    64-env and an `extra` row it leaves out), a one-eval BC curve, two eval
    grids in one cell (the modal one wins), `extra` rows the fixed config
    excludes, hopper's terminals->timeouts repair (rank 1) over the default
    data, `_v2` data (rank 0), another dataset (rank 3), a row without a
    curve, a cell with only such rows, and other trajectory counts."""
    rng = np.random.default_rng(11)
    rows = []

    def row(alg, env, seed, n=5, steps=1_000_000, tuned=False, traj=10, **kw):
        curve = [float(v) for v in rng.uniform(0, 1.2, n)]
        rows.append({"algorithm": alg, "env": env, "trajectories": traj, "seed": seed, "steps": steps,
                     "tuned": tuned, "num_envs": kw.pop("num_envs", 256), "data_fix": kw.pop("data_fix", False),
                     "dataset": kw.pop("dataset", ""), "extra": kw.pop("extra", ""),
                     "final_normalized_score": float(np.mean(curve)), "eval_curve": curve, **kw})

    for seed in (1, 2):
        row("GAIL", "hopper", seed)  # untuned only: the fallback, disclosed
    row("GAIL", "hopper", 3, num_envs=64)
    row("GAIL", "hopper", 4, extra="reinforcement.min_alpha=0.05")
    row("BC", "ant", 1, n=1)
    row("BC", "ant", 2, n=1, steps=0)
    for seed in (1, 2):
        row("PWIL", "walker2d", seed)
    row("PWIL", "walker2d", 3, n=3, steps=500_000)
    row("PWIL", "walker2d", 4, n=3, steps=500_000, tuned=True, num_envs=1)
    row("AdRIL", "hopper", 1, data_fix=True)
    row("AdRIL", "hopper", 2)
    row("AdRIL", "hopper", 3, extra="imitation.update_freq=0")
    row("SQIL", "halfcheetah", 1, dataset="halfcheetah_expert_v2")
    row("SQIL", "halfcheetah", 2)
    row("SQIL", "halfcheetah", 3, dataset="other")
    row("GMMIL", "ant", 1, dataset="other")
    row("GMMIL", "ant", 2, eval_curve=[])  # no curve: dropped
    row("DRIL", "walker2d", 1, eval_curve=[])  # a cell with no curve at all
    row("RED", "hopper", 1, traj=5)
    row("SAC", "walker2d", 1, traj=25, steps=300_000, n=4)
    return rows


def same_curves(got, want):
    assert sorted(got) == sorted(want)
    for key, (curve, steps, n, label) in want.items():
        g = got[key]
        assert np.array_equal(g[0], curve) and g[0].dtype == curve.dtype, key
        assert g[1:] == (steps, n, label), key


@pytest.mark.parametrize("source", ["RESULTS", "RESULTS_TORCH", "synthetic"])
@pytest.mark.parametrize("trajectories", [5, 10, 25])
@pytest.mark.parametrize("best_variant", [False, True])
def test_pick_curves_equal_the_scripts(source, trajectories, best_variant):
    rows = synthetic_rows() if source == "synthetic" else port.load_rows(
        {"RESULTS": RESULTS, "RESULTS_TORCH": RESULTS_TORCH}[source])
    want = script.pick_curves(rows, trajectories, best_variant=best_variant)
    same_curves(port.pick_curves(rows, trajectories, best_variant=best_variant), want)
    if source != "RESULTS_TORCH" and trajectories == 10:
        assert want  # every file's cells at 10 trajectories draw
    for r in rows:
        for env in port.ENVS:
            assert port._dataset_rank(env, r) == script._dataset_rank(env, r)
        for tuned in (False, True):
            assert port._variant_label(r, tuned, 3) == script._variant_label(r, tuned, 3)


def test_synthetic_rows_reach_each_branch():
    rows = synthetic_rows()
    fixed = script.pick_curves(rows, 10)
    assert fixed[("GAIL", "hopper")][2:] == (2, "untuned s=2")  # the fallback, disclosed
    assert fixed[("BC", "ant")][0].shape == (1,)
    assert fixed[("PWIL", "walker2d")][1:3] == (1_000_000, 2)  # the modal grid
    assert fixed[("AdRIL", "hopper")][2:] == (1, None)  # rank 1 (+fix) over rank 2, extra out
    assert fixed[("SQIL", "halfcheetah")][2:] == (1, None)  # rank 0 (_v2)
    assert ("DRIL", "walker2d") not in fixed
    assert script.pick_curves(rows, 25)[("SAC", "walker2d")][3] is None
    best = script.pick_curves(rows, 10, best_variant=True)
    assert all(label is not None for *_, label in best.values())
    assert {port._dataset_rank("hopper", r) for r in rows} == {0, 1, 2, 3}


def mpl_figure(monkeypatch, argv):
    """The script's main on `argv`: its figure, kept from `plt.subplots`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kept, subplots = [], plt.subplots

    def keep(*a, **kw):
        fig, axes = subplots(*a, **kw)
        kept.append(fig)
        return fig, axes

    monkeypatch.setattr(plt, "subplots", keep)
    script.main(argv)
    monkeypatch.undo()
    plt.close(kept[0])
    return kept[0]


def assert_drawn_as(spec, fig):
    """The port's figure spec against the script's matplotlib figure."""
    rows, cols = spec["grid"]
    assert tuple(fig.get_size_inches()) == pytest.approx(spec["size"], abs=1e-9)
    axes = fig.axes
    assert len(axes) == rows * cols == len(spec["panels"])
    for ax, (i, j, title, xlabel, ylabel, lines, notes) in zip(axes, spec["panels"]):
        *drawn, hline = ax.lines
        assert len(drawn) == len(lines)
        for line, (alg, x, y, color, ls) in zip(drawn, lines):
            assert np.array_equal(line.get_xdata(), x) and np.array_equal(line.get_ydata(), y), alg
            assert (line.get_color(), line.get_linestyle(), line.get_linewidth()) == (color, ls, spec["lw"])
        assert list(hline.get_ydata()) == [1.0, 1.0] and list(hline.get_xdata()) == [0, 1]
        assert (hline.get_color(), hline.get_linestyle()) == (port.MUTED, ":")
        texts = [(t.get_text(), t.get_position(), t.get_ha(), t.get_va()) for t in ax.texts]
        assert texts == ([] if notes is None else [(notes, (0.99, 0.02), "right", "bottom")])
        assert (ax.get_title(), ax.get_xlabel(), ax.get_ylabel()) == (title, xlabel, ylabel)
        assert ax.get_xlim() == (0, port.STEPS_TOTAL)
        shared = ax.get_shared_y_axes()
        assert shared.joined(ax, axes[0]) == (spec["sharey"] is True or i == 0)
        assert shared.joined(ax, axes[i * cols])
    (legend,) = fig.legends
    assert [t.get_text() for t in legend.get_texts()] == [lab for lab, _, _ in spec["legend"]]
    assert [(h.get_color(), h.get_linestyle()) for h in legend.legend_handles] == [
        (c, ls) for _, c, ls in spec["legend"]]
    assert legend._ncols == min(len(spec["legend"]), 9)


MODES = {"primary": [], "best_variant": ["--best-variant"], "traj_grid": ["--traj-grid"],
         "traj_grid_best": ["--traj-grid", "--best-variant"], "trajectories_5": ["--trajectories", "5"]}


@pytest.mark.parametrize("source", ["RESULTS", "RESULTS_TORCH", "synthetic"])
@pytest.mark.parametrize("mode", list(MODES))
def test_figure_draws_the_scripts_numbers(tmp_path, monkeypatch, source, mode):
    if source == "synthetic":
        path = str(tmp_path / "RESULTS_TORCH.jsonl")
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in synthetic_rows())
    else:
        path = {"RESULTS": RESULTS, "RESULTS_TORCH": RESULTS_TORCH}[source]
    argv = ["--results", path, *MODES[mode]]
    spec = port.figure_spec(port.parser().parse_args(argv))
    out = str(tmp_path / "port" / "m.png")
    assert port.main(argv + ["--out", out]) == out
    w, h, img = decode_png(out)
    size = (1800, 420 * spec["grid"][0]) if mode.startswith("traj_grid") else (1650, 1050)
    assert (w, h) == size
    if not spec["legend"]:  # no cell at this count: the script's legend of ncol=0 raises
        assert (source, mode) == ("RESULTS_TORCH", "trajectories_5")
        with pytest.raises(ValueError, match="number sections must be larger than 0"):
            mpl_figure(monkeypatch, argv + ["--out", str(tmp_path / "mpl" / "m.png")])
        return
    fig = mpl_figure(monkeypatch, argv + ["--out", str(tmp_path / "mpl" / "m.png")])
    assert_drawn_as(spec, fig)
    want = fig.get_suptitle()
    if source != "RESULTS":
        want = want.replace("iltpu ", "iltpu_torch (NVIDIA H100) ", 1)
    assert spec["suptitle"] == want
    assert decode_png(tmp_path / "mpl" / "m.png", pixels=False)[:2] == size
    for _, color, _ in spec["legend"]:  # each algorithm's colour is drawn
        assert (img[..., :3] == rgb(color)).all(-1).any(), color


def test_defaults_never_name_the_scripts_files():
    args = port.parser().parse_args([])
    assert args.results == RESULTS_TORCH
    assert args.out == os.path.join(REPO, "figures", "results_matrix_torch.png")
    assert args.out != os.path.join(REPO, "figures", "results_matrix.png")  # the script's


def test_module_never_imports_matplotlib(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from iltpu_torch.analysis import results_matrix
for mode in ([], ["--best-variant"], ["--traj-grid"]):
    results_matrix.main(["--results", {RESULTS!r}, "--out", {str(tmp_path / "a.png")!r}, *mode])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "iltpu", "matplotlib", "PIL",
                                                            "scripts"))
assert not bad, bad
print("clean")
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().endswith("clean")
