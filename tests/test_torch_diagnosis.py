"""The port's run diagnostics (`iltpu_torch.analysis.adril_diagnosis` and
`.decay_diagnosis`, no matplotlib) against iltpu's `scripts/adril_diagnosis.py`
and `scripts/decay_diagnosis.py`, on the CPU: the same printed lines on the
`metrics.pkl` of tiny port runs (AdRIL and GAIL on pointmass), which shows
that iltpu's scripts read the port's files unchanged, and on a hand-made
`metrics.pkl` with `diag_*` series; the four-panel figure's series, titles,
log scale and legend equal to what the script hands matplotlib, at 2160 x
432 px."""

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from iltpu_torch.analysis import adril_diagnosis, decay_diagnosis
from iltpu_torch.config import load_config
from iltpu_torch.trainer import Trainer
from scripts import adril_diagnosis as adril_script
from scripts import decay_diagnosis as decay_script
from test_torch_plotting import decode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["env=pointmass", "env_backend=jax", "platform=cpu", "steps=480", "training.start=64", "num_envs=4",
       "training.batch_size=16", "logging.interval=40", "evaluation.interval=160",
       "evaluation.episodes=2", "memory.size=1000", "reinforcement.actor.hidden_size=32",
       "reinforcement.critic.hidden_size=32", "imitation.trajectories=4"]


def hand_made(path):
    """A metrics.pkl in iltpu's layout with every key the diagnostics read:
    train returns over 0-1M steps, 12 evaluations, the update logs and
    three diag_* series."""
    rng = np.random.default_rng(5)
    steps = np.arange(0, 1_000_001, 20_000).tolist()
    m = {"train_steps": steps, "train_returns": [[float(v)] for v in rng.normal(3000, 400, len(steps))],
         "test_steps": list(range(100_000, 1_200_001, 100_000)),
         "test_returns": [list(rng.normal(3000, 300, 30)) for _ in range(12)],
         "test_returns_normalized": [list(rng.uniform(0.2, 1.1, 30)) for _ in range(12)],
         "update_steps": steps, "predicted_rewards": [list(rng.normal(0, 1, 8)) for _ in steps],
         "alphas": [float(v) for v in np.exp(-np.linspace(0, 6, len(steps)))],
         "entropies": [list(rng.normal(-3, 1, 8)) for _ in steps],
         "Q_values": [list(rng.normal(200, 20, 8)) for _ in steps],
         "diag_adril_stale_frac": list(rng.uniform(0, 0.5, len(steps))),
         "diag_num_trajectories": list(np.arange(len(steps)) * 3.0),
         "diag_relabel_reward_mean": list(rng.uniform(0, 0.1, len(steps)))}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(m, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """ROOT holding the tiny runs (outputs/<ALG>/metrics.pkl), the
    hand-made one (outputs/hand/) and a results file whose rows point at
    them: AdRIL at two num_envs and seeds, one row whose run is missing,
    GAIL, and the hand-made run as AdRIL on hopper."""
    root = tmp_path_factory.mktemp("diag")
    for alg in ("AdRIL", "GAIL"):
        extra = ["training.sac_pallas=true"] + (["training.disc_pallas=true"] if alg == "GAIL" else [])
        Trainer(load_config([f"algorithm={alg}", *RUN, *extra]), out_dir=str(root / "outputs" / alg)).run()
    hand_made(str(root / "outputs" / "hand" / "metrics.pkl"))
    rows = []
    for alg, env, seed, num_envs, out_dir, tuned in (
            ("AdRIL", "pointmass", 2, 4, "outputs/AdRIL", False), ("AdRIL", "pointmass", 1, 64, "outputs/AdRIL", True),
            ("AdRIL", "pointmass", 3, 4, "outputs/missing", False), ("GAIL", "pointmass", 1, 4, "outputs/GAIL", True),
            ("AdRIL", "hopper", 1, 256, "outputs/hand", False)):
        rows.append({"algorithm": alg, "env": env, "trajectories": 4, "seed": seed, "num_envs": num_envs,
                     "tuned": tuned, "final_normalized_score": 0.25 * seed, "best_normalized_score": 0.5,
                     "last_normalized_score": 0.125, "out_dir": out_dir})
    del rows[1]["num_envs"]  # iltpu's default, 256
    with open(root / "RESULTS_TORCH.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return root


def printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue().splitlines(), result


def script_figure(monkeypatch, argv):
    """iltpu's adril_diagnosis main on `argv`: (its printed lines, its figure)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kept, subplots = [], plt.subplots

    def keep(*a, **kw):
        fig, axes = subplots(*a, **kw)
        kept.append(fig)
        return fig, axes

    monkeypatch.setattr(plt, "subplots", keep)
    lines, _ = printed(adril_script.main, argv)
    monkeypatch.setattr(plt, "subplots", subplots)
    if kept:
        plt.close(kept[0])
    return lines, (kept[0] if kept else None)


@pytest.mark.parametrize("rows", ["AdRIL:pointmass:4", "GAIL:pointmass:4", "AdRIL:hopper:4", "SAC:hopper:4"])
def test_adril_diagnosis_prints_and_draws_the_scripts(runs, tmp_path, monkeypatch, rows):
    monkeypatch.setattr(adril_script, "ROOT", str(runs))
    monkeypatch.setattr(adril_diagnosis, "ROOT", str(runs))
    results = str(runs / "RESULTS_TORCH.jsonl")
    base = ["--rows", rows, "--results", results]
    want, fig = script_figure(monkeypatch, base + ["--out", str(tmp_path / "jax.png")])
    got, panels = printed(adril_diagnosis.main, base + ["--out", str(tmp_path / "port.png")])
    assert got[:-1] == want[:-1]
    if rows == "SAC:hopper:4":
        assert got == want == ["no matching rows"] and fig is None
        return
    assert (want[-1], got[-1]) == (f"wrote {tmp_path / 'jax.png'}", f"wrote {tmp_path / 'port.png'}")
    assert len(got) == 2 + {"AdRIL:pointmass:4": 3, "GAIL:pointmass:4": 1, "AdRIL:hopper:4": 1}[rows] + 1
    assert decode_png(tmp_path / "port.png")[:2] == decode_png(tmp_path / "jax.png", pixels=False)[:2] == (2160, 432)
    axes = fig.axes
    for ax, lines, title in zip(axes, adril_diagnosis.panel_series(panels), adril_diagnosis.TITLES):
        assert ax.get_title() == title and ax.get_xlabel() == "env steps"
        assert len(ax.lines) == len(lines)
        for line, (x, y, label) in zip(ax.lines, lines):
            assert line.get_label() == label
            assert np.array_equal(line.get_xdata(), np.asarray(x)) and np.array_equal(line.get_ydata(), np.asarray(y))
    assert [a.get_yscale() for a in axes] == ["linear", "linear", "log", "linear"]
    assert [t.get_text() for t in axes[0].get_legend().get_texts()] == [lab for *_, lab in
                                                                       adril_diagnosis.panel_series(panels)[0]]


def test_adril_diagnosis_without_out_prints_the_table_only(runs, monkeypatch):
    monkeypatch.setattr(adril_script, "ROOT", str(runs))
    monkeypatch.setattr(adril_diagnosis, "ROOT", str(runs))
    argv = ["--rows", "AdRIL:pointmass:4", "--results", str(runs / "RESULTS_TORCH.jsonl")]
    want, _ = printed(adril_script.main, argv)
    got, _ = printed(adril_diagnosis.main, argv)
    assert got == want and len(got) == 5
    assert got[2].split()[:3] == ["4", "2", "F"] and got[-1].split()[:2] == ["256", "1"]  # sorted by (num_envs, seed)
    assert "nan" in got[3]  # the missing run's columns


@pytest.mark.parametrize("run", ["AdRIL", "GAIL", "hand"])
def test_decay_diagnosis_prints_the_scripts(runs, run):
    path = str(runs / "outputs" / run / "metrics.pkl")
    want, _ = printed(decay_script.analyze, path)
    got, m = printed(decay_diagnosis.analyze, path)
    assert got == want
    assert got[0] == f"== {path}"
    assert any(line.startswith("  alphas: first=") for line in got)
    assert any(line.startswith("  diag_") for line in got) == (run != "GAIL")
    if run == "hand":
        assert sum(line.startswith("  train returns ") for line in got) == 2
        assert sum(" ± " in line for line in got) == 10  # the last 10 of 12 evaluations


def test_diagnostics_never_import_matplotlib(runs, tmp_path):
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from iltpu_torch.analysis import adril_diagnosis, decay_diagnosis
adril_diagnosis.ROOT = {str(runs)!r}
adril_diagnosis.main(["--rows", "AdRIL:pointmass:4", "--results", {str(runs / "RESULTS_TORCH.jsonl")!r},
                      "--out", {str(tmp_path / "a.png")!r}])
decay_diagnosis.main([{str(runs / "outputs" / "hand" / "metrics.pkl")!r}])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "iltpu", "matplotlib", "PIL",
                                                            "scripts"))
assert not bad, bad
print("clean")
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().endswith("clean")
    assert decode_png(tmp_path / "a.png")[:2] == (2160, 432)
