"""The results matrix, the port of the repo's `scripts/plot_results_matrix.py`:
`python -m iltpu_torch.analysis.results_matrix`. numpy and the port only: no
matplotlib.

Draws a results file's rows (the port's `RESULTS_TORCH.jsonl` by default;
iltpu's `RESULTS.jsonl` or any file of its row format with `--results`) as
the sample-efficiency figure: one panel per env, each algorithm's
normalized-score learning curve, under iltpu's pre-registered variant
policy (`CONFIG_POLICY` pins tuned/untuned per algorithm, `_dataset_rank`
the canonical data variant per env; `--best-variant` the per-cell best
variant, annotated). Seeds on one eval grid are averaged pointwise. The
main figure is 2 x 2 at `figsize=(11, 7)`, 150 dpi (1650 x 1050 px), one y
range; `--traj-grid` one row per env and one column per trajectory count
(5, 10, 25) at `figsize=(12, 2.8 n_envs)` (1800 x 420 n_envs px), y shared
along each row. The tables, the picks, the curves, the styles, the notes,
the titles and the legend are the script's (`figure_spec`); the pixels are
`iltpu_torch.utils.plotting`'s. The suptitle names the package that made
the rows: iltpu for `RESULTS.jsonl`, `iltpu_torch` on the H100 otherwise.

Usage:
  python -m iltpu_torch.analysis.results_matrix [--results RESULTS_TORCH.jsonl] \\
      [--out figures/results_matrix_torch.png] [--trajectories 10] [--best-variant] \\
      [--traj-grid]
"""

import argparse
import json
import os

import numpy as np

from iltpu_torch.utils.plotting import Figure

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Fixed categorical assignment (the colour follows the algorithm across
# panels). SQIL is AdRIL with update_freq=0: AdRIL's hue, dashed.
PALETTE = {
    "GAIL": "#2a78d6",
    "PWIL": "#eb6834",
    "AdRIL": "#1baf7a",
    "BC": "#eda100",
    "SAC": "#e87ba4",
    "GMMIL": "#008300",
    "DRIL": "#4a3aa7",
    "RED": "#e34948",
    "SQIL": "#1baf7a",
}
DASHED = {"SQIL"}
ENVS = ["ant", "halfcheetah", "hopper", "walker2d"]
ALG_ORDER = ["GAIL", "PWIL", "AdRIL", "SQIL", "BC", "SAC", "GMMIL", "DRIL", "RED"]
TRAJ_COUNTS = [5, 10, 25]
INK, MUTED, GRID = "#1a1a19", "#6b6a60", "#e8e6dc"
STEPS_TOTAL = 1_000_000
DPI = 150

# The pre-registered per-algorithm configuration of the primary figure
# (iltpu's rule): tuned where the reference publishes an optimised overlay
# and the data study documented no regression of it (GAIL), else untuned.
CONFIG_POLICY = {
    "GAIL": True, "PWIL": False, "AdRIL": False, "SQIL": False,
    "BC": False, "SAC": False, "GMMIL": False, "DRIL": False, "RED": False,
}


def load_rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _dataset_rank(env, row):
    """The canonical data variant per env, lower preferred: the
    timeout-ended `_v2` demos, then hopper's terminals->timeouts repair,
    then the default dataset, then anything else."""
    ds = row.get("dataset") or ""
    fix = bool(row.get("data_fix"))
    if ds.endswith("_expert_v2"):
        return 0
    if env == "hopper" and fix and not ds:
        return 1
    if not ds and not fix:
        return 2
    return 3


def pick_curves(rows, trajectories=10, best_variant=False):
    """(alg, env) -> (curve, steps, n_seeds, variant_label).

    Default: the pre-registered configuration (CONFIG_POLICY's tuned flag,
    the best dataset rank, num_envs 256, no `extra`), falling back to any
    256-env row without `extra` (else any row) where a cell has none, and
    then labelled. With best_variant: the variant with the highest mean
    run-avg score, always labelled. Only runs on the modal eval grid
    (steps, number of evals) are averaged."""
    cells = {}
    for r in rows:
        if r.get("trajectories", 10) != trajectories:
            continue
        cells.setdefault((r["algorithm"], r["env"]), []).append(r)
    out = {}
    for key, rs in cells.items():
        alg, env = key
        variants = {}
        for r in rs:
            vkey = (bool(r.get("tuned")), bool(r.get("data_fix")),
                    r.get("dataset") or "", int(r.get("num_envs", 256)),
                    int(r.get("steps", 0)), r.get("extra") or "")
            variants.setdefault(vkey, []).append(r)
        deviates = best_variant
        if best_variant:
            chosen = max(variants.values(),
                         key=lambda v: np.mean([x["final_normalized_score"] for x in v]))
        else:
            want_tuned = CONFIG_POLICY.get(alg, False)
            pool = [r for r in rs
                    if bool(r.get("tuned")) == want_tuned
                    and int(r.get("num_envs", 256)) == 256
                    and not r.get("extra")]
            if not pool:  # only a non-fixed-config variant: admitted, and disclosed
                deviates = True
                pool = [r for r in rs
                        if int(r.get("num_envs", 256)) == 256
                        and not r.get("extra")] or rs
            best_rank = min(_dataset_rank(env, r) for r in pool)
            chosen = [r for r in pool if _dataset_rank(env, r) == best_rank]
        tuned = [r for r in chosen if r.get("tuned")]
        chosen = [r for r in chosen if r.get("eval_curve")]
        if not chosen:
            continue
        grid = max(
            {(r["steps"], len(r["eval_curve"])) for r in chosen},
            key=lambda g: sum(1 for r in chosen if (r["steps"], len(r["eval_curve"])) == g),
        )
        picked = [r for r in chosen if (r["steps"], len(r["eval_curve"])) == grid]
        curves = [r["eval_curve"] for r in picked]
        out[key] = (
            np.mean(curves, axis=0),
            grid[0],
            len(curves),
            _variant_label(picked[0], bool(tuned), len(curves)) if deviates else None,
        )
    return out


def _variant_label(row, tuned, n_seeds):
    """A cell's disclosure: which variant, and how many seeds."""
    bits = ["tuned" if tuned else "untuned"]
    ds = row.get("dataset") or ""
    if ds.endswith("_expert_v2"):
        bits.append("v2")
    elif row.get("data_fix"):
        bits.append("+fix")
    if int(row.get("num_envs", 256)) != 256:
        bits.append(f"n{row.get('num_envs')}")
    if int(row.get("steps", 0)) not in (0, 1_000_000):
        bits.append(f"{row['steps'] // 1000}k")
    if row.get("extra"):
        bits.append(row["extra"].split("=")[0].split(".")[-1])
    return f"{'/'.join(bits)} s={n_seeds}"


def style(alg):
    return "--" if alg in DASHED else "-"


def panel_lines(curves, env):
    """One panel's curves and note: ([(alg, x, y, colour, style)] in
    ALG_ORDER, the notes' text or None). x is linspace(steps / n, steps, n)
    over a curve of n evals; a one-eval curve (BC's) is flat over [0, 1M]."""
    lines, notes = [], []
    for alg in ALG_ORDER:
        item = curves.get((alg, env))
        if item is None:
            continue
        curve, run_steps, _, label = item
        if label is not None:
            notes.append(f"{alg}: {label}")
        if len(curve) == 1:
            x, y = np.array([0, STEPS_TOTAL]), np.repeat(curve, 2)
        else:
            x, y = np.linspace(run_steps / len(curve), run_steps, len(curve)), curve
        lines.append((alg, x, y, PALETTE[alg], style(alg)))
    return lines, "\n".join(notes) or None


def title_prefix(results):
    return "iltpu" if os.path.basename(results) == "RESULTS.jsonl" else "iltpu_torch (NVIDIA H100)"


def figure_spec(args):
    """What the figure draws: its size in inches, grid, y sharing, layout
    rect and line width (points), each panel's (row, column, title, x
    label, y label, lines, notes), the legend's (label, colour, style)
    entries and the suptitle, as the script hands them to matplotlib."""
    rows = load_rows(args.results)
    variant = "(best-scoring variant per cell, see annotations)"
    fixed = "(fixed config: GAIL tuned, others untuned; canonical data variant per env"
    if not args.traj_grid:
        curves = pick_curves(rows, args.trajectories, best_variant=args.best_variant)
        panels = [(i // 2, i % 2, env, "environment steps" if i >= 2 else "",
                   "D4RL-normalized score" if i % 2 == 0 else "", *panel_lines(curves, env))
                  for i, env in enumerate(ENVS)]
        present = [a for a in ALG_ORDER if any((a, e) in curves for e in ENVS)]
        title = (f"{title_prefix(args.results)} learning validation — greedy-eval normalized score "
                 + (variant if args.best_variant else fixed + "; dotted = expert)"))
        return dict(size=(11, 7), grid=(2, 2), sharey=True, rect=(0, 0.06, 1, 0.97), lw=2,
                    panels=panels, legend=[(a, PALETTE[a], style(a)) for a in present],
                    suptitle=title)
    by_traj = {n: pick_curves(rows, n, best_variant=args.best_variant) for n in TRAJ_COUNTS}
    envs = [e for e in ENVS
            if any((a, e) in by_traj[n] for a in ALG_ORDER for n in TRAJ_COUNTS)]
    panels, present = [], set()
    for i, env in enumerate(envs):
        for j, n in enumerate(TRAJ_COUNTS):
            lines, notes = panel_lines(by_traj[n], env)
            present.update(alg for alg, *_ in lines)
            panels.append((i, j, f"{n} trajectories" if i == 0 else "",
                           "environment steps" if i == len(envs) - 1 else "",
                           env if j == 0 else "", lines, notes))
    title = (f"{title_prefix(args.results)} sample efficiency by expert-trajectory count "
             + (variant if args.best_variant else fixed + ")"))
    return dict(size=(4 * len(TRAJ_COUNTS), 2.8 * len(envs)), grid=(len(envs), len(TRAJ_COUNTS)),
                sharey="row", rect=(0, 0.05, 1, 0.96), lw=1.8, panels=panels,
                legend=[(a, PALETTE[a], style(a)) for a in ALG_ORDER if a in present],
                suptitle=title)


def px(points):
    """A width in points as whole pixels at DPI (at least 1)."""
    return max(1, round(points * DPI / 72))


def draw(spec, out):
    fig = Figure(*spec["size"], DPI)
    axes = fig.grid(*spec["grid"], sharey=spec["sharey"], rect=spec["rect"])
    for i, j, title, xlabel, ylabel, lines, notes in spec["panels"]:
        ax = axes[i][j]
        for _, x, y, color, ls in lines:
            ax.plot(x, y, color=color, lw=px(spec["lw"]), ls=ls)
        ax.set_title(title)
        if notes:
            ax.text(0.99, 0.02, notes, ha="right", va="bottom", color=MUTED)
        ax.axhline(1.0, MUTED, lw=px(0.8), ls=":")
        ax.grid(GRID)
        ax.set_xlim(0, STEPS_TOTAL)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
    fig.legend(spec["legend"], ncol=min(len(spec["legend"]), 9) or 1)
    fig.suptitle(spec["suptitle"])
    fig.save(out)


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--results", default=os.path.join(ROOT, "RESULTS_TORCH.jsonl"))
    p.add_argument("--out", default=os.path.join(ROOT, "figures", "results_matrix_torch.png"))
    p.add_argument("--trajectories", type=int, default=10)
    p.add_argument(
        "--traj-grid", action="store_true",
        help="one row per env, one column per expert-trajectory count (the"
        " reference's sample_efficiency_traj.png analogue)",
    )
    p.add_argument(
        "--best-variant", action="store_true",
        help="secondary view: per-cell best-scoring variant selection"
        " (annotated per cell) instead of the pre-registered fixed config",
    )
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    draw(figure_spec(args), args.out)
    print(args.out)
    return args.out


if __name__ == "__main__":
    main()
