"""AdRIL/SQIL diagnostics across num_envs, the port of the repo's
`scripts/adril_diagnosis.py`: `python -m iltpu_torch.analysis.adril_diagnosis`.
numpy and the port only: no matplotlib.

Reads the `metrics.pkl` of a results file's runs of one (algorithm, env,
trajectories) cell (`--rows ALG:env:traj`; `--results` the port's
`RESULTS_TORCH.jsonl` by default, or iltpu's `RESULTS.jsonl`; each row's
`out_dir` resolved against `ROOT`) and prints, by num_envs and seed, the
run-average, best and last normalized scores with the live trajectory
count, the policy batch's stale fraction, alpha and the mean Q at the end
(the trainer's `diag_*` series where it records them). With `--out`, the
four-panel figure: the eval curve, the mean Q, alpha (log scale) and the
stale fraction against env steps, `figsize=(18, 3.6)` at 120 dpi (2160 x
432 px). The lines, their order and the figure's series are the script's.

Usage:
  python -m iltpu_torch.analysis.adril_diagnosis --rows AdRIL:hopper:10 \\
      [--results RESULTS_TORCH.jsonl] [--out adril_diagnosis.png]
"""

import argparse
import json
import os
import pickle

import numpy as np

from iltpu_torch.utils.plotting import Figure

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TITLES = ["eval normalized score", "mean Q", "alpha", "policy-batch stale frac"]
DPI = 120


def load_runs(results_path, algorithm, env, trajectories):
    """[(row, its metrics or None)] of the cell's rows, in file order."""
    with open(results_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [r for r in rows
            if r["algorithm"] == algorithm and r["env"] == env and r["trajectories"] == trajectories]
    runs = []
    for r in rows:
        p = os.path.join(ROOT, r["out_dir"], "metrics.pkl")
        m = None
        if os.path.isfile(p):
            with open(p, "rb") as f:
                m = pickle.load(f)
        runs.append((r, m))
    return runs


def panel_series(panels):
    """The figure's four panels' lines [(x, y, label)]: the eval curve's
    per-eval means against test steps; the mean Q, alpha and (where
    recorded) the stale fraction against update steps."""
    out = [[], [], [], []]
    for r, m in panels:
        label = f"n_env={r.get('num_envs', 256)} s{r['seed']}" + (" tuned" if r.get("tuned") else "")
        us = m["update_steps"]
        out[0].append((m["test_steps"], [float(np.mean(x)) for x in m["test_returns_normalized"]], label))
        out[1].append((us, [float(np.mean(x)) for x in m["Q_values"]], label))
        out[2].append((us, m["alphas"], label))
        if m.get("diag_adril_stale_frac"):
            out[3].append((us, m["diag_adril_stale_frac"], label))
    return out


def plot(panels, out):
    fig = Figure(18, 3.6, DPI)
    axes = fig.grid(1, 4)[0]
    for ax, lines, title in zip(axes, panel_series(panels), TITLES):
        for x, y, label in lines:
            ax.plot(x, y, label=label)
        ax.set_title(title)
        ax.set_xlabel("env steps")
    axes[2].set_yscale("log")
    axes[0].legend()
    fig.save(out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", default="AdRIL:hopper:10")
    p.add_argument("--results", default=os.path.join(ROOT, "RESULTS_TORCH.jsonl"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    alg, env, traj = args.rows.split(":")

    runs = load_runs(args.results, alg, env, int(traj))
    if not runs:
        print("no matching rows")
        return None

    print(f"=== {alg} {env} @{traj} trajectories — by num_envs ===")
    print(f"{'n_env':>6} {'seed':>4} {'tuned':>5} {'run-avg':>8} {'best':>6}"
          f" {'last':>6} {'n_traj@end':>10} {'stale@end':>9} {'alpha@end':>9}"
          f" {'Qmean@end':>9}")
    panels = []
    for r, m in sorted(runs, key=lambda x: (x[0].get("num_envs", 256), x[0]["seed"])):
        n_traj = stale = alpha = q = float("nan")
        if m is not None:
            if m.get("diag_num_trajectories"):
                n_traj = m["diag_num_trajectories"][-1]
            if m.get("diag_adril_stale_frac"):
                stale = m["diag_adril_stale_frac"][-1]
            if m.get("alphas"):
                alpha = float(m["alphas"][-1])
            if m.get("Q_values"):
                q = float(np.mean(m["Q_values"][-1]))
        print(f"{r.get('num_envs', 256):>6} {r['seed']:>4}"
              f" {str(bool(r.get('tuned')))[0]:>5}"
              f" {r['final_normalized_score']:>8.3f}"
              f" {r['best_normalized_score']:>6.3f}"
              f" {r.get('last_normalized_score', float('nan')):>6.3f}"
              f" {n_traj:>10.0f} {stale:>9.3f} {alpha:>9.4f} {q:>9.2f}")
        if m is not None:
            panels.append((r, m))

    if args.out and panels:
        plot(panels, args.out)
        print(f"wrote {args.out}")
    return panels


if __name__ == "__main__":
    main()
