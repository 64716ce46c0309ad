"""Seed-sweep report, the port of the repo's
`scripts/print_plot_seed_sweep_results.py`: `python -m
iltpu_torch.analysis.seed_sweep_report`. numpy, scipy and the port only:
no JAX, no matplotlib.

For every algorithm it builds the (seeds, envs, evals) normalized-score
tensor, either from `<root>/<ALG>_<env>/*/metrics.pkl` (`collect_seed_sweep`)
or from the eval curves of a results file's rows (`--from-results`, iltpu's
`RESULTS.jsonl` or the port's `RESULTS_TORCH.jsonl`, aligned on the
intersection of their step grids), prints the final-eval IQM with its
stratified-bootstrap CI and each env's, and draws the sample-efficiency
figure through `iltpu_torch.utils.plotting` (the IQM curve and CI band of
each algorithm, one panel per env plus the all-env aggregate):
`figsize=(4 (n_envs + 1), 3.5)` at 120 dpi, as iltpu's. The lines, the
order, the `--json` dict and the returned `results` are iltpu's.

Usage:
  python -m iltpu_torch.analysis.seed_sweep_report \\
      --root outputs --algorithms GAIL PWIL --envs ant halfcheetah hopper walker2d \\
      [--reps 50000] [--out figures/sample_efficiency.png]
  python -m iltpu_torch.analysis.seed_sweep_report --from-results RESULTS_TORCH.jsonl \\
      --algorithms GAIL --envs hopper --tuned yes --dataset hopper_expert_v2 \\
      --extra reinforcement.min_alpha=0.05
"""

import argparse
import json

import numpy as np

from iltpu_torch.analysis.aggregate import collect_seed_sweep, iqm, stratified_bootstrap_ci
from iltpu_torch.utils.plotting import Figure

ENVS = ["ant", "halfcheetah", "hopper", "walker2d"]
DPI = 120


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="outputs")
    p.add_argument("--algorithms", nargs="+", required=True)
    p.add_argument("--envs", nargs="+", default=ENVS)
    p.add_argument("--reps", type=int, default=50_000)
    p.add_argument("--ci", type=float, default=0.95)
    p.add_argument("--out", default="sample_efficiency.png")
    p.add_argument("--json", action="store_true", help="print results as JSON")
    p.add_argument(
        "--from-results", default=None, metavar="RESULTS.jsonl",
        help="select runs from a results file's rows matching one configuration"
        " (iltpu's RESULTS.jsonl or the port's RESULTS_TORCH.jsonl)",
    )
    p.add_argument("--trajectories", type=int, default=10)
    p.add_argument(
        "--tuned", default=None, choices=["yes", "no", "best"],
        help="with --from-results: tuned rows, untuned rows, or per-(alg, env)"
        " the variant with more seeds (ties: the higher best score)",
    )
    p.add_argument("--num-envs-filter", type=int, default=256)
    p.add_argument(
        "--dataset", default=None,
        help="with --from-results: rows on this dataset. A leading underscore"
        " is a per-env suffix ('_v2' matches <env>_expert_v2 in each panel);"
        " otherwise the full dataset name. Default: the base dataset (empty"
        " field).",
    )
    p.add_argument(
        "--extra", default="",
        help="with --from-results: rows whose extra-override string equals this"
        " (default '': base-config rows only)",
    )
    return p


def rows_for(args, alg):
    """The results file's rows for `alg` at the filtered configuration,
    {env: [rows sorted by seed]}."""
    with open(args.from_results) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [
        r for r in rows
        if r["algorithm"] == alg
        and r["trajectories"] == args.trajectories
        and int(r.get("num_envs", 256)) == args.num_envs_filter
        and (r.get("extra") or "") == args.extra
    ]
    by_env = {}
    for env in args.envs:
        er = [r for r in rows if r["env"] == env]
        if args.dataset is None:
            er = [r for r in er if not r.get("dataset")]
        elif args.dataset.startswith("_"):  # a per-env suffix
            er = [r for r in er if (r.get("dataset") or "") == f"{env}_expert{args.dataset}"]
        else:
            er = [r for r in er if (r.get("dataset") or "") == args.dataset]
        if args.tuned in ("yes", "no"):
            er = [r for r in er if bool(r.get("tuned")) == (args.tuned == "yes")]
        elif args.tuned == "best":  # more seeds first, then the higher best score
            tuned_r = [r for r in er if r.get("tuned")]
            untuned_r = [r for r in er if not r.get("tuned")]
            er = max(
                (tuned_r, untuned_r),
                key=lambda rs: (len(rs), max((r["best_normalized_score"] for r in rs), default=-1)),
            )
        er.sort(key=lambda r: r["seed"])
        by_env[env] = er
    return by_env


def row_steps(r):
    """The env steps of a row's eval points."""
    iv = int(r.get("eval_interval") or max(r["steps"] // 10, 1))
    return [(i + 1) * iv for i in range(len(r["eval_curve"]))]


def tensor_from_rows(args, alg):
    """(steps, tensor(runs, envs, evals)) from the rows' eval curves, on the
    intersection of their step grids; runs cut to the fewest an env has."""
    by_env = rows_for(args, alg)
    grids = [set(row_steps(r)) for env in args.envs for r in by_env[env]]
    if not grids or not all(by_env[env] for env in args.envs):
        missing = [env for env in args.envs if not by_env[env]]
        raise FileNotFoundError(
            f"{alg}: no RESULTS rows for envs {missing} at"
            f" trajectories={args.trajectories}, tuned={args.tuned},"
            f" num_envs={args.num_envs_filter}"
        )
    common = sorted(set.intersection(*grids))
    assert common, f"{alg}: eval-step grids share no common points"
    per_env = []
    for env in args.envs:
        curves = []
        for r in by_env[env]:
            lookup = dict(zip(row_steps(r), r["eval_curve"]))
            curves.append([lookup[s] for s in common])
        per_env.append(np.asarray(curves))
    n_runs = min(c.shape[0] for c in per_env)
    return np.asarray(common), np.stack([c[:n_runs] for c in per_env], axis=1)


def aggregate_curve(tensor, reps, ci):
    """The aggregate panel's (evals, 3): each eval's IQM over (seeds, envs)
    and its CI, at min(reps, 2000) bootstrap reps."""
    band_reps = min(reps, 2_000)
    return np.array([stratified_bootstrap_ci(tensor[..., t], iqm, reps=band_reps, ci=ci)
                     for t in range(tensor.shape[-1])]).reshape(-1, 3)


def env_panel(tensor, e):
    """Env panel `e`'s numbers: the IQM curve over seeds (evals,) and its
    band (evals, 3), point and CI at 1,000 reps and the default 95%."""
    curve = iqm(tensor[:, e, :], axis=0)
    band = np.array([stratified_bootstrap_ci(tensor[:, e:e + 1, t], iqm, reps=1000)
                     for t in range(tensor.shape[-1])]).reshape(-1, 3)
    return curve, band


def main(argv=None):
    args = parser().parse_args(argv)
    results, curves = {}, {}
    for alg in args.algorithms:
        if args.from_results:
            steps, tensor = tensor_from_rows(args, alg)
        else:
            steps, tensor, _ = collect_seed_sweep(args.root, alg, args.envs)
        n_runs, n_envs, n_evals = tensor.shape
        # the headline: the final evaluation over (seeds, envs)
        point, lo, hi = stratified_bootstrap_ci(tensor[..., -1], iqm, reps=args.reps, ci=args.ci)
        results[alg] = {"iqm": point, "ci_lo": lo, "ci_hi": hi, "seeds": n_runs, "envs": n_envs,
                        "evals": n_evals}
        curves[alg] = (steps, aggregate_curve(tensor, args.reps, args.ci), tensor)

    for alg, r in results.items():
        print(
            f"{alg}: IQM normalized score {r['iqm']:.3f} "
            f"[{r['ci_lo']:.3f}, {r['ci_hi']:.3f}] "
            f"({r['seeds']} seeds x {r['envs']} envs)"
        )
        _, _, tensor = curves[alg]
        for e, env in enumerate(args.envs):
            pt, lo, hi = stratified_bootstrap_ci(tensor[:, e:e + 1, -1], iqm, reps=args.reps,
                                                 ci=args.ci)
            print(f"  {env}: final IQM {pt:.3f} [{lo:.3f}, {hi:.3f}]")
    if args.json:
        print(json.dumps(results))

    plot(args, curves)
    return results


def plot(args, curves):
    """One panel per env and the aggregate panel, at iltpu's size."""
    n_envs = len(args.envs)
    fig = Figure(4 * (n_envs + 1), 3.5, DPI)
    axes = fig.grid(1, n_envs + 1)[0]
    for alg, (steps, curve, tensor) in curves.items():
        axes[-1].plot(steps, curve[:, 0], label=alg)
        axes[-1].fill_between(steps, curve[:, 1], curve[:, 2], alpha=0.2)
        for e in range(n_envs):
            env_curve, band = env_panel(tensor, e)
            axes[e].plot(steps, env_curve, label=alg)
            axes[e].fill_between(steps, band[:, 1], band[:, 2], alpha=0.2)
    for e, env in enumerate(args.envs):
        axes[e].set_title(env)
        axes[e].set_xlabel("env steps")
    axes[-1].set_title("aggregate (all envs)")
    axes[0].set_ylabel("IQM normalized score")
    axes[-1].legend()
    fig.save(args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
