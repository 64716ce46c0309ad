"""Learning parity between two results files, as a test of their difference:
`python -m iltpu_torch.analysis.parity RESULTS_TORCH.jsonl RESULTS.jsonl
--algorithms GAIL --envs hopper --tuned yes --dataset hopper_expert_v2
--extra reinforcement.min_alpha=0.05 --at 100000 250000 500000 1000000`.

Each file's rows are those that `seed_sweep_report --from-results` selects
with the same filters (every flag of its own is taken here too). At each
`--at` step on both files' common eval grid (and at the last one), it
gives each file's IQM over (seeds, envs) with its stratified bootstrap CI,
and the difference, the first file's IQM less the second's, with the
percentile bootstrap CI of that difference: each replicate resamples both
files' seeds, each within each env, independently. A step past the grid is
reported as missing. One JSON line an (algorithm, step).

A difference CI that holds 0 says no difference was detectable at these
seeds, not that there is none.
"""

import json

import numpy as np

from iltpu_torch.analysis.aggregate import iqm, stratified_bootstrap_ci
from iltpu_torch.analysis.seed_sweep_report import parser, tensor_from_rows


def difference_ci(a, b, reps, ci=0.95, seed=0):
    """(IQM(a) - IQM(b), lo, hi) for a (runs, envs) and b (runs', envs):
    the percentile CI over `reps` replicates, each resampling a's runs and
    then b's within each env (stratified_bootstrap_ci's scheme, over two
    independent samples)."""
    a, b = (np.asarray(x, np.float64).reshape(len(x), -1) for x in (a, b))
    rng = np.random.default_rng(seed)
    stats = []
    for x in (a, b):
        idx = rng.integers(0, x.shape[0], size=(reps, *x.shape))
        stats.append(iqm(np.take_along_axis(x[None], idx, axis=1).reshape(reps, -1), axis=1))
    alpha = (1.0 - ci) / 2.0
    lo, hi = np.percentile(stats[0] - stats[1], [100 * alpha, 100 * (1 - alpha)])
    return float(iqm(a) - iqm(b)), float(lo), float(hi)


def main(argv=None):
    p = parser()
    p.add_argument("first", help="results file (RESULTS.jsonl rows): the difference's minuend")
    p.add_argument("second", help="results file: the difference's subtrahend")
    p.add_argument("--at", nargs="+", type=int, default=[250_000, 500_000, 1_000_000])
    args = p.parse_args(argv)
    out = {}
    for alg in args.algorithms:
        grids = []
        for path in (args.first, args.second):
            args.from_results = path
            grids.append(tensor_from_rows(args, alg))
        (steps_a, a), (steps_b, b) = grids
        common = sorted(set(steps_a.tolist()) & set(steps_b.tolist()))
        at = {}
        for s in dict.fromkeys([*args.at, *common[-1:]]):
            if s not in common:
                at[s] = None
                continue
            ia, ib = list(steps_a).index(s), list(steps_b).index(s)
            at[s] = {
                **{key: dict(zip(("iqm", "ci_lo", "ci_hi"), stratified_bootstrap_ci(
                    x, iqm, reps=args.reps, ci=args.ci))) for key, x in (
                        ("first", a[..., ia]), ("second", b[..., ib]))},
                "difference": dict(zip(("iqm", "ci_lo", "ci_hi"), difference_ci(
                    a[..., ia], b[..., ib], args.reps, args.ci))),
            }
            print(json.dumps({"algorithm": alg, "step": s, **at[s]}))
        out[alg] = {"seeds": (a.shape[0], b.shape[0]), "envs": a.shape[1],
                    "last_step": common[-1] if common else None, "at": at}
    return out


if __name__ == "__main__":
    main()
