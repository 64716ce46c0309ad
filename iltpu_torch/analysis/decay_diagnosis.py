"""Late-training decay forensics, the port of the repo's
`scripts/decay_diagnosis.py`: `python -m iltpu_torch.analysis.decay_diagnosis
RUN/metrics.pkl ...`. numpy only.

For each run's `metrics.pkl` it prints the training returns (the
stochastic acting policy) by phase, mean and p90 over the middle
(40-60%) and late (80-100%) steps, which tells a degrading policy from a
brittle greedy head; the last evaluations' mean, std, min and max over
their episodes (spread within an evaluation against between them); alpha,
entropy and Q at the first, middle and last log; and every `diag_*`
series' first and last values. The lines are the script's.
"""

import pickle
import sys

import numpy as np


def analyze(path, last_evals=10):
    with open(path, "rb") as f:
        m = pickle.load(f)
    print(f"== {path}")
    tr_steps = np.asarray(m["train_steps"])
    tr_ret = np.asarray([x[0] for x in m["train_returns"]])
    hi = tr_steps.max() if len(tr_steps) else 0
    for lo_f, hi_f, name in [(0.4, 0.6, "mid"), (0.8, 1.0, "late")]:
        sel = (tr_steps >= lo_f * hi) & (tr_steps < hi_f * hi + 1)
        if sel.any():
            print(f"  train returns {name}: mean={tr_ret[sel].mean():.0f}"
                  f" p90={np.percentile(tr_ret[sel], 90):.0f} n={int(sel.sum())}")
    tn = m.get("test_returns_normalized", [])
    if tn:
        print(f"  last {last_evals} evals (mean, std, min, max):")
        for e in tn[-last_evals:]:
            e = np.asarray(e)
            print(f"    {e.mean():.2f} ± {e.std():.2f}  [{e.min():.2f}, {e.max():.2f}]")
    for key, red in (("alphas", float), ("entropies", np.mean), ("Q_values", np.mean)):
        v = m.get(key, [])
        if v:
            s = [float(red(x)) for x in v]
            print(f"  {key}: first={s[0]:.4g} mid={s[len(s) // 2]:.4g} last={s[-1]:.4g}")
    for k, v in m.items():
        if k.startswith("diag_"):
            print(f"  {k}: first={v[0]:.4g} last={v[-1]:.4g} n={len(v)}")
    return m


def main(argv=None):
    for p in sys.argv[1:] if argv is None else argv:
        analyze(p)


if __name__ == "__main__":
    main()
