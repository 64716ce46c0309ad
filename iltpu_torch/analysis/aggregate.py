"""Statistical aggregation of seed sweeps: the port's own copy of
`iltpu/analysis/aggregate.py` (numpy and scipy only). It reads the
`metrics.pkl` that the port's trainer writes under iltpu's keys.

The interquartile mean (`scipy.stats.trim_mean(x, 0.25)`) per seed over
evaluation episodes, and IQM point estimates with stratified bootstrap
confidence intervals over seeds (Agarwal et al., "Deep RL at the Edge of the
Statistical Precipice", NeurIPS 2021).
"""

import glob
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import trim_mean


def iqm(x: np.ndarray, axis: Optional[int] = None) -> np.ndarray:
    """Interquartile mean: the mean of the middle 50% of the data.

    Matches `scipy.stats.trim_mean(x, 0.25)` as used by the reference
    (`scripts/print_plot_seed_sweep_results.py:44`) and rliable's
    aggregate_iqm (which flattens its input).
    """
    if axis is None:
        x = np.asarray(x).reshape(-1)
        axis = 0
    return trim_mean(x, 0.25, axis=axis)


def stratified_bootstrap_ci(
    scores: np.ndarray,
    metric_fn: Callable[[np.ndarray], float] = iqm,
    reps: int = 50_000,
    ci: float = 0.95,
    seed: int = 0,
) -> Tuple[float, float, float]:
    """Point estimate and percentile bootstrap CI of `metric_fn(scores)`.

    `scores` has shape (runs, tasks): independent seeds down axis 0,
    stratification units (envs) across axis 1. Each bootstrap replicate
    resamples the runs *within each task independently* (stratified
    resampling — the rliable scheme the reference uses with 50k reps,
    `scripts/print_plot_seed_sweep_results.py:54`).

    Returns (point, lo, hi).
    """
    scores = np.asarray(scores, np.float64)
    if scores.ndim == 1:
        scores = scores[:, None]
    n_runs, n_tasks = scores.shape
    point = float(metric_fn(scores))
    rng = np.random.default_rng(seed)
    # Vectorised resampling: (reps, runs, tasks) index tensor, one independent
    # run-resample per task per replicate.
    idx = rng.integers(0, n_runs, size=(reps, n_runs, n_tasks))
    resampled = np.take_along_axis(scores[None], idx, axis=1)
    stats = np.array([metric_fn(r) for r in resampled])
    alpha = (1.0 - ci) / 2.0
    lo, hi = np.percentile(stats, [100 * alpha, 100 * (1 - alpha)])
    return point, float(lo), float(hi)


def load_metrics(run_dir: str, prefix: str = "") -> Dict:
    """Load a run's saved metrics dict (`<run_dir>/<prefix>metrics.pkl`)."""
    with open(os.path.join(run_dir, prefix + "metrics.pkl"), "rb") as f:
        return pickle.load(f)


def _run_normalized_curve(metrics: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Per-eval IQM over episodes of the normalized test returns.

    Mirrors the reference's per-seed reduction: trim_mean over the 30
    evaluation episodes at each eval step
    (`scripts/print_plot_seed_sweep_results.py:44`).
    """
    steps = np.asarray(metrics["test_steps"])
    returns = np.asarray(metrics["test_returns_normalized"], np.float64)
    return steps, trim_mean(returns, 0.25, axis=1)


def collect_seed_sweep(
    root: str,
    algorithm: str,
    envs: Sequence[str],
    prefix: str = "",
    run_dirs_by_env: Optional[Dict[str, List[str]]] = None,
) -> Tuple[np.ndarray, np.ndarray, List[List[str]]]:
    """Build the (runs, envs, evals) normalized-score tensor from saved runs.

    Scans `root/<ALG>_<env>/*/metrics.pkl` (the layout `train.py` writes,
    matching the reference's `outputs/<ALG>_<ENV>/<date>` tree read by
    `scripts/print_plot_seed_sweep_results.py:32-41`). Runs are aligned by
    sorted directory name; all runs of an env must share eval steps. Returns
    (steps, tensor, run_dirs).

    `run_dirs_by_env` selects explicit run directories per env (e.g. the
    out_dirs of RESULTS.jsonl rows for one configuration across seeds)
    instead of globbing — globbing a directory that holds several
    configurations (tuned/untuned, trajectory counts) would silently mix
    them into one "runs" axis.
    """
    per_env_curves: List[np.ndarray] = []
    per_env_dirs: List[List[str]] = []
    steps_ref: Optional[np.ndarray] = None
    for env in envs:
        pattern = os.path.join(root, f"{algorithm}_{env}", "*")
        if run_dirs_by_env is not None:
            run_dirs = list(run_dirs_by_env.get(env, []))
        else:
            run_dirs = sorted(
                d
                for d in glob.glob(pattern)
                if os.path.isfile(os.path.join(d, prefix + "metrics.pkl"))
            )
        if not run_dirs:
            raise FileNotFoundError(f"no runs found under {pattern}")
        curves = []
        for d in run_dirs:
            steps, curve = _run_normalized_curve(load_metrics(d, prefix))
            if steps_ref is None:
                steps_ref = steps
            n = min(len(curve), len(steps_ref))
            curves.append(curve[:n])
        n = min(len(c) for c in curves)
        per_env_curves.append(np.stack([c[:n] for c in curves]))
        per_env_dirs.append(run_dirs)
    n_runs = min(c.shape[0] for c in per_env_curves)
    n_evals = min(c.shape[1] for c in per_env_curves)
    tensor = np.stack(
        [c[:n_runs, :n_evals] for c in per_env_curves], axis=1
    )  # (runs, envs, evals)
    assert steps_ref is not None
    return steps_ref[:n_evals], tensor, per_env_dirs
