"""Multi-env runner and hyperparameter sweep, the port of the repo's
`train_all.py`: `python -m iltpu_torch.train_all algorithm=GAIL [...]`.

One *trial* trains one algorithm on every env of `ENVS` (iltpu's four MuJoCo
envs; `--envs a,b` picks others) with one shared random seed and returns the
minimum over the envs of the mean normalized score, the conservative
objective of a hyperparameter search. The envs run at once in a
`multiprocessing` pool started by the forkserver method, each worker a
process of its own with its own CUDA context on the one card, or one after
another with `--serial`. The parent never touches CUDA, and an exception in
a worker propagates through `pool.map`.

`--sweep N` runs an N-trial Bayesian optimisation (`iltpu_torch.sweep`: Sobol
trials, then GP-EI) over the algorithm's search space
(`iltpu_torch/config/conf/search_space.yaml`), stopping early after
`--early-stop` trials (default 5) without improvement; `--sobol K` sets the
Sobol trials. Each trial's record goes to `outputs/all_<ALG>/sweep.jsonl`
and its runs to `outputs/all_<ALG>/trial_XXX/<env>/`; the best trial is
printed last.

Usage:
  python -m iltpu_torch.train_all algorithm=GAIL imitation.trajectories=5 [--serial]
  python -m iltpu_torch.train_all algorithm=GAIL --sweep 30 [--serial] [--envs pointmass]
"""

import json
import multiprocessing as mp
import os
import sys

import numpy as np

from iltpu_torch.config import CONF_DIR, load_config
from iltpu_torch.config.yaml_subset import loads

ENVS = ["ant", "halfcheetah", "hopper", "walker2d"]


def _run_one(packed):
    env, overrides, out_dir = packed
    from iltpu_torch.trainer import train

    cfg = load_config(overrides + [f"env={env}"])
    env_dir = os.path.join(out_dir, env)
    os.makedirs(env_dir, exist_ok=True)
    return train(cfg, env_dir)


def run_trial(overrides, out_dir, serial=False, envs=None):
    """Train the envs with one shared seed; return min-over-envs score."""
    os.makedirs(out_dir, exist_ok=True)
    envs = envs or ENVS
    jobs = [(env, overrides, out_dir) for env in envs]
    if serial:
        scores = [_run_one(j) for j in jobs]
    else:
        ctx = mp.get_context("forkserver")
        with ctx.Pool(len(jobs)) as pool:
            scores = pool.map(_run_one, jobs)
    return float(min(scores)), dict(zip(envs, scores))


def _take(args, flag, cast):
    """The value after `flag` in `args` (both removed), or None."""
    if flag not in args:
        return None
    i = args.index(flag)
    value = cast(args[i + 1])
    del args[i : i + 2]
    return value


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    serial = "--serial" in args
    args = [a for a in args if a != "--serial"]
    sweep_n = _take(args, "--sweep", int) or 0
    envs = _take(args, "--envs", lambda s: s.split(","))
    early_stop = _take(args, "--early-stop", int)
    early_stop = 5 if early_stop is None else early_stop  # stop after 5 non-improving trials
    sobol = _take(args, "--sobol", int)

    alg = next((a.split("=", 1)[1] for a in args if a.startswith("algorithm=")), "SAC")
    out_root = os.path.join("outputs", f"all_{alg}")

    if not sweep_n:
        # one trial, one random seed shared by the envs
        seed = int(np.random.default_rng().integers(0, 2**31))
        score, per_env = run_trial([f"seed={seed}"] + args, out_root, serial, envs)
        print(json.dumps({"min_score": score, "per_env": per_env, "seed": seed}))
        return score

    from iltpu_torch.sweep import BayesOpt, space_from_config

    with open(os.path.join(CONF_DIR, "search_space.yaml")) as f:
        spaces = loads(f.read())
    if alg not in spaces:
        raise SystemExit(f"no search space for algorithm={alg}")
    opt = BayesOpt(
        space=space_from_config(spaces[alg]),
        total_trials=sweep_n,
        minimize=False,
        early_stop_epochs=early_stop,
        **({"sobol_trials": sobol} if sobol is not None else {}),
    )
    seed = int(np.random.default_rng().integers(0, 2**31))
    log_path = os.path.join(out_root, "sweep.jsonl")
    os.makedirs(out_root, exist_ok=True)
    while not opt.should_stop:
        trial = opt.ask()
        trial_overrides = ([f"seed={seed + trial.index}"] + args
                           + [f"{k}={v}" for k, v in trial.params.items()])
        trial_dir = os.path.join(out_root, f"trial_{trial.index:03d}")
        score, per_env = run_trial(trial_overrides, trial_dir, serial, envs)
        opt.tell(trial, score)
        rec = {"trial": trial.index, "method": trial.method, "params": trial.params,
               "min_score": score, "per_env": per_env}
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec))
    best = opt.best_trial()
    print(json.dumps({"best_trial": best.index, "params": best.params, "min_score": best.value}))
    return best.value


if __name__ == "__main__":
    main()
