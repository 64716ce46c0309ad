"""CLI entry point: `python -m iltpu_torch.train algorithm=GAIL env=pointmass
env_backend=jax [key=value ...]`, the port of the repo's `train.py`.

Dotted key=value overrides compose onto the base + per-algorithm config
(the same grammar as iltpu's) and `--tuned` layers the published optimised
hyperparameters. The run writes into
`<output_dir>/<ALG>_<ENV>/<m-d_H-M-S>/` with the resolved config as
`config.yaml`, and prints one JSON summary line. It runs on the GPU unless
`platform=cpu` is given.

`-m`/`--multirun` sweeps the Cartesian product of comma-separated override
values (Hydra's multirun, e.g. `python -m iltpu_torch.train -m seed=1,2,3
algorithm=GAIL`), running the jobs one after another on the one card under
`<output_dir>/multirun/<m-d_H-M-S>/<job_idx>/`, and writes their override
lists and scores to `multirun.yaml` there.
"""

import datetime
import itertools
import json
import os
import sys

from iltpu_torch.config import load_config
from iltpu_torch.config.yaml_subset import dumps


def expand_multirun(args):
    """Expand Hydra-style sweep overrides into per-job override lists.

    Each `key=a,b,c` (comma outside brackets) becomes a sweep axis; the
    result is the Cartesian product in CLI order (Hydra's job ordering).
    """
    axes = []
    for arg in args:
        key, sep, raw = arg.partition("=")
        if sep and "," in raw and not raw.lstrip().startswith(("[", "{")):
            axes.append([f"{key}={v}" for v in raw.split(",")])
        else:
            axes.append([arg])
    return [list(combo) for combo in itertools.product(*axes)]


def _stamp() -> str:
    return datetime.datetime.now().strftime("%m-%d_%H-%M-%S")


def run_one(args, use_tuned=False, out_dir=None) -> float:
    from iltpu_torch.trainer import train

    cfg = load_config(args, use_tuned=use_tuned)
    if out_dir is None:
        out_dir = os.path.join(cfg["output_dir"], f"{cfg['algorithm']}_{cfg['env']}", _stamp())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        f.write(dumps(dict(cfg)))
    score = train(cfg, out_dir)
    print(json.dumps({"algorithm": cfg["algorithm"], "env": cfg["env"],
                      "mean_normalized_score": score, "out_dir": out_dir}))
    return score


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    use_tuned = "--tuned" in args
    multirun = "-m" in args or "--multirun" in args
    args = [a for a in args if a not in ("--tuned", "-m", "--multirun")]
    if not multirun:
        return run_one(args, use_tuned)

    jobs = expand_multirun(args)
    root = os.path.join(load_config(jobs[0], use_tuned=use_tuned).get("output_dir", "outputs"),
                        "multirun", _stamp())
    scores = []
    for idx, job_args in enumerate(jobs):
        print(f"[multirun {idx + 1}/{len(jobs)}] {' '.join(job_args)}", file=sys.stderr)
        scores.append(run_one(job_args, use_tuned, out_dir=os.path.join(root, str(idx))))
    with open(os.path.join(root, "multirun.yaml"), "w") as f:
        f.write(dumps({"jobs": [" ".join(j) for j in jobs], "scores": scores}))
    return scores


if __name__ == "__main__":
    main()
