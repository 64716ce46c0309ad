"""CLI entry point: `python -m iltpu_torch.train algorithm=GAIL env=pointmass
env_backend=jax [key=value ...]`, the port of the repo's `train.py`.

Dotted key=value overrides compose onto the base + per-algorithm config
(the same grammar as iltpu's) and `--tuned` layers the published optimised
hyperparameters. The run writes into
`<output_dir>/<ALG>_<ENV>/<m-d_H-M-S>/` with the resolved config as
`config.json`, and prints one JSON summary line. It runs on the GPU unless
`platform=cpu` is given.
"""

import datetime
import json
import os
import sys

from iltpu_torch.config import load_config
from iltpu_torch.trainer import train


def run_one(args, use_tuned=False) -> float:
    cfg = load_config(args, use_tuned=use_tuned)
    stamp = datetime.datetime.now().strftime("%m-%d_%H-%M-%S")
    out_dir = os.path.join(cfg["output_dir"], f"{cfg['algorithm']}_{cfg['env']}", stamp)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dict(cfg), f, indent=1)
    score = train(cfg, out_dir)
    print(json.dumps({"algorithm": cfg["algorithm"], "env": cfg["env"],
                      "mean_normalized_score": score, "out_dir": out_dir}))
    return score


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    use_tuned = "--tuned" in args
    if "-m" in args or "--multirun" in args:
        raise NotImplementedError("multirun sweeps are not ported yet: ROADMAP.md, 'Tooling'")
    return run_one([a for a in args if a != "--tuned"], use_tuned)


if __name__ == "__main__":
    main()
