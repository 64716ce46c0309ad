"""Learning-curve validation, the port of the repo's
`scripts/validate_learning.py`: `python -m iltpu_torch.validate_learning`.

Trains (algorithm, env) cells on the in-repo expert demonstrations
(`data/<env>_expert<suffix>.npz`) through `iltpu_torch.trainer.Trainer` and
records each run's final, last and best D4RL-normalised evaluation scores
with its whole eval curve, one row a (algorithm, env, seed, variant) cell,
under iltpu's cell key and row fields. The rows go to `RESULTS_TORCH.jsonl`
and their table to `RESULTS_TORCH.md` at the repo root; the runs to
`outputs/validation_torch/<ALG>_<env>/<m-d_H-M-S>/`. iltpu's `RESULTS.jsonl`
is never opened here: `python -m iltpu_torch.analysis.seed_sweep_report
--from-results` reads either file.

Resumable as iltpu's: a cell already in the file is skipped, and rows are
appended one line a run, so several processes (one seed each) may share the
file. Two flags of the port's own stay outside the cell key: `--platform
cpu|gpu` (default: the card) and `--env-backend` (default `auto`: the C++
stepper where it builds). The SAC and GAIL kernels run where the config
takes them (`training.sac_pallas`, `training.disc_pallas`,
`training.fused_update_scan`: perf modes held to the autograd updates, so
outside the key too); `--extra` overrides come after them and win. The
flags a run resolved to are printed and kept in its row as `kernels`
(outside the key, as `out_dir` is), so a row says whether its updates ran
on the kernels or on autograd.

Usage:
  python -m iltpu_torch.validate_learning --algorithms GAIL --envs hopper \\
      --steps 1000000 --trajectories 10 --tuned --dataset-suffix _v2 \\
      --extra reinforcement.min_alpha=0.05 --seed 1
"""

import argparse
import datetime
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS_JSONL = os.path.join(ROOT, "RESULTS_TORCH.jsonl")
RESULTS_MD = os.path.join(ROOT, "RESULTS_TORCH.md")
RUNS_DIR = os.path.join("outputs", "validation_torch")  # under ROOT

# The kernel flags tried in turn: the first the config takes is used.
KERNELS = (
    ["training.sac_pallas=true", "training.disc_pallas=true", "training.fused_update_scan=true"],
    ["training.sac_pallas=true"],
    [],
)
KERNEL_FLAGS = ("sac_pallas", "disc_pallas", "fused_update_scan")


def load_results():
    """Rows deduped by cell key, the LAST occurrence winning (the file is
    append-only: concurrent runs each append one line)."""
    rows = {}
    if os.path.isfile(RESULTS_JSONL):
        with open(RESULTS_JSONL) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    rows[cell_key(r)] = r
    return list(rows.values())


def cell_key(row):
    return (row["algorithm"], row["env"], row["trajectories"], row["seed"],
            bool(row.get("tuned", False)), int(row.get("num_envs", 256)),
            bool(row.get("data_fix", False)), int(row.get("steps", 0)),
            row.get("dataset") or "", row.get("extra") or "")


def render_md(rows):
    """`RESULTS_TORCH.md`: iltpu's table of the rows, under the port's title."""
    lines = [
        "# RESULTS_TORCH — learning validation (the PyTorch port, iltpu_torch, on an NVIDIA H100)",
        "",
        "Final and best greedy-eval D4RL-normalized scores per (algorithm, env)",
        "cell, trained on the in-repo expert demonstrations",
        "(`data/<env>_expert.npz`; see data/README.md), in the layout of",
        "iltpu's RESULTS.md. Produced by `python -m iltpu_torch.validate_learning`;",
        "raw rows in RESULTS_TORCH.jsonl.",
        "",
        "| algorithm | env | traj | seed | tuned | n_env | data | steps |"
        " run-avg score | end-of-training | best | out_dir |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=cell_key):
        data = r.get("dataset") or ""
        if r.get("data_fix"):
            data = (data + " +fix").strip()
        if r.get("extra"):
            data = (data + " " + r["extra"]).strip()
        lines.append(
            "| {algorithm} | {env} | {trajectories} | {seed} | {tuned} |"
            " {n_env} | {data} | {steps} |"
            " {final:.3f} | {last:.3f} | {best:.3f} | {out_dir} |".format(
                **{
                    **r,
                    "tuned": "yes" if r.get("tuned") else "no",
                    "n_env": r.get("num_envs", 256),
                    "data": data or "default",
                    "final": r["final_normalized_score"],
                    "last": r.get("last_normalized_score", r["final_normalized_score"]),
                    "best": r["best_normalized_score"],
                }
            )
        )
    lines.append("")
    lines.append(
        "run-avg = mean normalized score over every eval in the run (the"
        " reference's `train()` return / Ax objective, train.py:243);"
        " end-of-training = the last eval point (what the reference's"
        " figure shows at 1M steps). data `+fix` ="
        " expert_data.terminals_to_timeouts (label repair for"
        " terminal-ended generated demos; docs/ADRIL_ROOTCAUSE.md);"
        " `*_expert_v2` = surviving demos harvested from agent_best"
        " snapshots with stochastic reject sampling (all timeout-ended,"
        " normalized >=0.95 — distribution-matches D4RL expert-v2;"
        " data/README.md); extra `key=value` entries = --extra config"
        " overrides (e.g. the reinforcement.min_alpha temperature-floor"
        " mitigation, docs/DECAY_ROOTCAUSE.md)."
    )
    lines.append("")
    with open(RESULTS_MD, "w") as f:
        f.write("\n".join(lines))


def compose(overrides, extra, tuned):
    """The config of `overrides`, with the first of `KERNELS` that the
    trainer takes for it, then the `--extra` overrides."""
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import check_supported

    for kernels in KERNELS:
        cfg = load_config(overrides + kernels + extra, use_tuned=tuned)
        try:
            check_supported(cfg)
        except ValueError:
            continue
        return cfg
    return cfg  # the last try has no kernel flag: the trainer's own refusal stands


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--algorithms", default="GAIL")
    p.add_argument("--envs", default="hopper")
    p.add_argument("--steps", type=int, default=500_000)
    p.add_argument("--trajectories", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    # the reference's eval protocol: 30 greedy episodes every 10k env steps
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--eval-episodes", type=int, default=30)
    p.add_argument("--eval-interval", type=int, default=10000)
    p.add_argument("--tuned", action="store_true")
    p.add_argument(
        "--data-fix", action="store_true",
        help="expert_data.terminals_to_timeouts=true (distribution-match"
        " D4RL's timeout-ended expert demos); recorded in the cell key",
    )
    p.add_argument(
        "--dataset-suffix", default="",
        help="use data/<env>_expert<suffix>.npz (e.g. _v2); recorded in the cell key",
    )
    p.add_argument(
        "--extra", default="",
        help="comma-separated extra config overrides (e.g."
        " reinforcement.min_alpha=0.05); part of the cell key and recorded"
        " in the row, so variant runs coexist with the base cell",
    )
    p.add_argument("--rerun", action="store_true", help="redo existing cells")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="platform= override (default: the card); outside the cell key")
    p.add_argument("--env-backend", default="auto",
                   help="env_backend= override (default auto: the C++ stepper where it"
                   " builds); outside the cell key")
    args = p.parse_args(argv)

    from iltpu_torch.trainer import Trainer

    rows = load_results()
    done = {cell_key(r) for r in rows}
    eval_interval = args.eval_interval or max(args.steps // 10, 1)

    for alg in args.algorithms.split(","):
        for env in args.envs.split(","):
            key = (alg, env, args.trajectories, args.seed, bool(args.tuned),
                   args.num_envs, bool(args.data_fix), args.steps,
                   args.dataset_suffix and f"{env}_expert{args.dataset_suffix}",
                   args.extra)
            if key in done and not args.rerun:
                print(f"skip {key} (already in {os.path.basename(RESULTS_JSONL)})")
                continue
            data_path = os.path.join(ROOT, "data", f"{env}_expert{args.dataset_suffix}.npz")
            if not os.path.isfile(data_path):
                print(f"skip {key}: no expert data at {data_path}")
                continue
            overrides = [
                f"algorithm={alg}",
                f"env={env}",
                f"seed={args.seed}",
                f"steps={args.steps}",
                f"num_envs={args.num_envs}",
                f"imitation.trajectories={args.trajectories}",
                f"expert_data.source={data_path}",
                f"evaluation.interval={eval_interval}",
                f"evaluation.episodes={args.eval_episodes}",
                "logging.interval=10000",
                f"env_backend={args.env_backend}",
            ]
            if args.platform:
                overrides.append(f"platform={args.platform}")
            if args.data_fix:
                overrides.append("expert_data.terminals_to_timeouts=true")
            cfg = compose(overrides, args.extra.split(",") if args.extra else [], args.tuned)
            kernels = {k: bool(cfg.training.get(k)) for k in KERNEL_FLAGS}
            print("kernels: " + ", ".join(f"training.{k}={v}" for k, v in kernels.items()))
            stamp = datetime.datetime.now().strftime("%m-%d_%H-%M-%S")
            out_dir = os.path.join(ROOT, RUNS_DIR, f"{alg}_{env}", stamp)
            os.makedirs(out_dir, exist_ok=True)
            print(f"=== {alg} / {env} -> {out_dir}")
            t0 = time.time()
            trainer = Trainer(cfg, out_dir)
            final = float(trainer.run())
            wall = time.time() - t0
            norm_scores = [
                float(sum(s) / len(s))
                for s in trainer.metrics.get("test_returns_normalized", [])
                if len(s)
            ]
            row = {
                "algorithm": alg,
                "env": env,
                "trajectories": args.trajectories,
                "seed": args.seed,
                "steps": args.steps,
                "tuned": bool(args.tuned),
                "num_envs": args.num_envs,
                "eval_interval": eval_interval,
                "eval_episodes": args.eval_episodes,
                "data_fix": bool(args.data_fix),
                "dataset": (
                    f"{env}_expert{args.dataset_suffix}" if args.dataset_suffix else ""
                ),
                "extra": args.extra,
                "final_normalized_score": final,
                "last_normalized_score": norm_scores[-1] if norm_scores else final,
                "best_normalized_score": max(norm_scores) if norm_scores else final,
                "eval_curve": norm_scores,
                "kernels": kernels,
                "out_dir": os.path.relpath(out_dir, ROOT),
                "when": stamp,
            }
            rows = [r for r in rows if cell_key(r) != key] + [row]
            with open(RESULTS_JSONL, "a") as f:
                f.write(json.dumps(row) + "\n")
            render_md(rows)
            print(f"{alg} / {env} seed {args.seed}: {args.steps} env steps in {wall:.1f} s wall "
                  f"(Trainer built and run), {args.steps / wall:.1f} env-steps/s")
            print(json.dumps({k: row[k] for k in (
                "algorithm", "env", "final_normalized_score", "best_normalized_score")}))

    render_md(rows)


if __name__ == "__main__":
    main()
