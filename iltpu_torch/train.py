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

`parallel.data_axis=data` trains data parallel, one rank a device
(`iltpu_torch.parallel`): `parallel.num_devices` ranks, by default one for
every visible card (one process on the CPU). Without a process group the
command starts the ranks itself, by the spawn method, after building the
kernels once; under torchrun (`WORLD_SIZE` set) each process joins
torchrun's group. NCCL on the card, gloo with `platform=cpu`. Rank 0 writes
the run directory and prints the JSON line.
"""

import datetime
import itertools
import json
import os
import shutil
import sys
import tempfile

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


def _run_dir(cfg) -> str:
    return os.path.join(cfg["output_dir"], f"{cfg['algorithm']}_{cfg['env']}", _stamp())


def _backend(cfg) -> str:
    return "gloo" if cfg.get("platform") == "cpu" else "nccl"


def _train(cfg, out_dir=None) -> float:
    """Train in this process (a rank, under a process group); rank 0
    writes `config.yaml` and prints the JSON line. The ranks share rank
    0's run directory."""
    import torch.distributed as dist

    from iltpu_torch.trainer import train

    group = dist.is_initialized()
    rank0 = not group or dist.get_rank() == 0
    if out_dir is None:
        out_dir = [_run_dir(cfg) if rank0 else None]
        if group:
            dist.broadcast_object_list(out_dir, src=0)
        out_dir = out_dir[0]
    if rank0:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "config.yaml"), "w") as f:
            f.write(dumps(dict(cfg)))
    score = train(cfg, out_dir)
    if rank0:
        print(json.dumps({"algorithm": cfg["algorithm"], "env": cfg["env"],
                          "mean_normalized_score": score, "out_dir": out_dir}))
    return score


def _rank_main(rank, world, init, args, use_tuned, out_dir, scores):
    """One spawned rank: join the group, train, hand rank 0's score back."""
    import torch.distributed as dist

    from iltpu_torch.parallel import initialize_multihost

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    cfg = load_config(args, use_tuned=use_tuned)
    initialize_multihost(init, world, rank, backend=_backend(cfg))
    try:
        score = _train(cfg, out_dir)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        scores.put(score)


def _spawn_ranks(cfg, args, use_tuned, out_dir=None) -> float:
    """Start `parallel.num_devices` ranks (every visible card by default;
    one on the CPU) by the spawn method, rendezvousing through a file
    store; an exception in a rank ends the others and raises here."""
    import torch
    import torch.multiprocessing as tmp

    cpu = cfg.get("platform") == "cpu"
    world = cfg["parallel"].get("num_devices") or (1 if cpu else torch.cuda.device_count())
    if world <= 1:  # the mesh makes a group of this one process (or raises without a card)
        return _train(cfg, out_dir)
    if not cpu:
        from iltpu_torch.ops import build

        build.build_all()  # once, before the ranks could race nvcc
    store = tempfile.mkdtemp(prefix="iltpu_torch_ranks_")
    scores = tmp.get_context("spawn").SimpleQueue()
    try:
        tmp.spawn(_rank_main, args=(world, f"file://{store}/store", args, use_tuned,
                                    out_dir or _run_dir(cfg), scores), nprocs=world, join=True)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return scores.get()


def run_one(args, use_tuned=False, out_dir=None) -> float:
    cfg = load_config(args, use_tuned=use_tuned)
    if cfg["parallel"].get("data_axis"):
        import torch.distributed as dist

        if not dist.is_initialized():
            if "WORLD_SIZE" not in os.environ:
                return _spawn_ranks(cfg, args, use_tuned, out_dir)
            from iltpu_torch.parallel import initialize_multihost

            initialize_multihost(backend=_backend(cfg))  # join torchrun's group
    return _train(cfg, out_dir)


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
