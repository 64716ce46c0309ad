"""One rank of tests/test_torch_parallel.py: a jax-free process.

    python tests/torch_parallel_worker.py DIR RANK WORLD

joins a gloo group of WORLD ranks through `initialize_multihost`, with a
file store in DIR, runs the jobs of DIR/spec.json in order and writes each
job's results to DIR/<job>.rank<RANK>.npz (flat arrays). It ends by
checking that it imported neither JAX nor iltpu. The test module imports
the case definitions and the chains (`drive`) from here too, for its
one-process references.

A job's runs under `parallel.shard_params` (the tensor-parallel layout)
report the whole state (`whole_arrays`, the layout's leaves gathered) and,
separately, the state of record (`state_arrays`: this rank's blocks).
"""

import json
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from iltpu_torch.config import load_config  # noqa: E402
from iltpu_torch.data.replay import COLUMNS  # noqa: E402
from iltpu_torch.parallel import (  # noqa: E402
    allgather_blocks,
    allgather_rows,
    allreduce_mean_,
    initialize_multihost,
    make_mesh,
    process_allreduce_mean,
    shard_batch,
)
from iltpu_torch.trainer import Trainer  # noqa: E402

COMMON = [
    "env=pointmass", "env_backend=jax", "steps=300", "training.start=64", "num_envs=4",
    "evaluation.interval=1000", "evaluation.episodes=1", "logging.interval=0", "memory.size=1000",
    "imitation.trajectories=4", "training.batch_size=16", "reinforcement.actor.hidden_size=32",
    "reinforcement.critic.hidden_size=32", "platform=cpu",
]

# The port against itself: (overrides, all-reduces an update). Autograd SAC
# makes two (critic; actor + temperature), the autograd discriminator step
# one (nn-PUGAIL one more: its two means before the clamp), the BC
# auxiliary step one; the kernels none (they run replicated).
SELF_CASES = {
    "pugail": (["algorithm=GAIL", "imitation.loss_function=PUGAIL",
                "imitation.nonnegative_margin=0.0"], 4),
    "mixup05": (["algorithm=GAIL", "imitation.loss_function=Mixup", "imitation.mixup_alpha=0.5"], 3),
    "gmmil": (["algorithm=GMMIL"], 2),
    "dril_bc_aux": (["algorithm=DRIL", "imitation.pretraining.iterations=5"], 3),
    "red": (["algorithm=RED", "imitation.pretraining.iterations=5"], 2),
    "sqil": (["algorithm=SQIL"], 2),
    "gail_kernels": (["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true"], 0),
    "gail_autograd": (["algorithm=GAIL"], 3),
    "adril_sac_kernel": (["algorithm=AdRIL", "imitation.update_freq=6", "training.sac_pallas=true"], 0),
    "pwil": (["algorithm=PWIL"], 2),
    # update_block=4 without fused_update_scan (iltpu refuses the scan on a
    # mesh): the K-blocked branch of update_unit, driven directly (`drive`)
    "kblock4": (["algorithm=GAIL", "training.sac_pallas=true", "training.disc_pallas=true",
                 "training.update_block=4"], 0),
    # the on-device loop's chunks (run_chunk, eager on the CPU)
    "device_loop": (["algorithm=GAIL", "training.on_device_loop=true"], 3),
    # pendulum's states (3 + the absorbing bit) split over 2 and 4 ranks: the
    # rings' sampled states are gathered and their absorbing flag read whole
    "pendulum": (["algorithm=GAIL", "env=pendulum"], 3),
}

# The tensor-parallel layout against the same world's data parallel (bit for
# bit) and one process: the paths of both update branches and both loops.
SHARD_CASES = ("gail_kernels", "gail_autograd", "adril_sac_kernel", "dril_bc_aux", "red", "gmmil",
               "pwil", "kblock4", "device_loop", "pendulum")

# The slice against iltpu's mesh: GAIL on iltpu's default autograd path,
# AdRIL on the SAC kernel (its relabel carry), PWIL (the pools).
ILTPU_CASES = {
    "gail_autograd": ["algorithm=GAIL"],
    "adril_sac_kernel": ["algorithm=AdRIL", "imitation.update_freq=6", "training.sac_pallas=true"],
    "pwil": ["algorithm=PWIL"],
}

# __graft_entry__.dryrun_multichip(2)'s GAIL run: the on-device loop with an
# evaluation and a checkpoint at 64 steps, then a resume to 128.
DRYRUN = [
    "algorithm=GAIL", "env=pointmass", "env_backend=jax", "num_envs=2", "training.batch_size=16",
    "memory.size=512", "imitation.trajectories=2", "evaluation.episodes=1", "logging.interval=32",
    "reinforcement.actor.hidden_size=32", "reinforcement.actor.depth=1",
    "reinforcement.critic.hidden_size=32", "reinforcement.critic.depth=1",
    "imitation.discriminator.hidden_size=16", "training.on_device_loop=true",
    "training.start=16", "platform=cpu",
]
DRYRUN_FIRST = ["steps=96", "evaluation.interval=48", "checkpointing.interval=64"]
DRYRUN_RESUMED = ["steps=128", "evaluation.interval=64"]

ITERS, UPDATES = 3, 8


def dp(world):
    return ["parallel.data_axis=data", f"parallel.num_devices={world}"]


def sp(world):
    return dp(world) + ["parallel.shard_params=true"]


def step_data(it, n, S, A):
    """An iteration's env step, from a numpy seed."""
    rng = np.random.default_rng(100 + it)
    return {
        "obs": rng.normal(size=(n, S)).astype(np.float32),
        "actions": np.tanh(rng.normal(size=(n, A))).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, S)).astype(np.float32),
        "terminals": (rng.uniform(size=n) < 0.2).astype(np.float32),
        "timeouts": np.zeros(n, np.float32),
    }


def state_arrays(t):
    """The state of record (under the layout, this rank's blocks)."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in t.state_tensors().items()}


def whole_arrays(t):
    """Every state tensor whole: under the layout, its leaves gathered (a
    collective: every rank calls it)."""
    if t.layout is None:
        return state_arrays(t)
    with t._work(write=False):
        tensors = dict(t.state_tensors())
        tensors.update({n: leaf.whole for n, leaf in t.layout.leaves.items() if leaf.ring is None})
        return {k: v.detach().to("cpu", copy=True).numpy() for k, v in tensors.items()}


def layout_arrays(t):
    """The layout's leaves and their column blocks, and the expert ring's
    state of record."""
    leaves = t.layout.leaves
    return {"layout/names": np.asarray(sorted(leaves)),
            "layout/cols": np.asarray([[leaves[n].cols.start, leaves[n].cols.stop]
                                       for n in sorted(leaves)]),
            **{f"expert/{k}": getattr(t.expert, k).numpy().copy() for k in COLUMNS}}


def load_state(t, arrays):
    """Whole arrays into the state; under the layout, their blocks."""
    leaves = t.layout.leaves if t.layout is not None else {}
    for k, v in t.state_tensors().items():
        a = torch.from_numpy(arrays[k])
        v.copy_(a[..., leaves[k].cols] if k in leaves else a)


class Counted:
    """The collectives the trainer's work makes (not the reads of a test):
    `gathers` and `reduces` summed over the `with` blocks."""

    def __init__(self):
        self.gathers = self.reduces = 0

    def __enter__(self):
        self.g0, self.r0 = allgather_blocks.launches, allreduce_mean_.launches

    def __exit__(self, *exc):
        self.gathers += allgather_blocks.launches - self.g0
        self.reduces += allreduce_mean_.launches - self.r0

    def arrays(self):
        return {"collectives": np.asarray(self.reduces), "gathers": np.asarray(self.gathers)}


def run_core(t, datas=None, noises=None, counted=None):
    """ITERS iterations of UPDATES updates through `transition_core`, on
    `datas` (else `step_data`) with `noises` (else the trainer's own
    draws). Returns flat arrays: it<i>/state/<name> (whole),
    it<i>/aux/<key>."""
    out, counted = {}, counted or Counted()
    for it in range(ITERS):
        d = datas[it] if datas else step_data(it, t.cfg.num_envs, t.state_size, t.action_size)
        d = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
        noise = None if noises is None else {k: torch.from_numpy(v) for k, v in noises[it].items()}
        with counted:
            aux = t.transition_core(it * t.cfg.num_envs, d["obs"], d["actions"], d["rewards"],
                                    d["next_obs"], d["terminals"], d["timeouts"], UPDATES, noise=noise)
        out.update({f"it{it}/state/{k}": v for k, v in whole_arrays(t).items()})
        out.update({f"it{it}/aux/{k}": v.detach().cpu().numpy() for k, v in aux.items()})
    return out


def run_kblock(t, counted):
    """ITERS fronts of UPDATES updates, the updates as UPDATES / 4 units of
    4 through `update_unit` (its K-blocked branch)."""
    out = {}
    for it in range(ITERS):
        d = step_data(it, t.cfg.num_envs, t.state_size, t.action_size)
        d = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
        step = it * t.cfg.num_envs
        with counted:
            aux, *front = t.front(step, d["obs"], d["actions"], d["rewards"], d["next_obs"],
                                  d["terminals"], d["timeouts"], UPDATES)
            for c in range(0, UPDATES, 4):
                aux = t.update_unit(step, *({k: v[c:c + 4] for k, v in x.items()} for x in front))
        out.update({f"it{it}/state/{k}": v for k, v in whole_arrays(t).items()})
        out.update({f"it{it}/aux/{k}": v.detach().cpu().numpy() for k, v in aux.items()})
    return out


def run_chunks(t, counted):
    """The on-device loop's body on the CPU: a chunk of 4 iterations without
    updates from the trainer's env reset, then ITERS chunks of 2 iterations
    of UPDATES / 2 updates each; the chunk's rewards and dones are aux."""
    env_state, N, out = t._reset_env(), t.cfg.num_envs, {}
    with counted:
        t.run_chunk(env_state, 0, 4, 0)
    step = 4 * N
    for it in range(ITERS):
        with counted:
            rewards, dones, aux = t.run_chunk(env_state, step, 2, UPDATES // 2)
        step += 2 * N
        out.update({f"it{it}/state/{k}": v for k, v in whole_arrays(t).items()})
        aux = dict(aux, chunk_rewards=rewards, chunk_dones=dones)
        out.update({f"it{it}/aux/{k}": v.detach().cpu().numpy() for k, v in aux.items()})
    return out


def drive(t, name):
    """A SELF case's chain on trainer `t`, with its collectives counted."""
    counted = Counted()
    run = {"kblock4": run_kblock, "device_loop": run_chunks}.get(name)
    out = run(t, counted) if run else run_core(t, counted=counted)
    return {**out, **counted.arrays()}


def self_trainer(name, out_dir, extra=()):
    t = Trainer(load_config(COMMON + SELF_CASES[name][0] + list(extra)), out_dir=out_dir)
    if t.algorithm in ("DRIL", "RED"):
        t.pretrain_discriminator()  # replicated, from the same generator on every rank
    return t


def dryrun(root, rank, world=None):
    """The dryrun's two runs into root/rank<r>/{first,resumed} (resuming
    from rank 0's checkpoint); returns the resumed trainer."""
    extra = dp(world) if world else []
    base = os.path.join(root, f"rank{rank}")
    t = Trainer(load_config(DRYRUN + DRYRUN_FIRST + extra), out_dir=os.path.join(base, "first"))
    t.run()
    if world:
        dist.barrier()  # rank 0's checkpoint is written
    ckpt = os.path.join(root, "rank0", "first", "checkpoint")
    r = Trainer(load_config(DRYRUN + DRYRUN_RESUMED + extra + [f"checkpointing.resume={ckpt}"]),
                out_dir=os.path.join(base, "resumed"))
    r.run()
    return r


def grad_problem():
    """test_parallel's mean-loss gradient problem: (w, x, y)."""
    w = np.random.default_rng(0).normal(size=(4, 1)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    y = np.random.default_rng(2).normal(size=(64,)).astype(np.float32)
    return w, x, y


def mean_loss_grad(w, x, y, mesh=None):
    w = torch.from_numpy(w).requires_grad_()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    if mesh is not None:
        x, y = shard_batch(x, mesh), shard_batch(y, mesh)
    (g,) = torch.autograd.grad(torch.mean((x @ w)[:, 0] * y), [w])
    if mesh is not None:
        before = allreduce_mean_.launches
        allreduce_mean_([g], mesh)
        assert allreduce_mean_.launches == before + 1
    return g.numpy()


def job_primitives(mesh, job):
    batch = {"states": torch.zeros(16, 4), "rewards": torch.zeros(16), "scalar": torch.zeros(())}
    shards = shard_batch(batch, mesh)
    ts = [torch.full((3, 2), float(mesh.rank)), torch.full((5,), 2.0 * mesh.rank), torch.ones(())]
    before, all_reduce, issued = allreduce_mean_.launches, dist.all_reduce, []

    def counted(*args, **kw):  # the collectives torch.distributed is asked for
        issued.append(args[0].shape)
        return all_reduce(*args, **kw)

    dist.all_reduce = counted
    try:
        allreduce_mean_(ts, mesh)
    finally:
        dist.all_reduce = all_reduce
    rows = torch.arange(16.0).reshape(16, 1)
    return {
        **{f"shape/{k}": np.asarray(v.shape) for k, v in shards.items()},
        "collectives": np.asarray(allreduce_mean_.launches - before),
        "issued": np.asarray([list(s) for s in issued]),
        **{f"mean/{i}": t.numpy() for i, t in enumerate(ts)},
        "grad": mean_loss_grad(*grad_problem(), mesh),
        "gathered": allgather_rows(shard_batch(rows, mesh), mesh).numpy(),
    }


def job_multihost(mesh, job):
    """test_multihost's worker: each process owns 8 rows of a global (16, 4)
    batch, rank r's all r + 1; the mean-loss gradient is 1.5 a column."""
    w = torch.ones(4, 1, requires_grad=True)
    x = torch.full((8, 4), mesh.rank + 1.0)
    (g,) = torch.autograd.grad(torch.mean(x @ w), [w])
    allreduce_mean_([g], mesh)
    return {"grad": g.numpy(), "scalar_mean": process_allreduce_mean(mesh.rank + 1.0),
            "array_mean": process_allreduce_mean(np.full(3, 2.0 * mesh.rank))}


def job_iltpu(mesh, job):
    name = job["name"]
    with np.load(os.path.join(job["dir"], f"{name}.inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    layout = sp if job.get("shard") else dp
    t = Trainer(load_config(COMMON + ILTPU_CASES[name] + layout(mesh.world_size)),
                out_dir=os.path.join(job["dir"], f"{job['id']}.rank{mesh.rank}"))
    load_state(t, {k[len("state/"):]: v for k, v in inputs.items() if k.startswith("state/")})

    def part(it, what):
        pre = f"it{it}/{what}/"
        return {k[len(pre):]: v for k, v in inputs.items() if k.startswith(pre)}

    counted = Counted()
    out = run_core(t, [part(i, "data") for i in range(ITERS)],
                   [part(i, "noise") for i in range(ITERS)], counted)
    return {**out, **counted.arrays(), **(layout_arrays(t) if t.layout else {})}


def job_self(mesh, job):
    t = self_trainer(job["name"], os.path.join(job["dir"], f"{job['name']}.rank{mesh.rank}"),
                     dp(mesh.world_size))
    return drive(t, job["name"])


def job_shard(mesh, job):
    """A SELF case under the tensor-parallel layout: the chain (whole
    state), then the state of record and the layout; a greedy forward of
    the sharded actor."""
    name = job["name"]
    t = self_trainer(name, os.path.join(job["dir"], f"shard_{name}.rank{mesh.rank}"),
                     sp(mesh.world_size))
    out = drive(t, name)
    record = {f"record/{k}": v for k, v in state_arrays(t).items()}
    obs = torch.from_numpy(np.random.default_rng(5).normal(size=(6, t.state_size)).astype(np.float32))
    with t._work("sac.a[", write=False):
        greedy = t.actor.greedy_action(obs).detach().numpy().copy()
    released = sum(x.whole.untyped_storage().nbytes() for x in t.layout.leaves.values()
                   if x.ring is None)  # the parameters' whole storage between works
    return {**out, **record, **layout_arrays(t), "greedy": greedy, "released": np.asarray(released)}


def job_shard_ckpt(mesh, job):
    """Checkpoints across layouts: GAIL autograd's chain under the layout,
    then its checkpoint (rank 0 writes); a trainer under the layout
    resumed from the one-process checkpoint `job["plain"]`."""
    world, base = mesh.world_size, os.path.join(job["dir"], f"ckpt.rank{mesh.rank}")
    t = self_trainer("gail_autograd", os.path.join(base, "written"), sp(world))
    run_core(t)
    t._checkpoint(ITERS * t.cfg.num_envs, ITERS * UPDATES)
    written = whole_arrays(t)
    dist.barrier()  # rank 0's checkpoint is on disk
    r = Trainer(load_config(COMMON + SELF_CASES["gail_autograd"][0] + sp(world)
                            + [f"checkpointing.resume={job['plain']}"]),
                out_dir=os.path.join(base, "resumed"))
    return {**{f"written/{k}": v for k, v in written.items()},
            **{f"resumed/{k}": v for k, v in whole_arrays(r).items()},
            **{f"resumed_record/{k}": v for k, v in state_arrays(r).items()},
            **layout_arrays(r)}


def job_dryrun(mesh, job):
    r = dryrun(os.path.join(job["dir"], "dryrun"), mesh.rank, mesh.world_size)
    with open(os.path.join(job["dir"], f"dryrun.metrics.rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(r.metrics, f)  # every rank's, to hold them equal
    return {**state_arrays(r), "start_step": np.asarray(r.start_step)}


def job_refusals(mesh, job):
    """batch_size=30 over the ranks: iltpu's AssertionError; GAIL under the
    tensor-parallel layout builds (its sharded leaves)."""
    try:
        Trainer(load_config(COMMON + ["algorithm=SAC", "training.batch_size=30"] + dp(mesh.world_size)),
                out_dir=os.path.join(job["dir"], "refused"))
        out = {"assertion": np.asarray("")}
    except AssertionError as e:
        out = {"assertion": np.asarray(str(e))}
    t = Trainer(load_config(COMMON + ["algorithm=GAIL"] + sp(mesh.world_size)),
                out_dir=os.path.join(job["dir"], "shard_builds"))
    return {**out, "shard_leaves": np.asarray(sorted(t.layout.leaves))}


def job_mesh_bound(mesh, job):
    """make_mesh under NCCL in a group larger than a host's cards (mocked:
    the group is gloo on the CPU, reported as NCCL, two cards a host, the
    local rank r mod 2): null devices takes every rank of every host; a
    local rank past the host's cards, and more devices than ranks, are
    refused."""
    from unittest import mock

    out = {}
    with mock.patch.object(torch.cuda, "device_count", return_value=2), \
            mock.patch.object(dist, "get_backend", return_value="nccl"):
        for local, num, key in ((mesh.rank % 2, None, "null"), (2, None, "past_cards"),
                                (mesh.rank % 2, 2 * mesh.world_size, "too_many")):
            with mock.patch.dict(os.environ, LOCAL_RANK=str(local)):
                try:
                    out[key] = np.asarray(make_mesh(num, "data", torch.device("cpu")).world_size)
                except (AssertionError, ValueError) as e:
                    out[key] = np.asarray(f"{type(e).__name__}: {e}")
    return out


JOBS = {"primitives": job_primitives, "mesh_bound": job_mesh_bound, "multihost": job_multihost,
        "iltpu": job_iltpu, "self": job_self, "shard": job_shard, "shard_ckpt": job_shard_ckpt,
        "dryrun": job_dryrun, "refusals": job_refusals}


def main():
    root, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    with open(os.path.join(root, "spec.json")) as f:
        jobs = json.load(f)
    info = initialize_multihost(f"file://{os.path.join(root, 'store')}", world, rank, backend="gloo")
    mesh = make_mesh(world, "data", torch.device("cpu"))
    np.savez(os.path.join(root, f"init.rank{rank}.npz"), **{k: np.asarray(v) for k, v in info.items()})
    for job in jobs:
        result = JOBS[job["kind"]](mesh, dict(job, dir=root))
        np.savez(os.path.join(root, f"{job['id']}.rank{rank}.npz"), **result)
    dist.destroy_process_group()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "iltpu"))
    assert not bad, bad
    print(f"rank {rank} done")


if __name__ == "__main__":
    main()
