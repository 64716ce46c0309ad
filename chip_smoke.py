#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`iltpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, nvcc and nothing
of JAX or `iltpu`. Phases, each printing its results:

1. device: the card's name and power limit (nvidia-smi);
2. build: the five kernels from `iltpu_torch/csrc/` (sac_update,
   gail_update, kblock_update, gaussian_rowsum, pwil_transport), one nvcc
   each, in parallel; each one's `-Xptxas -v` register lines (and any
   spills), the GAIL step's shared memory at both shapes, and the
   cooperative grid (blocks per SM) and dynamic shared memory of the SAC
   and K-blocked kernels;
3. kernels: each per-update kernel against its plain PyTorch version on the
   card, one step and a 5-step chain, at the main path's shapes (pointmass:
   state 5, action 2) and at hopper's (state 12, action 3), batch 256, width
   256, discriminator width 64; SAC with min_alpha 0 and 0.05, GAIL with the
   bench configuration (BCE, spectral norm, AIRL, penalty 1, weight decay
   10, lr 3e-5) and the tuned one (Mixup, entropy 0.0248, AIRL), and the
   GAIL step's other variants (inputs up to 32, widths 16 to 128, a ragged
   batch) for one step and the chain. Tolerance:
   |kernel - plain| <= atol + rtol |plain| with rtol 2e-5 / atol 2e-6 for one
   step and 1e-4 / 1e-5 for the chain (fp32, summed in another order); SAC
   also at batch 1024, past the GEMM's whole-depth panels; both at the
   tuned GAIL@10 batch of 512 on hopper (13c's path; SAC at min_alpha
   0.05, GAIL's Mixup step on its routed variant and the tiled one), the
   route and grid printed; GAIL's Mixup
   also with a Beta(0.5, 0.5) draw from the trainer's capture-safe
   sampler (`mixup_alpha=0.5`) at both shapes. Each kernel is
   timed twice: on the device alone (the median of CUDA events around each
   of 60 calls queued while a sleep kernel holds the stream) and
   host-paced (the same without the hold);
3b. the K-blocked kernel at K = 1 (GAIL and SAC with no overlap), 2 (one
   hand-over of rewards) and 16 against K calls of the two per-update
   kernels (the same arithmetic: it must be bit-identical) and at K=5
   against its plain version (the chain tolerance), at both shapes, for
   both GAIL configurations x min_alpha 0 and 0.05; times per launch and
   per micro-update at K=16 beside the plain version's and the 16
   per-update calls'; and Mixup with a Beta(0.5, 0.5) draw at both shapes
   (K = 1, 2, 16 bit-identical, K=5 at the chain tolerance);
3c. the row-sum kernel: one row sum (centred outside) and GMMIL's fused
   reward (one launch) against their plain versions at GMMIL's 256 x 256
   (D = 7 and 15) and at 256 x 10,001 expert rows (the y loop and a ragged
   edge), at rtol 1e-5 / atol 1e-6 (the sums run in another order);
3f. PWIL's greedy-transport kernel against its plain version: 512 pools of
   the pointmass trainer's expert atoms (d 7) for three env steps, 512 x
   25,000 atoms of d 15 (PWIL@25 at hopper's size), 64 x 100,000 atoms, the
   relabelling of 25,000 rows in 25 segments (both on clusters of CTAs a
   pool), atoms on an integer grid (exact ties across warps and CTAs), pools
   of tiny masses (more than 32 atoms a row: continuation passes), a cluster
   whose N no slice divides, and pools that run out; the pools must be
   bit-equal and the rewards within rtol 1e-5 / atol 1e-6; each case timed
   on the device alone and host-paced (the relabelling also in us a row),
   with the bound of any exact method (distances and one comparison an
   atom a row);
3d. the autograd SAC update (`training.sac_pallas=false`) against the SAC
   kernel on the same state, batches and noise, at both shapes, min_alpha 0
   and 0.05, one step and a chain of 8 (the step and chain tolerances, with
   the named ill-conditioned AdamW elements of `compare`); its time an
   update on the device (from a torch.profiler trace: `traced_ms`) and
   host-paced beside the kernel's;
3e. the autograd discriminator update + the updated discriminator's reward
   (`training.disc_pallas=false`) against the GAIL kernel, BCE and Mixup,
   pointmass, one step and a chain of 5; its time a step + reward;
4. reference: the port's transition_core on the card against the same code
   on the CPU (plain versions and autograd), same state and draws, 3
   iterations x 8 updates, at 1e-4 / 1e-5: GAIL per update, GAIL with
   update_block=4 (two K-blocked launches an iteration), GMMIL; AdRIL, RED,
   DRIL and SAC with the autograd SAC update (no launch); AdRIL and DRIL
   with the SAC kernel (DRIL's BC auxiliary step writes the actor's AdamW
   state in place just before each launch) and GAIL with the autograd
   discriminator step (one SAC launch an update each); DRIL and RED
   pretrained 50 iterations on the card first; PWIL (one transport launch an
   iteration; its pools bit-equal, the ring's rewards at rtol 1e-5 / atol
   1e-6); GAIL's input options on the autograd step (reward shaping +
   subtracting log pi; state-only) and Mixup at alpha 0.5 on the GAIL
   kernel and at update_block=4 (Beta draws). A third run on the CPU with
   the SAC steps in float64, one update at a time, arbitrates the SAC
   state: an element past the tolerance between card and CPU passes only
   where the card is within it of the float64 value (counted; `compare`);
5. trainer: a GAIL-pointmass run through `iltpu_torch.trainer.Trainer` with
   512 envs, 4096 steps and ~3k updates at the default widths, with the
   launch counters set to 0 just before and checked against the update
   count just after; prints the steady env-steps/s;
5b. the same with training.update_block=16: the K-blocked kernel runs the
   iterations whose update count 16 divides, the per-update kernels the
   rest;
5c. GMMIL-pointmass at the same size: one fused reward launch and one SAC
   launch per update, no GAIL launch and no single row-sum launch;
5d. SQIL, AdRIL, DRIL and RED at the same size on the SAC kernel (DRIL and
   RED pretrained for 1,000 iterations, cut from iltpu's 100,000): one SAC
   launch an update and no other; SAC with the autograd update (iltpu's
   default, `training.sac_pallas=false`, 2,048 steps): no launch; BC with
   1,000 pretraining iterations (cut from 50,000) and its early exit: no
   launch. Prints each one's steady env-steps/s and pretraining ms an
   iteration;
5e. PWIL on the host loop (one transport launch an iteration, one SAC
   launch an update), and `training.on_device_loop=true` on GAIL, GAIL
   update_block=16, GMMIL, PWIL, DRIL and the autograd SAC update: every
   chunk replays CUDA graphs, with the launch counters checked as above;
   prints each one's steady env-steps/s beside the host loop's;
5f. pipelined acting (`training.pipeline=true`, bench.py's default) on
   GAIL per update and update_block=16, and host acting
   (`training.host_acting=true`) on GAIL per update, with the launch
   counters checked as above, each run right after the plain host loop's
   run of the same path, its steady env-steps/s beside that one's; host
   acting's costs at 512 envs on the host's clock (the copies each way,
   the numpy forward, the parameter sync);
6. graphs: on every path the on-device loop runs (GAIL per update and
   update_block=16, GMMIL, PWIL, SQIL, AdRIL, DRIL, RED on the SAC kernel,
   the autograd SAC update, RED and the GAIL step on autograd, GAIL Mixup
   at alpha 0.5 with its Beta draw in the captured front, and GAIL at
   batch 512, per update and update_block=16, whose step is the wide
   variant's cluster launch inside the graph), a chunk
   replayed from CUDA graphs against the same chunk run eagerly on the card
   from the same state and generator state, at full widths: equal bit for
   bit, with the same launches;
6b. resume: an on-device GAIL run checkpoints; a fresh Trainer resumes
   from it with every state tensor and the CUDA generator's state equal to
   the saved run's bit for bit, then replays a chunk from graphs captured
   after the load, equal bit for bit to the same chunk run eagerly;
7. tooling: (7a) a GAIL run at phase 5's width with a profiler window over
   one host-loop iteration (`profiling.start_step=2048`,
   `profiling.steps=512`): its Chrome trace holds the SAC and GAIL kernels'
   `__global__` functions once for each of the window's updates, each
   one's median duration printed beside phase 3's; (7b) a two-seed
   `python -m iltpu_torch.train -m` sweep on the GAIL kernel path (64 envs,
   1,024 steps): two job directories, `multirun.yaml` read back, launches
   equal to the two schedules' updates; (7c) `python -m
   iltpu_torch.train_all --envs pointmass,pendulum --sweep 4 --sobol 2`,
   1,280 steps a trial, each trial two forkserver workers on the card at
   once (the SAC kernel, the discriminator step on autograd: the sweep sets
   shapes the GAIL kernel refuses), each worker's launches those its
   trial's schedule owes (281 updates an env where the trial drew
   training.start=1000, none where it drew 10000), at least one trial
   trained: `sweep.jsonl`'s records and the best-trial line; (7d)
   the IQM of 7b's two seeds with its stratified bootstrap CI;
8. data parallel (`parallel.data_axis=data`): (8a) NCCL at world size 1:
   for GAIL on the per-update kernels and on the autograd updates, a
   chunk of 4 iterations x 16 updates at full widths run eagerly (the host
   loop's iterations) and one from CUDA graphs (the on-device loop's) on a
   trainer with data_axis against the same chunk on one without, from the
   same state and generator state: equal bit for bit, the same kernel
   launches, and `allreduce_mean_` 3 times an update on the autograd path
   (critic, actor + temperature, discriminator), none on the kernels;
   a chunk replayed with the all-reduces captured against it eager, bit
   for bit; ms an update of each, host-paced and replayed, with and
   without data_axis (host-paced one chunk, replayed the median of 3, each
   way twice in turns); ms a call of the one-rank all-reduce at the
   autograd steps' sizes and of the rows' gather, eager and replayed
   (`collective_ms`); then the trainer through `Trainer.run` with
   data_axis: GAIL per update on the host loop (launches as phase 5) and
   autograd GAIL on the on-device loop (64 envs, 2,048 steps) beside the
   same run without it;
   (8b) two ranks on the one card in a gloo group over CUDA tensors
   (spawned): GAIL autograd for 3 iterations x 8 updates against 8a's
   one-rank state at 1e-4 / 1e-5, 72 all-reduces, each rank's first
   chunk (a fresh process's first autograd steps) against the same chunk
   run again, bit for bit, and its ms an update (one card staging through
   the host: not a scaling figure).
9. the tensor-parallel layout (`parallel.shard_params=true`): (9a) NCCL at
   world size 1 against data_axis alone, bit for bit, eager and replayed;
   (9b) two gloo ranks on the card against one rank; (9c) GAIL's kernel
   path through `Trainer.run`, plain / data_axis / shard_params in turns;
10. the MuJoCo envs (`env_backend=native`): (10a) the C++ stepper built
   with g++ from the tree against `third_party/mujoco`, the libmujoco the
   process mapped (it must be the copy decoded from the tree's
   `third_party/mujoco/libmujoco-3.10.0.gz.b64` into the tree's
   `iltpu_torch/_build/`, with MuJoCo 3.10.0's sha256),
   512 hopper envs x 1,000 steps of seeded actions twice from one seed,
   every output bit-equal (auto-resets and the absorbing bit included),
   the host ms of one step and of one step through the trainer's
   `HostEnv`; (10b) iltpu's main path, bench.py's configuration: GAIL on
   512 hopper envs with the SAC and GAIL kernels and the fused scan,
   training.start=100, hopper's expert data, 4,096 steps through
   `Trainer.run`, plain, pipelined, host acting, update_block=16
   pipelined, pipelined and plain again, in turns: the updates run must
   be the ones owed and each kernel launched once an update (the K-blocked
   one once per 16); transition_core at hopper's shapes on the stepper's
   rows, card against CPU at 1e-4 / 1e-5; the D4RL-normalised scores
   printed, not judged; (10c) SAC with the autograd update on ant (64
   envs, 2,048 steps, ant's expert data) and GAIL on the kernels on
   walker2d and halfcheetah (16 envs, 1,024 steps); (10d) the kernels at
   every shape iltpu's configurations give: sac_update at (S, A) = (18, 6)
   and (112, 8); the coverage sweep (the six envs' D = S + A x widths 32,
   64, 128 x batches 128-1024: the GAIL step's variant, its blocks (the
   wide variant's cluster, one a segment of the rows) and shared memory,
   the K-blocked kernel's cooperative grid and its split into GAIL and SAC
   blocks, none refused); gail_update's wide variant at (B, D, Hd) =
   (1024, 120, 128), (256, 120, 64), (1024, 24, 128) and (1024, 15, 128),
   BCE and Mixup, against its plain version with a float64 run of the
   plain formulas as the arbiter, and at hopper's (256, 15, 64) tiled and
   wide in turns; kblock_update at ant's (256, 120, 64)
   as 3b; the row sums at 256 x 256, D 120; PWIL's transport at ant's
   120-feature atoms (512 pools x 5,000 atoms; the relabelling of 25 x
   1,000 rows over 25,000 atoms), pools bit-equal; sac_update at (112, 8),
   batch 1024; each against its plain version, timed, with its bound;
11. the wide shapes in the trainer, through `Trainer.run`: GAIL on 64 ant
   envs (1,024 steps) per update, update_block=16, and at the tuned
   overlays' widths (discriminator 128, batch 1024), PWIL and GMMIL on ant,
   GAIL at those widths on walker2d and hopper (16 envs), each kernel
   launched once an owed update; the first chunk (8 updates) of
   transition_core on ant's stepper rows, card against CPU at 1e-4 / 1e-5
   (GAIL per update and update_block=4, PWIL, GMMIL), then two more chunks
   of GAIL per update judged on the SAC state: the card's distance from
   the float64 run at most max(1.0, the CPU's) x the chain tolerance,
   both printed; each run's steady env-steps/s beside
   the one-block wide GAIL step's (`ONE_BLOCK_RATES`);
12. D4RL's HDF5 expert data and the plots, on a machine with no h5py and
   no matplotlib: (12a) `load_d4rl_hdf5` on `data/d4rl/hopper_expert.hdf5`
   (decoded from its committed text form): every array equal to
   `data/hopper_expert.npz`'s (the flags bool, the floats bit-equal), h5py
   never imported, the load's wall ms; (12b) 10b's pipelined main path
   (GAIL on 512 hopper envs, the SAC and GAIL kernels, the fused scan, full
   widths) with `expert_data.source=hdf5`, 8,192 steps (16 an env: hopper's
   episodes end from there, which the train_returns plot needs), a log
   every iteration and the final evaluation: its expert ring bit-equal,
   column by column, to the same trainer's ring built from the npz with the
   same seed, the updates run the ones owed and each kernel launched once
   an update; its steady env-steps/s beside 10b's pipelined rates; (12c)
   the six plots that run wrote (`Trainer._plots`, the port's PNG writer),
   each a valid PNG (signature, IHDR, every CRC) of 600 x 400, and the wall
   ms of one `_plots` call;
13. the analysis layer, on a machine with no pandas and no matplotlib:
   (13a) `iltpu_torch.analysis.seed_sweep_report` on 7b's two jobs linked
   into the `<ALG>_<env>/<run>` layout: its IQM and CI 7d's at the same
   2,000 reps, its figure a valid 960 x 420 PNG; (13b)
   `iltpu_torch.analysis.hp_opt_report` on 7c's `sweep.jsonl`: the rows in
   descending min_score, each trial once, the figure at iltpu's size for
   the sweep's parameters; (13c) `iltpu_torch.validate_learning` on the
   card into a directory of its own: GAIL on hopper (tuned, 10
   trajectories of hopper_expert_v2, min_alpha 0.05), 256 envs on the C++
   stepper, seeds 1 and 2 of 20,480 steps with an evaluation of 5 episodes
   every 10,240, the SAC and GAIL kernels launched once an owed update,
   each row's eval curve 2 finite points, each run's env-steps/s; then the
   seed-sweep report on those rows, its numbers recomputed from them. Each
   part prints its host wall ms.
14. expert-data generation on the card, its data through the main path, and
   the results matrix and run diagnostics, on a machine with no
   matplotlib: (14a) `iltpu_torch.generate_expert_data --env hopper
   --env-backend native --steps 4096 --num-envs 8 --episodes 2
   --max-attempts 6 --seed 0`: the SAC expert trained by iltpu's defaults
   (the autograd update: no kernel launched), its env-steps/s (the
   Trainer's build and evaluations included), the episodes kept and
   dropped, D4RL's six float32 columns of equal length, every kept episode
   ending in a terminal or a timeout, `expert_training/agent/` written;
   (14b) a harvest from 14a's `agent/` and `agent_best/` (`--stochastic
   0.3`), then two greedy rollouts from `agent/` whose files are
   bit-equal; (14c) GAIL on 14a's file (2 trajectories) on 64 hopper envs
   on the stepper, 4,096 steps, the SAC and GAIL kernels, the fused scan,
   pipelined, each kernel launched once an owed update, its steady
   env-steps/s; (14d) `iltpu_torch.analysis.results_matrix` on
   RESULTS.jsonl and RESULTS_TORCH.jsonl (primary, `--best-variant`,
   `--traj-grid`) at iltpu's figure sizes, and `adril_diagnosis` and
   `decay_diagnosis` on 14a's and 14c's `metrics.pkl` (a table row each,
   the 2160 x 432 figure). Each part prints its host wall ms.
15. h5py's newer formats (`libver='latest'`) through the port's reader, on
   a machine with no h5py: (15a) `load_d4rl_hdf5` on
   `data/d4rl/hopper_expert_latest.hdf5` (superblock v3, `OHDR` headers,
   fixed-array chunk indexes) equal to data/hopper_expert.npz (floats
   bit-equal, flags bool), and `read_datasets` on
   `data/d4rl/formats_latest.hdf5` (link-message groups, dense and
   compact, every chunk index, strings, compound, array, variable-length
   and committed types, lzf, nbit, scale-offset, szip) equal to the arrays
   `fixture.formats_arrays()` makes again from their seed (dtype, shape,
   bytes), h5py never imported, each read's wall ms beside 12a's; (15b)
   10b's pipelined main path (GAIL on 512 hopper envs on the stepper, the
   SAC and GAIL kernels, the fused scan, 4,096 steps) from the latest
   file: its expert ring bit-equal to the npz run's, each kernel launched
   once an owed update, its steady env-steps/s beside 12b's; (15c) the
   rest of what h5py reads, h5py never imported: `load_d4rl_hdf5` on
   `data/d4rl/hopper_expert_vds.hdf5` (each key virtual over row blocks of
   the two large fixtures, split at trajectory ends) and
   `hopper_expert_links.hdf5` (each key an external link into one of them)
   equal to the npz, `read_datasets` on `formats_remainder.hdf5` (external
   raw data under HDF5_EXTFILE_PREFIX=${ORIGIN}, an external link, virtual
   datasets with `.`, printf-style, converted and missing sources, a
   deflated root link heap with a huge link name, a 24-bit float and a VAX
   float) equal to `fixture.remainder_arrays()`, each read's host ms; then
   10b's pipelined main path from the virtual file for 2,048 steps: its
   expert ring bit-equal to the npz run's, each kernel launched once an
   owed update, its steady env-steps/s.
16. render=true on the card, with no OpenGL and no PIL: (16a) 10b's
   pipelined main path (GAIL on 512 hopper envs, the SAC and GAIL kernels),
   2,048 steps with render=true: each kernel launched once an owed update,
   then the greedy rollout's frames (MuJoCo's abstract scene from the
   stepper, ray cast on the card) in rollout.npz ((N, 480, 480, 3) uint8)
   and rollout.gif (N images); (16b) the same scenes cast again on the card
   (bit-equal) and, with frames of a 500-frame halfcheetah rollout (zero
   actions), 24 cast on the CPU: at least 99.5% of the pixels equal, the
   largest difference elsewhere printed; (16c) ms a frame cast on the card
   in batches of 16 and one at a time, the palette's and LZW's ms a frame,
   the scene export's us a step, a 500-frame render's rollout, cast, npz
   and GIF seconds; (16d) `python -m
   iltpu_torch.render_rollout` on 16a's agent/: the frame count it prints,
   the npz, the GIF walked block by block (header, loop block, a control
   block and an image a frame) and its first and last images decoded.

Then the steady rates and the pretraining times with the nvidia-smi line, one `kernels` JSON
line (the per-update and K-blocked kernels at hopper's shapes with their
launches on phase 10b's main path, the row sums and PWIL's transport on
their pointmass paths; then each kernel at the wide shapes of 10d with the
launches of the phase 11 run that takes that shape; the SAC and K-blocked
rows with the SAC step's plan at their shape, `sac_update.plan`'s barriers
and row-owned items), the nvidia-smi line,
and as the last line {"ok": true, "device": {...}}. Any failure raises and exits non-zero, and without CUDA or without
the package beside it the script exits 1 at once.
"""

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MEM_RATE = 3.35e12  # bytes/s, H100 SXM HBM3
FP32_RATE = 67e12  # FLOP/s, H100 SXM fp32 without tensor cores
TF32_RATE = 495e12  # FLOP/s, H100 SXM dense TF32 on the tensor cores
TOL_STEP = (2e-5, 2e-6)
# (batch, state, action) of the SAC step behind each kernels-line shape of
# the SAC and K-blocked kernels (width 256)
SAC_PLAN_SHAPES = {"hopper": (256, 12, 3), "ant": (256, 112, 8), "ant B=1024": (1024, 112, 8)}
TOL_CHAIN = (1e-4, 1e-5)
TOL_PWIL = (1e-5, 1e-6)  # the transport's rewards: the distances' rounding

TRAINER_ARGS = [
    "algorithm=GAIL", "env=pointmass", "env_backend=jax", "num_envs=512", "steps=4096",
    "training.start=1024", "training.sac_pallas=true", "training.disc_pallas=true",
    "training.fused_update_scan=true", "memory.size=100000", "imitation.trajectories=5",
    "expert_data.source=synthetic", "evaluation.episodes=8", "logging.interval=0",
    "check_time_usage=true", "training.timing_skip_steps=2048", "training.timing_marks=2",
]


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def clone(st):
    return {k: [t.clone() for t in v] if isinstance(v, list) else
            v.clone() if hasattr(v, "clone") else v for k, v in st.items()}


def leaves(st):
    """A state's tensors by path (a GAIL state with shaping also holds the
    count of g's leaves, `ng`)."""
    for k, v in st.items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            if hasattr(t, "dtype"):
                yield f"{k}[{i}]", t


# parameter leaf -> (its AdamW first and second moments, its step clock)
MOMENTS = {"a": ("am", "av", "ta"), "c": ("cm", "cv", "tc"), "la": ("lam", "lav", "tal"),
           "p": ("m", "v", "t")}
ILL_CONDITIONED = 100 * 1e-8  # sqrt(v_hat) below 100 eps


def compare(name, got, want, tol, got_state=None, want_state=None, labels=("kernel", "plain"),
            reference=None, magnitudes=None):
    """Raise unless every element is within tol; return the max abs error
    and the max rel error (over elements where |plain| >= 1e-3).

    Given `reference` (the same leaves from a float64 run of the same
    computation from the same state, rounded to float32), an element past
    tol where the first version (the kernel, the card) is within tol of the
    float64 value is verified, not excused: the first version is right to
    tol, whether the second one is too (their roundings went opposite
    ways) or went past it (a float32 chain through a near tie of the twin
    critics' minimum, an ill-conditioned step). Verified elements are
    counted and printed, uncapped: each is held to the float64 run. Where
    `magnitudes` has the path (`check_sac`'s log-probs at batch 1024 only),
    the element is a sum of terms that cancel, and rtol scales the float64
    magnitude of its terms instead of the cancelled sum's.

    One more exception is named, not hidden, at most 8 per comparison,
    each printed: a parameter element past tol whose AdamW moments m and v
    agree at tol in both versions and whose sqrt(v_hat) is below 100 eps.
    There the step m_hat / (sqrt(v_hat) + eps) turns a rounding-level
    difference of the gradient into a visible fraction of lr (on the first
    step it is lr sign(g)). An element past all of these fails; its message
    gives the float64 value."""
    rtol, atol = tol
    ref, mags = dict(reference or ()), dict(magnitudes or ())
    worst, worst_rel, named, unexplained, verified, outvoted = 0.0, 0.0, [], [], [], 0
    for (path, g), (_, w) in zip(got, want):
        if g.numel() == 0:
            continue
        g = g.to(w.device)
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        big = w.abs() >= 1e-3
        if bool(big.any()):
            worst_rel = max(worst_rel, float((err[big] / w.abs()[big]).max()))
        bad = (err > atol + rtol * w.abs()).flatten().nonzero().flatten().tolist()
        for i in bad:
            gi, wi = float(g.flatten()[i]), float(w.flatten()[i])
            what = f"{path} flat {i}: {labels[0]} {gi!r} {labels[1]} {wi!r}"
            if path in ref:
                r = float(ref[path].flatten()[i])
                scale = float(mags[path].flatten()[i]) if path in mags else abs(r)
                what += f", float64 {r!r}" + (f", its terms' magnitude {scale:.4g}" if path in mags else "")
                near = [abs(x - r) <= atol + rtol * scale for x in (gi, wi)]
                if near[0]:
                    verified.append(what)
                    outvoted += not near[1]
                    continue
            key, _, j = path.rstrip("]").partition("[")
            if got_state is None or key not in MOMENTS:
                unexplained.append(what)
                continue
            mk, vk, tk = MOMENTS[key]
            j = int(j or 0)
            m = [st[mk] if not isinstance(st[mk], list) else st[mk][j] for st in (got_state, want_state)]
            v = [st[vk] if not isinstance(st[vk], list) else st[vk][j] for st in (got_state, want_state)]
            m, v = [x.flatten()[i].item() for x in m], [x.flatten()[i].item() for x in v]
            t = float(want_state[tk][0])
            sqrt_vhat = (v[1] / (1 - 0.999**t)) ** 0.5
            agree = all(abs(a - b) <= atol + rtol * abs(b) for a, b in (m, v))
            entry = (f"{what}, m {m[0]!r}/{m[1]!r}, sqrt(v_hat) {sqrt_vhat:.3g}: an ill-conditioned "
                     "AdamW step (moments agree)")
            (named if agree and sqrt_vhat < ILL_CONDITIONED else unexplained).append(entry)
    if unexplained or len(named) > 8:
        raise AssertionError(
            f"{name}: past rtol {rtol} atol {atol}: " + "; ".join((unexplained or named)[:8])
        )
    if named:
        print(f"{name}: {len(named)} element(s) past rtol {rtol} atol {atol}, named: " + "; ".join(named))
    if verified:
        print(f"{name}: {len(verified)} element(s) past rtol {rtol} atol {atol} where the "
              f"{labels[0]} is within it of float64 ({outvoted} with the {labels[1]} past it), "
              "the first 4: " + "; ".join(verified[:4]))
    return worst, worst_rel


def worse(a, b):
    return tuple(max(x, y) for x, y in zip(a, b))


def median_ms(fn, n=60):
    """Host-paced time of a call: the median of CUDA events recorded around
    each of n back-to-back calls, so a call the device finishes before the
    host issues the next one is timed at the host's pace."""
    import torch

    for _ in range(5):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[n // 2]


_CYCLES_PER_MS = []


def cycles_per_ms():
    """The clock of torch.cuda._sleep, measured once with events."""
    import torch

    if not _CYCLES_PER_MS:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        cycles = 50_000_000
        torch.cuda._sleep(cycles)  # warm-up
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(cycles / a.elapsed_time(b))
    return _CYCLES_PER_MS[0]


def device_ms(fn, n=60):
    """Device time of a call: the median of CUDA events recorded around each
    of n calls while a sleep kernel holds the stream, long enough for the
    host to queue them all, so no pair of events brackets the device waiting
    for the host. (Where the queue of launches fills, the host waits for the
    device instead, and the device then never waits: the pairs still time
    the device alone, as long as a call's launches are few. A call of
    hundreds of launches fills the queue within a few calls, and once the
    sleep ends the device drains it and waits for the host: such calls are
    timed by a trace, `traced_ms`.)"""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    hold_ms = 3e3 * (time.perf_counter() - t0) + 20.0  # three times the paced run
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(int(hold_ms * cycles_per_ms()))
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[n // 2]


def issue_us(fn, n=60):
    """Host time to issue a call, in us: the mean over n calls queued while a
    sleep kernel holds the stream, so the host never waits for the device."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(50.0 * cycles_per_ms()))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def traced_ms(fn, n=10):
    """Device time of a call from a torch.profiler trace of n calls: the
    union of its kernels' intervals, per call; and the kernels, memsets and
    copies a call launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from iltpu_torch.profile_updates import busy_ms

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy, _ = busy_ms(prof)
    return busy / n, sum(e.device_type.name == "CUDA" for e in prof.events()) / n


def sac_case(S, A, B, H, min_alpha, seed, dev, n=5):
    import torch
    from iltpu_torch.models import SoftActor, TwinCritic
    from iltpu_torch.updates import SACLearner

    g = torch.Generator(device=dev).manual_seed(seed)
    learner = SACLearner(SoftActor(S, A, H, device=dev), TwinCritic(S, A, H, device=dev),
                         learning_rate=3e-4, weight_decay=1e-2, discount=0.97,
                         entropy_target=-0.5 * A, polyak_factor=0.99, min_alpha=min_alpha)
    st = learner.init(g)
    if min_alpha:
        st["la"].fill_(-6.0)  # the floor is active

    def batch():
        absorbing = (torch.rand(B, generator=g, device=dev) < 0.1).float()
        s = torch.randn(B, S, generator=g, device=dev)
        s[:, -1] = absorbing
        return {
            "states": s, "actions": torch.tanh(torch.randn(B, A, generator=g, device=dev)),
            "rewards": torch.randn(B, generator=g, device=dev),
            "next_states": torch.randn(B, S, generator=g, device=dev),
            "terminals": (torch.rand(B, generator=g, device=dev) < 0.05).float(),
            "weights": torch.ones(B, device=dev), "absorbing": absorbing,
        }, torch.randn(B, A, generator=g, device=dev), torch.randn(B, A, generator=g, device=dev)

    return learner.hyper, st, [batch() for _ in range(n)]


def log_prob_terms(st, s, eps):
    """The magnitude of the log-probs' terms (one an action) of states s
    under st's actor with noise eps, in float64: the size the rounding of
    the sum follows, however much of it cancels.

    A log-prob is the sum over the A actions of t_k = -(e_k^2 + 2 ls_k +
    log 2 pi) / 2 - 2 (log 2 - z_k - softplus(-2 z_k)). A float32 sum of n
    terms is off by up to gamma_(n-1) sum |t_k| (Higham, Accuracy and
    Stability of Numerical Algorithms, 2nd ed., section 4.2), and each t_k
    carries the rounding of ls_k and z_k (the actor's last layer, dot
    products of 256 terms), so a right float32 log-prob is off from the
    float64 one in proportion to sum |t_k|, not to |sum t_k|. Where the
    terms cancel, rtol on the sum is tighter than one float32 ulp of the
    terms: at ant's (112, 8), batch 1024, three rows have |log-prob| 0.015
    to 0.058 against sum |t_k| 6.6 to 9.0, and the card's 5.7e-6 from the
    float64 value there is 1.2 ulp of 7.9."""
    import torch
    from iltpu_torch.models.distributions import LOG2, LOG2PI, softplus
    from iltpu_torch.ops.sac_update import _mlp_fwd

    A, e = eps.shape[1], eps.double()
    o, _ = _mlp_fwd(s.double(), [t.double() for t in st["a"]])
    ls = o[:, A:].clamp(-20.0, 2.0)
    z = o[:, :A] + torch.exp(ls) * e
    return (-0.5 * (e * e + 2.0 * ls + LOG2PI) - 2.0 * (LOG2 - z - softplus(-2.0 * z))).abs().sum(-1)


def check_sac(S, A, min_alpha, dev, B=256, timed=True, cancelling=False):
    """The SAC step against its plain version, one step and a chain of 5,
    with the autograd update in float64 from the same state and inputs as
    the arbiter of an element past the tolerance (`compare`'s `reference`;
    with `cancelling`, the log-probs' judged on their terms' magnitude,
    `log_prob_terms`: at batch 1024 alone); with `timed`, its times."""
    from iltpu_torch.ops.sac_update import sac_update, sac_update_plain

    hyper, st, steps = sac_case(S, A, B, 256, min_alpha, 1 + S, dev)
    arbiter = float64_sac(learner_of(hyper, S, A, 256, dev))
    worst = (0.0, 0.0)
    for n, tol in ((1, TOL_STEP), (5, TOL_CHAIN)):
        k_st, p_st, r_st = clone(st), clone(st), clone(st)
        for i in range(n):
            b, e2, en = steps[i]
            ka = sac_update(hyper, k_st, b, e2, en)
            pa = sac_update_plain(hyper, p_st, b, e2, en)
            if cancelling:
                terms = {"log_probs[0]": log_prob_terms(r_st, b["states"], en)}  # the actor they read
            ra = arbiter(r_st, b, e2, en)
        worst = worse(worst, compare(f"sac S={S} A={A} B={B} min_alpha={min_alpha} {n}-step", [
            *leaves(k_st), *leaves(ka)], [*leaves(p_st), *leaves(pa)], tol, k_st, p_st,
            reference=[*leaves(r_st), *leaves(ra)], magnitudes=terms if cancelling else None))
    if not timed:
        return worst, None
    b, e2, en = steps[0]
    k_st, p_st = clone(st), clone(st)
    ms = device_ms(lambda: sac_update(hyper, k_st, b, e2, en))
    paced_ms = median_ms(lambda: sac_update(hyper, k_st, b, e2, en))
    plain_ms = median_ms(lambda: sac_update_plain(hyper, p_st, b, e2, en))
    return worst, (ms, paced_ms, plain_ms)


def check_sac_shape(S, A, where, dev, results, B=256, cancelling=False):
    """check_sac at min_alpha 0 and 0.05; results[("sac", where)] gets the
    worse error, the first one's times and the bound."""
    err, times = (0.0, 0.0), None
    for min_alpha in (0.0, 0.05):
        e, t = check_sac(S, A, min_alpha, dev, B=B, cancelling=cancelling)
        err, times = worse(err, e), times or t
    results[("sac", where)] = (err[0], *times, *sac_bound_ms(S, A, B, 256))
    print(f"kernel sac_update {where} S={S} A={A} B={B}: max_abs_err {err[0]:.3g}, max_rel_err "
          f"{err[1]:.3g}, {timing(results[('sac', where)][1:])}")


def bound_ms(flops, nbytes, tc_flops=0.0):
    """The least time for the work: the operations over their unit's rate
    (`flops` in fp32 on the CUDA cores; `tc_flops`, products run in 3xTF32,
    three TF32 products each on the tensor cores, over a third of the TF32
    rate), the larger of the two, against the bytes over the memory rate,
    the larger; and which one it is."""
    t_ops = max(flops / FP32_RATE, tc_flops / (TF32_RATE / 3))
    t_bytes = nbytes / MEM_RATE
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def sac_flops(S, A, B, H):
    """The products of one update (2 FLOP a multiply-add; the elementwise
    work is under 1% of them)."""
    X, O = S + A, 2 * A
    actor_fwd = 2 * B * (S * H + H * H + H * O)
    twin_fwd = 2 * 2 * B * (X * H + H * H + H)
    critic_bwd = 2 * 2 * (H * B + B * H + H * H * B + B * H * H + X * H * B)
    input_grad = 2 * 2 * (B * H + B * H * H + B * A * H)
    actor_bwd = 2 * (H * O * B + B * H * O + H * H * B + B * H * H + S * H * B)
    return 2 * actor_fwd + 3 * twin_fwd + critic_bwd + input_grad + actor_bwd


def sac_bound_ms(S, A, B, H):
    """The products over the fp32 rate, against each input read and each
    output written once over the memory rate."""
    X, O = S + A, 2 * A
    actor = S * H + H + H * H + H + H * O + O
    critic = 2 * (X * H + H + H * H + H + H + 1)
    state = 3 * actor + 4 * critic + 6
    batch = B * (2 * S + A + 4) + 2 * B * A
    return bound_ms(sac_flops(S, A, B, H), 4 * (2 * state + batch + 2 * B + 1))


def numel(ts):
    return sum(t.numel() for t in ts)


def gail_case(S, A, B, bce, seed, dev, Hd=64, sn=None, alpha=1.0, **changes):
    """The bench configuration (bce) or the tuned one, with `changes` to
    the hyperparameters and `sn` to the spectral norm where given; the
    Mixup draws Beta(alpha, alpha) from the trainer's sampler (uniform at
    alpha 1)."""
    import torch
    from iltpu_torch.models.distributions import beta_sample
    from iltpu_torch.ops.gail_update import GAILHyper
    from iltpu_torch.rewards import GAILDiscriminator

    g = torch.Generator(device=dev).manual_seed(seed)
    if bce:  # the bench configuration (algorithms.yaml GAIL)
        hyper = GAILHyper(1.0, 3e-5, 10.0, "AIRL", "BCE", 0.0)
    else:  # the tuned GAIL@10 configuration
        hyper = GAILHyper(0.436, 1.3089e-4, 0.687, "AIRL", "Mixup", 0.0248)
    hyper = hyper._replace(**changes)
    sn = bce if sn is None else sn
    disc = GAILDiscriminator(S, A, hidden_size=Hd, spectral_norm=sn,
                             reward_function=hyper.reward_function, device=dev)
    st = disc.init(g)

    def step():
        r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        u = lambda n: torch.rand(n, generator=g, device=dev)
        args = [r(B, S), torch.tanh(r(B, A)), 1 + 0.5 * u(B), r(B, S), torch.tanh(r(B, A)),
                1 + 0.5 * u(B), u(B)]
        if bce:
            return args, None
        return args, (u(B) if alpha == 1.0 else beta_sample(alpha, (B,), g, dev))

    return hyper, st, [step() for _ in range(5)]


def check_gail(S, A, bce, dev, B=256, Hd=64, timed=True, variant=None, **case):
    """The GAIL step against its plain version, one step and a chain of 5,
    with the plain formulas run in float64 from the same state as the
    arbiter (`compare`); with `timed`, its times. `variant` ('tiled' or
    'wide') runs that variant through the phase timer's unstamped entry
    (profile_phases.variant_step: a measurement, the launch counter does
    not move) instead of gail_update's routed one."""
    import functools

    from iltpu_torch import profile_phases
    from iltpu_torch.ops import gail_update as gu

    hyper, st, steps = gail_case(S, A, B, bce, 7 + S, dev, Hd, **case)
    kernel, plain = gu.gail_update, gu.gail_update_plain
    if variant is not None:
        kernel = functools.partial(profile_phases.variant_step, variant)
    double = lambda xs: [None if x is None else x.double() for x in xs]
    worst = (0.0, 0.0)
    for n, tol in ((1, TOL_STEP), (5, TOL_CHAIN)):
        k_st, p_st = clone(st), clone(st)
        d_st = {k: double(v) if isinstance(v, list) else v.double() for k, v in st.items()}
        for i in range(n):
            args, mix = steps[i]
            kl, kr = kernel(hyper, k_st, *args, mix)
            pl, pr = plain(hyper, p_st, *args, mix)
            dl, dr = plain(hyper, d_st, *double(args), *double([mix]))
        worst = worse(worst, compare(
            f"gail {variant or gu.variant(B, S + A, Hd)} S={S} A={A} B={B} Hd={Hd} {hyper} "
            f"sn={bool(st['sn'])} {n}-step",
            [*leaves(k_st), ("loss", kl), ("rewards", kr)],
            [*leaves(p_st), ("loss", pl), ("rewards", pr)], tol, k_st, p_st,
            reference=[(k, t.float()) for k, t in (*leaves(d_st), ("loss", dl), ("rewards", dr))]))
    if not timed:
        return worst, None, None
    args, mix = steps[0]
    k_st, p_st = clone(st), clone(st)
    ms = device_ms(lambda: kernel(hyper, k_st, *args, mix))
    paced_ms = median_ms(lambda: kernel(hyper, k_st, *args, mix))
    plain_ms = median_ms(lambda: plain(hyper, p_st, *args, mix))
    return worst, (ms, paced_ms, plain_ms), (hyper, st, args, mix)


SAC_AUX = ("log_probs", "Q_values", "alpha")


def learner_of(hyper, S, A, H, dev):
    """A SACLearner with `hyper`'s values, for the autograd update (its
    modules' own weights are not read: the update takes the state's)."""
    from iltpu_torch.models import SoftActor, TwinCritic
    from iltpu_torch.updates import SACLearner

    return SACLearner(SoftActor(S, A, H, device=dev), TwinCritic(S, A, H, device=dev),
                      learning_rate=hyper.lr, weight_decay=hyper.weight_decay,
                      discount=hyper.discount, entropy_target=hyper.entropy_target,
                      polyak_factor=hyper.polyak, min_alpha=hyper.min_alpha)


def check_autograd_sac(S, A, min_alpha, dev, timed=True):
    """3d: the autograd SAC update (training.sac_pallas=false) against the
    SAC kernel on the same state, batches and noise: one step, then a chain
    of 8. Returns the worst error and (traced device ms, launches,
    host-paced ms) an update."""
    from iltpu_torch.ops.sac_update import sac_update

    hyper, st, steps = sac_case(S, A, 256, 256, min_alpha, 1 + S, dev, n=8)
    learner = learner_of(hyper, S, A, 256, dev)
    worst = (0.0, 0.0)
    for n, tol in ((1, TOL_STEP), (8, TOL_CHAIN)):
        g_st, k_st = clone(st), clone(st)
        for i in range(n):
            b, e2, en = steps[i]
            ga = learner.update(g_st, b, e2, en)
            ka = sac_update(hyper, k_st, b, e2, en)
        worst = worse(worst, compare(
            f"autograd sac S={S} A={A} min_alpha={min_alpha} {n}-step",
            [*leaves(g_st), *((k, ga[k]) for k in SAC_AUX)],
            [*leaves(k_st), *((k, ka[k]) for k in SAC_AUX)], tol, g_st, k_st,
            labels=("autograd", "kernel")))
    if not timed:
        return worst, None
    b, e2, en = steps[0]
    g_st = clone(st)
    return worst, (*traced_ms(lambda: learner.update(g_st, b, e2, en)),
                   median_ms(lambda: learner.update(g_st, b, e2, en)))


def check_autograd_gail(S, A, bce, dev):
    """3e: the autograd discriminator update (training.disc_pallas=false)
    and the updated discriminator's reward against the GAIL kernel on the
    same state, batches and draws: one step, then a chain of 5. Returns the
    worst error and (traced device ms, launches, host-paced ms) a step +
    reward."""
    from iltpu_torch.ops.gail_update import gail_update
    from iltpu_torch.rewards import GAILDiscriminator
    from iltpu_torch.updates import AdversarialConfig, adversarial_imitation_update

    hyper, st, steps = gail_case(S, A, 256, bce, 7 + S, dev)
    disc = GAILDiscriminator(S, A, hidden_size=64, spectral_norm=bool(st["sn"]),
                             reward_function=hyper.reward_function, device=dev)
    cfg = AdversarialConfig(loss_function=hyper.loss_function, grad_penalty=hyper.grad_penalty,
                            entropy_bonus=hyper.entropy_bonus, learning_rate=hyper.lr,
                            weight_decay=hyper.weight_decay)

    def autograd(g_st, args, mix):
        e_s, e_a, e_w, p_s, p_a, p_w, eps_gp = args
        loss = adversarial_imitation_update(
            disc, g_st, {"states": p_s, "actions": p_a, "weights": p_w},
            {"states": e_s, "actions": e_a, "weights": e_w}, cfg, eps_gp, mix)
        return loss.reshape(1), disc.predict_reward(p_s, p_a, g_st)

    worst = (0.0, 0.0)
    for n, tol in ((1, TOL_STEP), (5, TOL_CHAIN)):
        g_st, k_st = clone(st), clone(st)
        for i in range(n):
            args, mix = steps[i]
            gl, gr = autograd(g_st, args, mix)
            kl, kr = gail_update(hyper, k_st, *args, mix)
        worst = worse(worst, compare(
            f"autograd gail S={S} A={A} {hyper.loss_function} {n}-step",
            [*leaves(g_st), ("loss", gl), ("rewards", gr)],
            [*leaves(k_st), ("loss", kl), ("rewards", kr)], tol, g_st, k_st,
            labels=("autograd", "kernel")))
    args, mix = steps[0]
    g_st = clone(st)
    return worst, (*traced_ms(lambda: autograd(g_st, args, mix)),
                   median_ms(lambda: autograd(g_st, args, mix)))


# The GAIL step at other shapes (inputs of 4 to 28 features, widths of 16 to
# 128; the routed variant, and the tiled one too where the route passed it
# over), a ragged batch, the GAIL and FAIRL heads, no penalty, and Mixup
# with spectral norm, and the tuned GAIL@10 step on hopper at its batch of 512
# (tuned.yaml; the learning-validation harness's path, 13c): (S, A, B, Hd, bce,
# changes to gail_case).
GAIL_VARIANTS = (
    (3, 1, 256, 16, True, {"grad_penalty": 0.0, "reward_function": "GAIL"}),
    (5, 2, 256, 128, False, {"sn": True, "reward_function": "FAIRL"}),
    (12, 3, 256, 32, True, {}), (12, 3, 256, 128, True, {}), (21, 7, 256, 32, False, {}),
    (18, 6, 256, 64, True, {}), (12, 3, 100, 64, False, {}), (12, 3, 512, 64, False, {}),
)


def gail_flops(B, Hd, st, args, mix, wide=False):
    """The operations of one step (the penalty's W~1^T g product only for
    the hidden units this data switches on): (fp32 FLOP, 3xTF32 FLOP). The
    wide variant runs the products over the D inputs (Z = X W~1, g, q and
    the weight gradients) on the tensor cores in 3xTF32; the rest, and
    everything of the tiled variants, is fp32."""
    import torch

    e_s, e_a, e_w, p_s, p_a, p_w, eps_gp = args
    D = e_s.shape[1] + e_a.shape[1]
    R = 2 * B if mix is None else B
    W1, b1 = st["p"][0], st["p"][1]
    gx = eps_gp[:, None] * torch.cat([e_s, e_a], 1) + (1 - eps_gp[:, None]) * torch.cat([p_s, p_a], 1)
    active = float(((gx @ W1 + b1) > 0).float().mean())  # sigma > 0 keeps the sign
    # the loss rows, the penalty rows (forward, g, W~1^T g), the weight
    # gradients, the reward rows
    products = 2 * D * Hd * (R + B * (2 + active) + (R + B) + B)
    rest = 2 * Hd * (R + (R + B) + B) + 4 * D * Hd  # the width-Hd terms, power iteration
    return (rest, products) if wide else (rest + products, 0.0)


def gail_bound_ms(S, A, B, Hd, case, variant=None):
    """The operations over their unit's rate (`gail_flops`; `variant` the
    routed one unless given), against each input read and each output
    written once over the memory rate."""
    from iltpu_torch.ops import gail_update as gu

    hyper, st, args, mix = case
    wide = (variant or gu.variant(B, S + A, Hd)) == "wide"
    D = S + A
    params = D * Hd + 2 * Hd + 1
    state = 3 * params + (2 * Hd + D + 1 if st["sn"] else 0) + 1
    batch = 2 * B * (D + 1) + B + (0 if mix is None else B)
    flops, tc_flops = gail_flops(B, Hd, st, args, mix, wide)
    return bound_ms(flops, 4 * (2 * state + batch + B + 1), tc_flops)


def kblock_case(S, A, K, bce, min_alpha, dev, alpha=1.0, B=256):
    """Full-width SAC and GAIL states and K-stacked batches of B rows and
    noise (the Mixup draws Beta(alpha, alpha), uniform at alpha 1)."""
    import torch
    from iltpu_torch.models.distributions import beta_sample

    sac_hyper, sac_st, _ = sac_case(S, A, B, 256, min_alpha, 1 + S, dev)
    gail_hyper, disc_st, _ = gail_case(S, A, B, bce, 7 + S, dev)
    g = torch.Generator(device=dev).manual_seed(31 + S + K)
    r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    u = lambda *shape: torch.rand(*shape, generator=g, device=dev)
    absorbing = (u(K, B) < 0.1).float()
    states = r(K, B, S)
    states[..., -1] = absorbing
    batches = {"states": states, "actions": torch.tanh(r(K, B, A)), "next_states": r(K, B, S),
               "terminals": (u(K, B) < 0.05).float(), "weights": 1 + 0.5 * u(K, B),
               "absorbing": absorbing}
    expert = {"states": r(K, B, S), "actions": torch.tanh(r(K, B, A)), "weights": 1 + 0.5 * u(K, B)}
    noise = {"eps_gp": u(K, B), "eps2": r(K, B, A), "eps_new": r(K, B, A)}
    if not bce:
        noise["mix"] = u(K, B) if alpha == 1.0 else beta_sample(alpha, (K, B), g, dev)
    return sac_hyper, gail_hyper, sac_st, disc_st, batches, expert, noise


def per_update_calls(sac_hyper, gail_hyper, sac_st, disc_st, batches, expert, noise):
    """K calls of the two per-update kernels, in order; the last aux."""
    from iltpu_torch.ops.gail_update import gail_update
    from iltpu_torch.ops.sac_update import sac_update

    mix = noise.get("mix")
    for k in range(batches["states"].shape[0]):
        tb = {key: v[k] for key, v in batches.items()}
        loss, tb["rewards"] = gail_update(
            gail_hyper, disc_st, expert["states"][k], expert["actions"][k], expert["weights"][k],
            tb["states"], tb["actions"], tb["weights"], noise["eps_gp"][k],
            None if mix is None else mix[k])
        aux = sac_update(sac_hyper, sac_st, tb, noise["eps2"][k], noise["eps_new"][k])
    return {"loss": loss, "rewards": tb["rewards"], **aux}


def check_kblock(S, A, bce, min_alpha, dev, timed, alpha=1.0):
    """K = 1, 2 and 16 against K per-update calls (bit-identical? K=1 runs
    GAIL and SAC with no overlap, K=2 hands the rewards over once) and K=5
    against the plain version; with `timed`, the times and the bound at
    K=16. Returns the worst error, {K: bit-identical} and the times."""
    import torch
    from iltpu_torch.ops import gail_update as gu
    from iltpu_torch.ops import sac_update as su
    from iltpu_torch.ops.kblock_update import kblock_update, kblock_update_plain

    name = f"kblock S={S} A={A} {'BCE' if bce else f'Mixup alpha {alpha}'} min_alpha={min_alpha}"
    worst, same, out = (0.0, 0.0), {}, None
    for K, tol, reference in ((1, TOL_STEP, per_update_calls), (2, TOL_STEP, per_update_calls),
                              (16, TOL_STEP, per_update_calls), (5, TOL_CHAIN, kblock_update_plain)):
        sh, gh, sac_st, disc_st, batches, expert, noise = kblock_case(S, A, K, bce, min_alpha, dev,
                                                                      alpha)
        k_sac, k_disc, r_sac, r_disc = clone(sac_st), clone(disc_st), clone(sac_st), clone(disc_st)
        ka = kblock_update(sh, gh, k_sac, k_disc, batches, expert, noise)
        ra = reference(sh, gh, r_sac, r_disc, batches, expert, noise)
        torch.cuda.synchronize()
        what = f"{name} K={K} vs {reference.__name__}"
        for part in (compare(f"{what} sac", leaves(k_sac), leaves(r_sac), tol, k_sac, r_sac),
                     compare(f"{what} disc", leaves(k_disc), leaves(r_disc), tol, k_disc, r_disc),
                     compare(f"{what} aux", ka.items(), ra.items(), tol)):
            worst = worse(worst, part)
        if reference is per_update_calls:
            got = [t for _, t in (*leaves(k_sac), *leaves(k_disc), *ka.items())]
            want = [t for _, t in (*leaves(r_sac), *leaves(r_disc), *ra.items())]
            names = [n for n, _ in (*leaves(k_sac), *leaves(k_disc), *ka.items())]
            diff = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
            same[K] = not diff
            if diff:
                print(f"{what}: not bit-identical in {len(diff)} of {len(names)} tensors: "
                      f"{', '.join(diff[:12])}")
            if timed and K == 16:
                args = (sh, gh, clone(sac_st), clone(disc_st), batches, expert, noise)
                ms = device_ms(lambda: kblock_update(*args), n=20)
                paced_ms = median_ms(lambda: kblock_update(*args), n=20)
                per_ms = device_ms(lambda: per_update_calls(*args), n=5)
                plain_ms = median_ms(lambda: kblock_update_plain(*args), n=10)
                wide = gu.variant(256, S + A, 64) == "wide"
                gail = [gail_flops(256, 64, disc_st, [expert["states"][k], expert["actions"][k],
                                                      expert["weights"][k], batches["states"][k],
                                                      batches["actions"][k], batches["weights"][k],
                                                      noise["eps_gp"][k]],
                                   None if bce else noise["mix"][k], wide) for k in range(K)]
                flops = K * sac_flops(S, A, 256, 256) + sum(f for f, _ in gail)
                state = su.state_tensors(sac_st) + gu.state_tensors(disc_st)
                slabs = [*batches.values(), *expert.values(), *noise.values()]
                nbytes = 4 * (2 * numel(state) + numel(slabs)
                              + 3 * 256 + 2)
                out = (ms, paced_ms, per_ms, plain_ms,
                       *bound_ms(flops, nbytes, sum(t for _, t in gail)))
    return worst, same, out


def check_kblock_configs(S, A, where, dev, results):
    """check_kblock for both GAIL configurations x min_alpha 0 and 0.05: K
    per-update calls bit-identical at K = 1, 2 and 16 in every one (else it
    raises); results[("kblock", where)] gets the worst error and the BCE,
    min_alpha 0 configuration's times and bound."""
    err, identical, timed = (0.0, 0.0), {}, None
    for bce in (True, False):
        for min_alpha in (0.0, 0.05):
            e, same, out = check_kblock(S, A, bce, min_alpha, dev, timed=bce and not min_alpha)
            err = worse(err, e)
            for K, v in same.items():
                identical.setdefault(K, []).append(v)
            timed = timed or out
    ms, paced_ms, per_ms, plain_ms, bound, by = timed
    results[("kblock", where)] = (err[0], ms, paced_ms, plain_ms, bound, by)
    print(f"kernel kblock_update {where} S={S} A={A}: max_abs_err {err[0]:.3g}, max_rel_err "
          f"{err[1]:.3g}, bit-identical to K per-update calls in "
          + ", ".join(f"{sum(v)} of {len(v)} configurations at K={K}" for K, v in identical.items())
          + f"; K=16: {ms:.4f} ms a launch on the device ({paced_ms:.4f} ms host-paced), "
          f"{ms / 16:.4f} ms a micro-update (16 per-update calls {per_ms:.4f} ms on the device, "
          f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms by {by})")
    broken = {K: len(v) - sum(v) for K, v in identical.items() if not all(v)}
    if broken:
        raise AssertionError(f"kblock_update {where}: not bit-identical to K per-update calls "
                             f"in {broken} configurations")


def rowsum_bound(nx, ny, D, fused):
    """A pair: the cross product, d2, two scaled exps (one operation each),
    the weighted sum; the fused reward adds the nx x nx self sum, the means
    and the weight sums. Each input read and the output written once."""
    pairs = nx * ny + (nx * nx if fused else 0)
    flops = pairs * (2 * D + 10) + 2 * (nx + ny) * D + (2 * (nx + ny) + 3 * nx if fused else 0)
    return bound_ms(flops, 4 * (nx * D + ny * D + ny + 2 + nx + (nx if fused else 0)))


def check_rowsum(dev, sizes=((256, 256, 7), (256, 256, 15), (256, 10001, 7))):
    """One row sum (centred outside) and GMMIL's fused reward against their
    plain versions; times and the bound at each (nx, ny, D). Returns
    {(entry, nx, ny, D): (err, ms, paced_ms, plain_ms, bound, by)}."""
    import torch
    from iltpu_torch.ops import build
    from iltpu_torch.ops import gaussian_rowsum as gr
    from iltpu_torch.ops.pairwise import centre

    g = torch.Generator(device=dev).manual_seed(5)
    lib = gr._bind(build.load("gaussian_rowsum"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    results = {}
    for nx, ny, D in sizes:
        x = torch.randn(nx, D, generator=g, device=dev)
        y = 1.5 * torch.randn(ny, D, generator=g, device=dev) + 0.3
        w = 1 + torch.rand(ny, generator=g, device=dev)
        wx = 1 + torch.rand(nx, generator=g, device=dev)
        g1, g2 = torch.full((1,), 0.8, device=dev), torch.full((1,), 3.1, device=dev)
        wn = w / w.sum()
        xc, yc = centre(x, y)
        for entry, got, want, kernel, plain in (
            ("gaussian_rowsum", gr.gaussian_rowsum(x, y, wn, g1, g2),
             gr.gaussian_rowsum_plain(x, y, wn, g1, g2),
             lambda: gr.launch(lib, xc, yc, wn, g1, g2, stream),
             lambda: gr.rowsums_plain(xc, yc, wn, g1, g2)),
            ("gmmil_witness_reward", gr.gmmil_witness_reward(x, y, wx, w, g1, g2),
             gr.gmmil_witness_reward_plain(x, y, wx, w, g1, g2),
             lambda: gr.launch_reward(lib, x, y, wx, w, g1, g2, stream),
             lambda: gr.gmmil_witness_reward_plain(x, y, wx, w, g1, g2)),
        ):
            err = compare(f"{entry} {nx}x{ny} D={D}", [("out", got)], [("out", want)], (1e-5, 1e-6))
            ms, paced_ms, plain_ms = device_ms(kernel), median_ms(kernel), median_ms(plain)
            bound, by = rowsum_bound(nx, ny, D, entry == "gmmil_witness_reward")
            results[(entry, nx, ny, D)] = (err[0], ms, paced_ms, plain_ms, bound, by)
            print(f"kernel {entry} {nx}x{ny} D={D}: max_abs_err {err[0]:.3g}, max_rel_err "
                  f"{err[1]:.3g}, {ms:.4f} ms on the device ({paced_ms:.4f} ms host-paced; plain "
                  f"{plain_ms:.4f} ms, bound {bound:.6f} ms by {by})")
    single = results.get(("gaussian_rowsum", 256, 10001, 7))
    if single and single[1] >= single[3]:
        raise AssertionError(f"gaussian_rowsum 256x10001: {single[1]:.4f} ms on the device, not "
                             f"faster than its plain version's {single[3]:.4f} ms")
    return results


def pwil_bound(P, N, d, R):
    """The least work of any exact method: each row's N distances of d
    features (a subtract, a multiply and an add each, and a root) and one
    comparison per atom to select; each input read and each output written
    once (the pools both)."""
    flops = R * N * (3 * d + 1) + R * N
    return bound_ms(flops, 4 * (N * d + 2 * P * N + R * d + (P + 1) + R) + R)


# 3f's cases: (name, pools, atoms, features, rows, episode length T,
# segments, steps checked, changes). Changes: `grid` puts atoms and queries
# on the integers 0 .. grid-1 (many equal distances); `mass` is the atom
# weight in units of 1/N (below 1: pools of tiny masses, so a row takes
# many more atoms than 32); `atoms_of` takes the expert atoms (and N, d, T)
# of a PWIL trainer: "pointmass" the trainer's of 3f, "ant" phase 11's
# ant_pwil run's.
PWIL_CASES = (
    ("pointmass", 512, None, None, 512, None, False, 3, {"atoms_of": "pointmass"}),
    ("pwil25_hopper", 512, 25000, 15, 512, 1000, False, 2, {}),
    ("pools64_100k", 64, 100000, 15, 64, 1000, False, 2, {}),
    ("relabel", 25, 25000, 15, 25000, 1000, True, 1, {}),
    ("ties_step", 512, 4000, 3, 512, 100, False, 3, {"grid": 3}),
    ("ties_cluster", 16, 20000, 4, 16, 1000, False, 3, {"grid": 3}),
    ("drained", 64, 20000, 15, 64, 1000, False, 2, {"mass": 0.05}),
    ("ragged_cluster", 20, 30001, 15, 20, 1000, False, 2, {}),
    ("exhausted", 16, 600, 7, 32, 1000, True, 1, {"mass": 0.0006}),
)
# 10d's: ant's 120-feature atoms: an env step of phase 11's ant_pwil run
# (64 pools of its expert atoms, the kernels line's ant row), one of 512
# pools x 5,000 atoms and the relabelling of 25 x 1,000 rows over 25,000
# atoms
PWIL_ANT_CASES = (
    ("ant_run", 64, None, None, 64, None, False, 2, {"atoms_of": "ant"}),
    ("ant_step", 512, 5000, 120, 512, 1000, False, 2, {}),
    ("relabel_ant", 25, 25000, 120, 25000, 1000, True, 1, {}),
)


def pwil_case(dev, P, N, d, R, T, segments, seed, atoms=None, grid=None, mass=1.0):
    """Atoms, fresh pools, queries, offsets and resets: one row a pool with
    a 5% reset draw (an env step), or R // P rows a pool reset after its
    last (the relabelling)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    if grid:
        atoms = torch.randint(0, grid, (N, d), generator=g, device=dev).float()
        queries = torch.randint(0, grid, (R, d), generator=g, device=dev).float()
    else:
        if atoms is None:
            atoms = torch.randn(N, d, generator=g, device=dev)
        queries = 1.2 * torch.randn(R, d, generator=g, device=dev)
    if segments:
        L = R // P
        offsets = torch.arange(0, R + 1, L, dtype=torch.int32, device=dev)
        reset = torch.zeros(R, dtype=torch.bool, device=dev)
        reset[L - 1::L] = True
    else:
        offsets = torch.arange(P + 1, dtype=torch.int32, device=dev)
        reset = torch.rand(R, generator=g, device=dev) < 0.05
    kw = dict(atom_weight=mass / N, agent_weight=1.0 / T - 1e-6, bandwidth=5.0 * T / d ** 0.5,
              scale=5.0)
    return atoms, torch.full((P, N), mass / N, device=dev), queries, offsets, reset, kw


def check_pwil(dev, cases=PWIL_CASES):
    """3f: the transport kernel against its plain version (`cases`): the
    trainer's pointmass shapes (512 pools of its expert atoms, d 7, three
    steps), PWIL@25's hopper size (512 x 25,000 atoms, d 15), 64 x 100,000
    atoms and a relabelling of 25,000 rows in 25 segments (clusters of CTAs
    a pool), atoms on an integer grid (exact ties, within and across CTAs),
    pools of tiny masses (a row takes more than 32 atoms: the kernel's
    continuation passes), a cluster whose N no slice or tile divides, and
    pools that run out. Pools bit-equal, rewards at rtol 1e-5 / atol 1e-6.
    Each case is timed on its first step's inputs: an env step with every
    row resetting its pool, so each call does that step's work; a
    segmented case as checked (it leaves its pools as they started).
    Returns {case: (err, ms, paced_ms, plain_ms, bound, by)}."""
    import torch
    from iltpu_torch.config import load_config
    from iltpu_torch.ops.pwil_transport import cluster_size, pwil_transport, pwil_transport_plain
    from iltpu_torch.trainer import Trainer

    out = os.path.join(REPO, "outputs", "chip_smoke", "pwil")
    results = {}
    for case, P, N, d, R, T, segments, steps, changes in cases:
        changes = dict(changes)
        if of := changes.pop("atoms_of", None):
            args = list(ANT) if of == "ant" else TRAINER_ARGS
            t = Trainer(load_config(args + alg_args("PWIL") + [f"output_dir={out}"]), out_dir=out)
            changes["atoms"] = t.disc.expert_atoms
            (N, d), T = t.disc.expert_atoms.shape, t.env.max_episode_steps
        a, pools, q, off, reset, kw = pwil_case(dev, P, N, d, R, T, segments, N, **changes)
        kp, pp, err, q0, k_max = pools.clone(), pools.clone(), (0.0, 0.0), q, 0
        for i in range(steps):
            got = pwil_transport(a, kp, q, off, reset, **kw)
            before = pp.clone()
            want, rounds = pwil_transport_plain(a, pp, q, off, reset, count_rounds=True, **kw)
            if not torch.equal(kp, pp):
                n = int((kp != pp).sum())
                raise AssertionError(f"pwil_transport {case} step {i}: {n} pool entries differ")
            err = worse(err, compare(f"pwil_transport {case} step {i}", [("rewards", got)],
                                     [("rewards", want)], TOL_PWIL))
            if not segments:  # atoms a row took: the entries its step changed
                k_max = max(k_max, int(((before != pp) & ~reset[:, None]).sum(1).max()))
            if grid := changes.get("grid"):
                q = torch.randint(0, grid, q.shape, generator=torch.Generator(device=dev).manual_seed(i),
                                  device=dev).float()
            else:
                q = 1.2 * torch.randn(q.shape, generator=torch.Generator(device=dev).manual_seed(i),
                                      device=dev)
        fresh, q = pools.clone(), q0
        timed = reset if segments else torch.ones_like(reset)
        if not segments:
            _, rounds = pwil_transport_plain(a, fresh.clone(), q, off, timed, count_rounds=True, **kw)
        relabel = case.startswith("relabel")
        n = 10 if relabel else 60
        ms = device_ms(lambda: pwil_transport(a, fresh, q, off, timed, **kw), n=n)
        paced_ms = median_ms(lambda: pwil_transport(a, fresh, q, off, timed, **kw), n=n)
        plain_ms = (None if relabel  # one call ~9 s
                    else median_ms(lambda: pwil_transport_plain(a, fresh, q, off, timed, **kw), n=5))
        bound, by = pwil_bound(P, N, d, R)
        results[case] = (err[0], ms, paced_ms, plain_ms, bound, by)
        per_row = (f", {1e3 * ms / (R // P):.2f} us a row of a segment" if segments else
                   f", up to {k_max} atoms a row")
        plain = f"{plain_ms:.4f} ms" if plain_ms is not None else "not timed"
        print(f"kernel pwil_transport {case}: {P} pools x {N} atoms, d {d}, {R} rows, a cluster "
              f"of {cluster_size(P, N)} CTA(s) a pool, {rounds} greedy rounds{per_row}: pools "
              f"bit-equal over {steps} step(s), max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}, "
              f"{ms:.4f} ms on the device ({paced_ms:.4f} ms host-paced; plain {plain}), bound "
              f"{bound:.6f} ms by {by}")
    return results


GMMIL_ARGS = ["algorithm=GMMIL", "training.disc_pallas=false", "training.fused_update_scan=false"]
MIXUP05 = ("imitation.loss_function=Mixup", "imitation.mixup_alpha=0.5")
OPTIONS = ("imitation.discriminator.reward_shaping=true",
           "imitation.discriminator.subtract_log_policy=true")


def alg_args(alg, sac_pallas=True):
    """The trainer's arguments for `alg` on the per-update body (no GAIL
    kernel flags), with the SAC kernel or the autograd SAC update."""
    return [f"algorithm={alg}", "training.disc_pallas=false", "training.fused_update_scan=false",
            f"training.sac_pallas={str(sac_pallas).lower()}"]


def disc_leaves(trainer):
    """The discriminator state's float tensors, by path."""
    import torch

    st = trainer.disc_state
    if trainer.algorithm == "GMMIL":
        return gmmil_leaves(st)
    if trainer.algorithm == "PWIL":
        return [("pools", st.expert_weights)]
    if st is None:
        return []
    return [(k, t) for k, t in leaves(st) if t.dtype != torch.bool]


def sync_disc(cpu, gpu):
    """Copy the card trainer's discriminator state (DRIL's threshold and
    RED's sigma included) to the CPU trainer."""
    from iltpu_torch import convert

    if gpu.algorithm == "GAIL":
        convert.load_disc_tree_(cpu.disc_state, convert.disc_tree(gpu.disc_state))
    elif gpu.algorithm == "DRIL":
        convert.load_opt_tree_(cpu.disc_state, convert.opt_tree(gpu.disc_state))
        cpu.dril_threshold = gpu.dril_threshold.cpu()
    elif gpu.algorithm == "RED":
        convert.load_red_tree_(cpu.disc_state, convert.red_tree(gpu.disc_state))


def float64_sac(learner):
    """The learner's autograd SAC update computed in float64 on a widened
    copy of the state, rounded back into it: the arbiter of a difference
    between the card and the CPU (`compare`'s `reference`)."""
    update = type(learner).update

    def wide_update(st, batch, eps2, eps_new, mesh=None):
        wide = {k: [t.double() for t in v] if isinstance(v, list) else v.double()
                for k, v in st.items()}
        out = update(learner, wide, {k: v.double() for k, v in batch.items()}, eps2.double(),
                     eps_new.double(), mesh)
        for (_, t), (_, w) in zip(leaves(st), leaves(wide)):
            t.copy_(w)
        return {k: out[k].float() for k in SAC_AUX}

    return wide_update


def distance_from(reference, got, tol):
    """How far each version's leaves lie from the float64 run's, in units of
    tol (|x - r| / (atol + rtol |r|)): the largest, and the elements past 1."""
    import torch

    rtol, atol = tol
    ref, most, past = dict(reference), 0.0, 0
    for path, x in got:
        r = ref[path]
        ratio = (x.to(r.device) - r).abs() / (atol + rtol * r.abs())
        most, past = max(most, float(ratio.max())), past + int((ratio > 1).sum())
    return most, past


def check_against_cpu(dev, extra=(), rows=None, iterations=3, watched=0, out=None):
    """transition_core on the card (kernels, or the autograd updates where
    the flags say so) against the CPU (plain versions, autograd),
    `iterations` x 8 updates, from one state (DRIL and RED pretrained for 50
    iterations on the card first), with a third run on the CPU whose SAC
    steps are computed in float64, one update at a time (a K-blocked
    launch's arithmetic is K per-update bodies), as the arbiter of the SAC
    state (see `compare`); each iteration's
    4 env rows are random, or `rows()`'s (an env's step). Then `watched`
    more iterations, where the card's and the CPU's float32 chains have
    carried their roundings further: each is judged on the SAC state by its
    distance from the float64 run's in units of the chain tolerance
    (`distance_from`), the card's at most max(1.0, the CPU's), so the kernel
    stays at least as close to float64 as the CPU's float32 reference; both
    printed. Outputs go to `out` (the repo's outputs/chip_smoke if None).
    Returns the worst error and the launches the card's run made in the
    iterations compared with the CPU."""
    import torch
    from iltpu_torch import convert
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    args = [a for a in TRAINER_ARGS if not a.startswith(("num_envs", "steps", "memory"))]
    args += ["num_envs=4", "steps=300", "memory.size=1000", "training.batch_size=16",
             "imitation.pretraining.iterations=50", *extra]
    out = out or os.path.join(REPO, "outputs", "chip_smoke")
    args.append(f"output_dir={out}")
    gpu = Trainer(load_config(args), out_dir=out)
    cpu = Trainer(load_config(args + ["platform=cpu"]), out_dir=out)
    ref = Trainer(load_config(args + ["platform=cpu"]), out_dir=out)
    ref.sac_pallas, ref.learner.update = False, float64_sac(ref.learner)
    ref.update_block = 1
    if gpu.algorithm in ("DRIL", "RED"):
        gpu.pretrain_discriminator()
    for t in (cpu, ref):
        convert.load_sac_tree_(t.sac, convert.sac_tree(gpu.sac))
        sync_disc(t, gpu)
    g = torch.Generator().manual_seed(11)
    S, A, n = cpu.state_size, cpu.action_size, 4
    worst = (0.0, 0.0)
    before = counts()
    for it in range(iterations + watched):
        if it == iterations:
            launched = {k: v - before[k] for k, v in counts().items()}
        data = rows() if rows else [
            torch.randn(n, S, generator=g), torch.tanh(torch.randn(n, A, generator=g)),
            torch.randn(n, generator=g), torch.randn(n, S, generator=g),
            (torch.rand(n, generator=g) < 0.3).float(), torch.zeros(n)]
        noise = cpu.draw_noise(8)
        for key in ("replay", "expert"):  # raw integers, reduced modulo the limit
            noise[key] = torch.randint(0, 2**62, (8 * 16,), generator=g)
        c_aux = cpu.transition_core(it * n, *data, 8, noise=noise)
        ref.transition_core(it * n, *data, 8, noise=noise)
        g_aux = gpu.transition_core(it * n, *[x.to(dev) for x in data], 8,
                                    noise={k: v.to(dev) for k, v in noise.items()})
        name = f"transition_core {' '.join(extra) or 'GAIL'} iteration {it}"
        if it >= iterations:
            (card, n_card), (host, n_host) = (distance_from(leaves(ref.sac), leaves(t.sac), TOL_CHAIN)
                                              for t in (gpu, cpu))
            verdict = (f"{name} sac: the card at most {card:.3g} x the chain tolerance from float64 "
                       f"({n_card} element(s) past it), the CPU {host:.3g} x ({n_host}); the card "
                       f"may reach max(1.0, the CPU's) = {max(1.0, host):.3g}")
            if card > max(1.0, host):
                raise AssertionError(verdict)
            print(verdict)
            continue
        parts = [
            compare(f"{name} sac", leaves(gpu.sac), leaves(cpu.sac), TOL_CHAIN, gpu.sac, cpu.sac,
                    reference=leaves(ref.sac)),
            compare(f"{name} aux", g_aux.items(), c_aux.items(), TOL_CHAIN),
        ]
        if gpu.algorithm == "GMMIL":
            parts.append(compare(f"{name} gmmil", gmmil_leaves(gpu.disc_state),
                                 gmmil_leaves(cpu.disc_state), TOL_CHAIN))
        elif gpu.algorithm == "PWIL":
            pools = [(k, t.cpu()) for k, t in disc_leaves(gpu)]
            if not torch.equal(pools[0][1], cpu.disc_state.expert_weights):
                raise AssertionError(f"{name}: the PWIL pools differ between the card and the CPU")
            parts.append(compare(f"{name} ring rewards", [("rewards", gpu.replay.rows("rewards"))],
                                 [("rewards", cpu.replay.rows("rewards"))], TOL_PWIL))
        elif gpu.disc_state is not None:
            parts.append(compare(f"{name} disc", disc_leaves(gpu), disc_leaves(cpu), TOL_CHAIN,
                                 gpu.disc_state, cpu.disc_state))
        if gpu.algorithm == "AdRIL" and bool(gpu.relabel) != bool(cpu.relabel):
            raise AssertionError(f"{name}: the balanced flip differs")
        for part in parts:
            worst = worse(worst, part)
    if not watched:
        launched = {k: v - before[k] for k, v in counts().items()}
    return worst, launched


def gmmil_leaves(st):
    return [("gamma_1", st.gamma_1), ("gamma_2", st.gamma_2), ("initialized", st.initialized.float())]


def wrappers():
    """Every kernel wrapper with a launch counter."""
    from iltpu_torch.graphs import wrappers as all_wrappers

    return all_wrappers()


def counts():
    return {f.__name__: f.launches for f in wrappers()}


def reset_counts():
    for f in wrappers():
        f.launches = 0


def launches_of(**nonzero):
    """The counter of every wrapper, 0 unless given."""
    return {f.__name__: nonzero.get(f.__name__, 0) for f in wrappers()}


def schedule(cfg, K):
    """(updates in iterations K divides, the other updates), as the host
    loop counts them (n_updates of each iteration)."""
    t = cfg.training
    blocked = other = done = 0
    for new_step in range(cfg.num_envs, cfg.steps + cfg.num_envs, cfg.num_envs):
        if new_step >= t.start:
            target = (new_step - t.start) // t.interval + 1
            n, done = target - done, target
            if n and K > 1 and n % K == 0:
                blocked += n
            else:
                other += n
    return blocked, other


# What a trainer run must launch, from its counts.
def per_update(t):
    return launches_of(sac_update=t.updates_done, gail_update=t.updates_done)


def blocked(t):
    k, rest = schedule(t.cfg, 16)
    return launches_of(sac_update=rest, gail_update=rest, kblock_update=k // 16)


def blocked_all(t):  # the device loop's iterations all take num_envs // interval updates
    return launches_of(kblock_update=t.updates_done // 16)


def gmmil(t):
    return launches_of(sac_update=t.updates_done, gmmil_witness_reward=t.updates_done)


def pwil_path(t):
    return launches_of(sac_update=t.updates_done, pwil_transport=t.step_done // t.cfg.num_envs)


def sac_only(t):
    return launches_of(sac_update=t.updates_done)


def none(t):
    return launches_of()


def owed(expect):
    """`expect`'s launches, once the updates run are the schedule's."""
    def check(t):
        if t.updates_done != sum(schedule(t.cfg, 1)):
            raise AssertionError(f"{t.updates_done} updates run, {sum(schedule(t.cfg, 1))} owed")
        return expect(t)
    return check


def timing(t):
    return (f"{t[0]:.4f} ms on the device ({t[1]:.4f} ms host-paced; plain {t[2]:.4f} ms, "
            f"bound {t[3]:.5f} ms by {t[4]})")


def run_trainer(name, extra, expect, keep=None):
    """One full-width trainer run through its normal entry, counters set to
    0 just before and read just after; `expect(trainer)` gives the counts
    it must show. Returns (counts, steady env-steps/s or None for BC's
    early exit, pretraining ms per iteration or None); appends the trainer
    to `keep` where given."""
    import numpy as np
    import torch
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    out_dir = os.path.join(REPO, "outputs", "chip_smoke", name)
    trainer = Trainer(load_config(TRAINER_ARGS + list(extra) + [f"output_dir={out_dir}"]),
                      out_dir=out_dir)
    if keep is not None:
        keep.append(trainer)
    reset_counts()
    t0 = time.time()
    score = trainer.run()
    wall = time.time() - t0
    launches = counts()
    n = trainer.updates_done
    want = expect(trainer)
    bc_exit = trainer.algorithm == "BC"
    if launches != want or (n == 0) != bc_exit:
        raise AssertionError(f"{name}: launch counters {launches} != {want} ({n} updates)")
    m = trainer.metrics
    if not np.isfinite(score) or not all(np.isfinite(r).all() for r in m["test_returns"]):
        raise AssertionError(f"{name}: non-finite score {score} or returns {m['test_returns']}")
    with trainer._work(write=False):  # under the layout, the parameters gathered whole
        for path, t in [*leaves(trainer.sac), *disc_leaves(trainer)]:
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: non-finite trainer state {path}")
    cfg = trainer.cfg
    iters = cfg.bc_pretraining.iterations if bc_exit else cfg.imitation.get("pretraining", {}).get("iterations")
    pre_ms = None
    if "pre_training_time" in m:
        pre_ms = 1e3 * m["pre_training_time"] / iters
        print(f"trainer {name}: pretraining {iters} iterations in {m['pre_training_time']:.2f} s, "
              f"{pre_ms:.4f} ms an iteration" + ("" if bc_exit else
                                                 " (the threshold or sigma after it included)"))
    print(f"trainer {name}: {trainer.step_done} env steps, {n} updates, {launches}, {wall:.2f} s "
          f"wall, score {score:.4f}, eval returns {[round(r, 3) for r in m['test_returns'][-1]]}")
    if bc_exit:
        return launches, None, pre_ms
    marks = m["steady_marks"]
    windows = [(b[0] - a[0]) / (b[1] - a[1]) for a, b in zip(marks, marks[1:])]
    steady = m["steady_env_steps"] / m["steady_time"]
    print(f"trainer {name}: steady {steady:.1f} env-steps/s (windows {[round(w, 1) for w in windows]})")
    return launches, steady, pre_ms


# Phase 6's paths: every path the on-device loop runs from graphs.
GRAPH_PATHS = (
    ("gail", ()), ("gail_kblock16", ("training.update_block=16",)), ("gmmil", tuple(GMMIL_ARGS)),
    ("pwil", tuple(alg_args("PWIL"))), ("sqil", tuple(alg_args("SQIL"))),
    ("adril", tuple(alg_args("AdRIL"))), ("dril", tuple(alg_args("DRIL"))),
    ("red", tuple(alg_args("RED"))), ("sac_autograd", tuple(alg_args("SAC", False))),
    ("red_autograd", tuple(alg_args("RED", False))), ("gail_autograd", tuple(alg_args("GAIL"))),
    ("gail_mixup05", MIXUP05),
    # batch 512 routes pointmass's step to the wide variant: a cluster launch in the graph
    ("gail_wide", ("training.batch_size=512",)),
    ("gail_wide_kblock16", ("training.batch_size=512", "training.update_block=16")),
)


def snapshot(t, env_state):
    """Copies of everything a chunk changes: the trainer's state tensors,
    the env state and the generator state."""
    st = {k: v.clone() for k, v in t.state_tensors().items()}
    st.update({f"env.inner.{k}": v.clone() for k, v in env_state["inner"].items()})
    st.update({"env.t": env_state["t"].clone(), "env.obs": env_state["obs"].clone()})
    return st, t.gen.get_state()


def restore(t, env_state, snap):
    st, gen = snap
    live = dict(t.state_tensors())
    live.update({f"env.inner.{k}": v for k, v in env_state["inner"].items()})
    live.update({"env.t": env_state["t"], "env.obs": env_state["obs"]})
    for k, v in live.items():
        v.copy_(st[k])
    t.gen.set_state(gen)


def graph_vs_eager(t, env_state, step, n, name):
    """One chunk of n iterations from env step `step` replayed from CUDA
    graphs (captured here, after a warm-up chunk) against the same chunk run
    eagerly through `Trainer.run_chunk`, from the same state and generator
    state: every state tensor, the env state, the generator, the rewards,
    dones and last aux must be equal bit for bit, and the launch counters
    must move alike. Returns (state tensors compared, launches a chunk)."""
    import torch
    from iltpu_torch.graphs import ChunkGraphs

    N = t.cfg.num_envs
    graphs = ChunkGraphs(t, n)
    graphs.run(env_state, step, n, N)  # warm-up, capture, replays
    step += n * N
    before = snapshot(t, env_state)
    c0 = counts()
    chunk = t.run_chunk(env_state, step, n, N)
    eager = [x.clone() for x in chunk[:2]]
    eager_aux = {k: v.clone() for k, v in chunk[2].items()}
    eager_launches = {k: v - c0[k] for k, v in counts().items()}
    after_eager = snapshot(t, env_state)
    restore(t, env_state, before)
    c0 = counts()
    rewards, dones, aux = graphs.run(env_state, step, n, N)
    graph_launches = {k: v - c0[k] for k, v in counts().items()}
    after_graphs = snapshot(t, env_state)
    torch.cuda.synchronize()
    differ = [k for k, v in after_eager[0].items() if not torch.equal(v, after_graphs[0][k])]
    if not torch.equal(after_eager[1], after_graphs[1]):
        differ.append("generator")
    differ += [k for k, a, b in (("rewards", eager[0], rewards), ("dones", eager[1], dones))
               if not torch.equal(a, b)]
    differ += [f"aux {k}" for k, v in eager_aux.items() if k not in aux or not torch.equal(v, aux[k])]
    if differ:
        raise AssertionError(f"graphs {name}: the replayed chunk differs from the eager one in "
                             f"{len(differ)} tensors: {differ[:12]}")
    if eager_launches != graph_launches:
        raise AssertionError(f"graphs {name}: launches {graph_launches} replayed, "
                             f"{eager_launches} eager")
    print(f"graphs {name}: a chunk of {n} iterations x {N} updates replayed from graphs equals "
          f"the eager chunk bit for bit in {len(after_eager[0])} tensors, the generator, the "
          f"rewards, dones and last aux; launches {graph_launches}")
    return len(after_eager[0]), graph_launches


GRAPH_ARGS = [a for a in TRAINER_ARGS if not a.startswith(("num_envs", "training.start"))] + [
    "num_envs=16", "training.start=0", "training.on_device_loop=true"]


def check_graphs(dev):
    """6: on each path, one chunk (4 iterations of 16 envs, 16 updates an
    iteration, full widths) from CUDA graphs against the same chunk run
    eagerly (`graph_vs_eager`). Returns {path: (state tensors compared,
    launches a chunk)}."""
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    out = {}
    for name, extra in GRAPH_PATHS:
        out_dir = os.path.join(REPO, "outputs", "chip_smoke", f"graphs_{name}")
        t = Trainer(load_config(GRAPH_ARGS + list(extra) + [f"output_dir={out_dir}"]),
                    out_dir=out_dir)
        env_state = t.env.reset()
        t.run_chunk(env_state, 0, 4, 0)  # rows in the ring
        out[name] = graph_vs_eager(t, env_state, 4 * 16, 4, name)
    return out


def check_resume(dev):
    """6b: an on-device GAIL run (graphs on the card) writes a checkpoint;
    a fresh Trainer resumes from it: every state tensor and the CUDA
    generator's state must equal the saved run's bit for bit; then the
    resumed trainer replays a chunk from graphs captured after the load,
    which must equal the same chunk run eagerly, bit for bit."""
    import torch
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    out_dir = os.path.join(REPO, "outputs", "chip_smoke", "resume")
    args = GRAPH_ARGS + ["steps=512", "checkpointing.interval=256", "logging.interval=128",
                         f"output_dir={out_dir}"]
    t = Trainer(load_config(args), out_dir=out_dir)
    t.run()
    ckpt = os.path.join(out_dir, "checkpoint")
    r = Trainer(load_config(args + [f"checkpointing.resume={ckpt}"]), out_dir=out_dir)
    saved, got = t.state_tensors(), r.state_tensors()
    differ = [k for k in saved if not torch.equal(saved[k], got[k])]
    if sorted(saved) != sorted(got) or differ or not torch.equal(t.gen.get_state(), r.gen.get_state()):
        raise AssertionError(f"resume: the restored state differs from the saved run's in "
                             f"{differ[:12]} or the generator")
    if r.start_step != 512 or r.metrics["update_steps"] != t.metrics["update_steps"]:
        raise AssertionError(f"resume: start step {r.start_step}, metrics not restored")
    print(f"resume: an on-device GAIL run of 512 steps checkpointed; a fresh trainer resumed it "
          f"with {len(got)} state tensors and the CUDA generator state equal bit for bit")
    env_state = r._reset_env()
    return graph_vs_eager(r, env_state, r.start_step, 4, "resumed gail")


# Phase 8: data parallel (`parallel.data_axis`). The chunks run at phase 6's
# size (16 envs, 16 updates an iteration, full widths); (name, arguments,
# all-reduces an update).
DP_ARGS = [a for a in GRAPH_ARGS if not a.startswith("training.fused_update_scan")] + [
    "training.fused_update_scan=false"]
DP_PATHS = (
    ("gail_kernels", (), 0),  # the GAIL and SAC kernels: replicated, no collective
    ("gail_autograd", tuple(alg_args("GAIL", False)), 3),  # discriminator, critic, actor
)
DP = ("parallel.data_axis=data",)


def timed_chunks(t, run, env_state, step, n, reps=3):
    """Wall ms an update of `reps` chunks of `run` from `step`, each ended
    by a synchronise: their median."""
    import numpy as np
    import torch

    N, out = t.cfg.num_envs, []
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(env_state, step + r * n * N, n, N)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / (n * N))
    return float(np.median(out))


def same_chunk(name, pair, envs, run, step, n, per_update):
    """One chunk of `run` (eager or from graphs) on the trainer without and
    the trainer with data_axis, from the same state and generator state:
    equal bit for bit, the same kernel launches, `per_update` all-reduces an
    update on the data-parallel one only."""
    import torch

    N, got = pair[0].cfg.num_envs, []
    for t, env in zip(pair, envs):
        c0 = counts()
        chunk = run(t)(env, step, n, N)
        torch.cuda.synchronize()
        snap = snapshot(t, env)
        got.append((snap, chunk, {k: v - c0[k] for k, v in counts().items()}))
    (a, ca, la), (b, cb, lb) = got
    differ = [k for k, v in a[0].items() if not torch.equal(v, b[0][k])]
    if not torch.equal(a[1], b[1]):
        differ.append("generator")
    differ += [w for w, x, y in (("rewards", ca[0], cb[0]), ("dones", ca[1], cb[1])) if not torch.equal(x, y)]
    differ += [f"aux {k}" for k, v in ca[2].items() if not torch.equal(v, cb[2][k])]
    if differ:
        raise AssertionError(f"data parallel {name}: the one-rank chunk differs from the plain "
                             f"one in {len(differ)} tensors: {differ[:12]}")
    want = dict(la, allreduce_mean_=per_update * n * N)
    if la["allreduce_mean_"] != 0 or lb != want:
        raise AssertionError(f"data parallel {name}: launches {lb} with data_axis, {la} without")
    return len(a[0]), lb


def collective_ms(t, calls=50):
    """8a: ms a call of `allreduce_mean_` on `t`'s one-rank NCCL mesh at
    its autograd steps' sizes (the critic's gradients and loss, the
    actor's and the temperature's with the loss, the discriminator's with
    the loss) and of `allgather_rows` of the update's (256, 2) rows: eager
    (CUDA events around `calls` calls) and replayed (one graph of `calls`
    calls); the replay equal to the eager calls bit for bit."""
    import torch
    from iltpu_torch.parallel import allgather_rows, allreduce_mean_

    loss = [torch.zeros((), device=t.device)]
    cases = {
        "critic": [x.clone() for x in t.sac["c"]] + loss,
        "actor+temperature": [x.clone() for x in t.sac["a"]] + [t.sac["la"].clone()] + loss,
        "discriminator": [x.clone() for x in t.disc_state["p"]] + loss,
        "gather (256, 2)": [torch.randn(256 // t.mesh.world_size, 2, device=t.device)],
    }
    out = {}
    for name, ts in cases.items():
        got = []
        fn = ((lambda: got.append(allgather_rows(ts[0], t.mesh))) if name.startswith("gather")
              else (lambda: allreduce_mean_(ts, t.mesh)))
        start = [x.clone() for x in ts]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up on the capture's stream
            fn()
        torch.cuda.current_stream().wait_stream(side)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        eager_ms = e0.elapsed_time(e1) / calls
        eager = [x.clone() for x in (got[-1:] or ts)]
        for x, y in zip(ts, start):
            x.copy_(y)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
        for x, y in zip(ts, start):
            x.copy_(y)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(eager, got[-1:] or ts)):
            raise AssertionError(f"data parallel {name}: a replayed collective differs from eager")
        nbytes = sum(x.numel() * x.element_size() for x in ts)
        out[f"{name} ({nbytes} bytes)"] = (eager_ms, e0.elapsed_time(e1) / calls)
    return out


def check_data_parallel_world1(dev):
    """8a: NCCL at world size 1. For GAIL on the per-update kernels and on
    the autograd updates, a trainer with data_axis (a one-rank NCCL group)
    and one without, from the same state and generator state: a chunk run
    eagerly, as the host loop's iterations, then a chunk from CUDA graphs,
    as the on-device loop's, each bit for bit (an all-reduce over one rank
    is a copy and the division by 1 exact), with the all-reduces counted;
    a chunk replayed with the all-reduces captured against the same chunk
    eager (`graph_vs_eager`); then ms an update of each, host-paced and
    replayed, with and without data_axis, in turns; and `collective_ms` on
    the autograd path's mesh. Returns ({(path, mode, 1 with data_axis or 0
    without): ms an update}, `collective_ms`'s)."""
    from iltpu_torch.config import load_config
    from iltpu_torch.graphs import ChunkGraphs
    from iltpu_torch.trainer import Trainer

    times = {}
    for name, extra, per_update in DP_PATHS:
        out_dir = os.path.join(REPO, "outputs", "chip_smoke", f"dp_{name}")
        pair = [Trainer(load_config(DP_ARGS + list(extra) + list(dp) + [f"output_dir={out_dir}"]),
                        out_dir=out_dir) for dp in ((), DP)]
        envs = [t.env.reset() for t in pair]
        pair[0].run_chunk(envs[0], 0, 4, 0)  # rows in the ring
        restore(pair[1], envs[1], snapshot(pair[0], envs[0]))
        n, step = 4, 4 * 16
        tensors, launched = same_chunk(f"{name} eager", pair, envs, lambda t: t.run_chunk, step, n,
                                       per_update)
        step += n * 16
        graphs = [ChunkGraphs(t, n) for t in pair]
        same_chunk(f"{name} graphs", pair, envs, lambda t: graphs[pair.index(t)].run, step, n,
                   per_update)
        print(f"data parallel {name}: a one-rank NCCL mesh equals the plain trainer bit for bit "
              f"in {tensors} state tensors, the generator, rewards, dones and aux over a chunk of "
              f"{n} x 16 updates run eagerly and one from CUDA graphs; launches a chunk {launched}")
        step += n * 16
        snap = snapshot(pair[1], envs[1])
        graph_vs_eager(pair[1], envs[1], step, n, f"data parallel {name}")
        restore(pair[1], envs[1], snap)
        for mode, reps in (("host-paced", 1), ("replayed", 3)):
            for i in (0, 1, 1, 0):
                t = pair[i]
                run = t.run_chunk if mode == "host-paced" else graphs[i].run
                times.setdefault((name, mode, i), []).append(
                    timed_chunks(t, run, envs[i], step, n, reps))
        if name == "gail_autograd":
            coll = collective_ms(pair[1])
    return {k: min(v) for k, v in times.items()}, coll


def _dp2_rank(rank, store, out):
    """8b's rank: a gloo group of two ranks on the one card (CUDA tensors,
    staged through the host). Its first chunk (this fresh process's first
    autograd steps) is run twice from the same state: equal bit for bit."""
    import torch
    import torch.distributed as dist
    from iltpu_torch.config import load_config
    from iltpu_torch.parallel import allreduce_mean_, initialize_multihost
    from iltpu_torch.trainer import Trainer

    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    torch.cuda.set_device(0)
    initialize_multihost(f"file://{store}", 2, rank, backend="gloo")
    t, env = dp2_trainer(load_config, Trainer)
    snap = snapshot(t, env)
    t.run_chunk(env, 8, 3, 8)  # this process's first autograd steps
    torch.cuda.synchronize()
    first = {k: v.cpu().clone() for k, v in t.state_tensors().items()}
    restore(t, env, snap)
    allreduce_mean_.launches = 0
    t.run_chunk(env, 8, 3, 8)
    torch.cuda.synchronize()
    state = {k: v.cpu().clone() for k, v in t.state_tensors().items()}
    collectives = allreduce_mean_.launches
    first_differs = [k for k, v in state.items() if not torch.equal(v, first[k])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.run_chunk(env, 32, 4, 8)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 32
    if rank == 0:
        torch.save({"state": state, "ms": ms, "collectives": collectives,
                    "first_differs": first_differs}, out)
    dist.destroy_process_group()


def dp2_trainer(load_config, Trainer):
    """8b's trainer (GAIL autograd, 8 envs, 8 updates an iteration, full
    widths) on the process group's mesh, its ring given one iteration."""
    out_dir = os.path.join(REPO, "outputs", "chip_smoke", "dp2")
    args = [a for a in DP_ARGS if not a.startswith("num_envs")] + ["num_envs=8"]
    t = Trainer(load_config(args + alg_args("GAIL", False) + list(DP) + [f"output_dir={out_dir}"]),
                out_dir=out_dir)
    env = t.env.reset()
    t.run_chunk(env, 0, 1, 0)
    return t, env


def check_data_parallel_two_ranks(dev):
    """8b: two ranks on the one card over gloo with CUDA tensors: GAIL
    autograd for 3 iterations x 8 updates against the same iterations on
    8a's one-rank NCCL mesh, at the chain tolerance, and against the same
    iterations run first in the rank, bit for bit; then ms an update over
    4 more iterations."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as tmp
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    t, env = dp2_trainer(load_config, Trainer)
    t.run_chunk(env, 8, 3, 8)
    torch.cuda.synchronize()
    want = t.state_tensors()
    out = os.path.join(REPO, "outputs", "chip_smoke", "dp2.pt")
    store = tempfile.mkdtemp(prefix="chip_smoke_dp2_")
    t0 = time.time()
    try:
        ranks = tmp.spawn(_dp2_rank, args=(f"{store}/store", out), nprocs=2, join=False)
        while not ranks.join(timeout=5):
            if time.time() - t0 > 240:
                for p in ranks.processes:
                    p.kill()
                raise AssertionError("data parallel 8b: the two ranks did not finish in 240 s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    got = torch.load(out)
    if got["first_differs"]:
        raise AssertionError("data parallel 8b: a process's first chunk differs from the same "
                             f"chunk run again in {got['first_differs'][:12]}")
    if got["collectives"] != 3 * 24:
        raise AssertionError(f"data parallel 8b: {got['collectives']} all-reduces, want 72")
    floats = [k for k, v in want.items() if v.is_floating_point()]
    differ = [k for k, v in want.items() if k not in floats and not torch.equal(got["state"][k].to(dev), v)]
    if sorted(got["state"]) != sorted(want) or differ:
        raise AssertionError(f"data parallel 8b: the ring's counters differ: {differ}")
    err = compare("data parallel 8b", [(k, got["state"][k].to(dev)) for k in floats],
                  [(k, want[k]) for k in floats], TOL_CHAIN)
    print(f"data parallel 8b: two gloo ranks on one card (CUDA tensors through the host), GAIL "
          f"autograd 3 x 8 updates against the one-rank NCCL mesh: max_abs_err {err[0]:.3g}, "
          f"max_rel_err {err[1]:.3g} over {len(want)} state tensors, 72 all-reduces; each "
          f"rank's first chunk equal bit for bit to the same chunk run again; "
          f"{got['ms']:.3f} ms an update (one card staging through the host, not a scaling "
          f"figure); {time.time() - t0:.1f} s with the ranks' start")
    return got["ms"]


# Phase 9: the tensor-parallel layout (`parallel.shard_params`) over phase 8's
# mesh, at its size; (name, arguments, all-reduces an update).
SHARD = ("parallel.shard_params=true",)
TP_PATHS = (
    ("gail_kernels", (), 0),
    ("gail_autograd", tuple(alg_args("GAIL", False)), 3),
    # under a mesh update_block=4 runs per update, as iltpu's (it refuses the fused scan
    # there); the K-blocked branch of update_unit is driven directly below
    ("update_block4", ("training.update_block=4",), 0),
)


def state_bytes(t):
    """The bytes a rank keeps resident as state: every `state_tensors()`
    entry (under the layout, the blocks) and the expert ring."""
    from iltpu_torch.data.replay import COLUMNS

    ts = list(t.state_tensors().values()) + [getattr(t.expert, k) for k in COLUMNS]
    return sum(x.numel() * x.element_size() for x in ts)


def whole_state(t):
    """Every state tensor whole, on the CPU: under the layout its leaves
    gathered (a collective)."""
    import contextlib

    with t.layout.work(write=False) if t.layout else contextlib.nullcontext():
        ts = dict(t.state_tensors())
        if t.layout:
            ts.update({n: x.whole for n, x in t.layout.leaves.items() if x.ring is None})
        return {k: v.to("cpu", copy=True) for k, v in ts.items()}


def same_chunk_layout(name, pair, envs, run, step, n, per_update):
    """One chunk of `run` on the data-parallel trainer and on the one under
    the layout, from the same state and generator state: equal bit for bit
    (at world 1 a block is the whole leaf), the same kernel launches and
    all-reduces; returns the layout's all-gathers an update."""
    import torch

    N, got = pair[0].cfg.num_envs, []
    for t, env in zip(pair, envs):
        c0 = counts()
        chunk = run(t)(env, step, n, N)
        torch.cuda.synchronize()
        got.append((snapshot(t, env), chunk, {k: v - c0[k] for k, v in counts().items()}))
    (a, ca, la), (b, cb, lb) = got
    differ = [k for k, v in a[0].items() if not torch.equal(v, b[0][k])]
    if sorted(a[0]) != sorted(b[0]) or not torch.equal(a[1], b[1]):
        differ.append("names or generator")
    differ += [w for w, x, y in (("rewards", ca[0], cb[0]), ("dones", ca[1], cb[1])) if not torch.equal(x, y)]
    differ += [f"aux {k}" for k, v in ca[2].items() if not torch.equal(v, cb[2][k])]
    if differ:
        raise AssertionError(f"layout {name}: the chunk under shard_params differs from the data-"
                             f"parallel one in {len(differ)} tensors: {differ[:12]}")
    gathers = lb.pop("allgather_blocks")
    if la != dict(lb, allgather_blocks=0) or la["allreduce_mean_"] != per_update * n * N:
        raise AssertionError(f"layout {name}: launches {lb} under shard_params, {la} without")
    # an act and the sampled rows' gather an iteration, one an update
    if gathers != n * (2 + N):
        raise AssertionError(f"layout {name}: {gathers} all-gathers a chunk, want {n * (2 + N)}")
    return len(a[0]), gathers / (n * N)


def kblock_units_layout(pair, envs, step):
    """The K-blocked branch of `update_unit` under the layout: one front of
    16 updates, then 4 units of 4 on each trainer: equal bit for bit, one
    all-gather a unit."""
    import torch

    got = []
    for t, env in zip(pair, envs):
        _, front = t.act_and_step(env, step, 16)
        c0 = counts()
        for c in range(0, 16, 4):
            t.update_unit(step, *({k: v[c:c + 4] for k, v in d.items()} for d in front[1:]))
        torch.cuda.synchronize()
        got.append((snapshot(t, env), {k: v - c0[k] for k, v in counts().items()}))
    (a, la), (b, lb) = got
    differ = [k for k, v in a[0].items() if not torch.equal(v, b[0][k])]
    if differ or la != launches_of(kblock_update=4) or lb != launches_of(kblock_update=4,
                                                                         allgather_blocks=4):
        raise AssertionError(f"layout update_block4: K-blocked units differ in {differ[:12]}, "
                             f"launches {lb} under shard_params, {la} without")
    return len(a[0])


def check_layout_world1(dev):
    """9a: NCCL at world size 1, where the rule shards every leaf it applies
    to into one whole block, so gather, compute and keep all run. On each
    path, a trainer with data_axis and one with data_axis and
    shard_params, from the same state and generator state: a chunk run
    eagerly (the host loop's iterations), then one from CUDA graphs (the
    on-device loop's, the gathers and block copies captured), each bit for
    bit, with the all-gathers counted; on update_block4 the K-blocked
    branch too; then ms an update of each, host-paced and replayed, in
    turns. Returns ({(path, mode, 1 under the layout or 0): ms an update},
    {path: all-gathers an update}, the resident state bytes (data
    parallel, the layout) at world 1)."""
    from iltpu_torch.config import load_config
    from iltpu_torch.graphs import ChunkGraphs
    from iltpu_torch.trainer import Trainer

    times, gathers = {}, {}
    for name, extra, per_update in TP_PATHS:
        out_dir = os.path.join(REPO, "outputs", "chip_smoke", f"tp_{name}")
        pair = [Trainer(load_config(DP_ARGS + list(extra) + list(DP) + list(sp)
                                    + [f"output_dir={out_dir}"]), out_dir=out_dir)
                for sp in ((), SHARD)]
        envs = [t.env.reset() for t in pair]
        pair[0].run_chunk(envs[0], 0, 4, 0)  # rows in the ring
        restore(pair[1], envs[1], snapshot(pair[0], envs[0]))
        n, step = 4, 4 * 16
        tensors, gathers[name] = same_chunk_layout(f"{name} eager", pair, envs,
                                                   lambda t: t.run_chunk, step, n, per_update)
        step += n * 16
        graphs = [ChunkGraphs(t, n) for t in pair]
        same_chunk_layout(f"{name} graphs", pair, envs, lambda t: graphs[pair.index(t)].run, step,
                          n, per_update)
        step += n * 16
        extra_check = ""
        if name == "update_block4":
            kblock_units_layout(pair, envs, step)
            step += 16
            extra_check = "; the K-blocked branch (4 units of 4) too, one all-gather a unit"
        print(f"layout {name}: shard_params on a one-rank NCCL mesh equals data_axis alone bit for "
              f"bit in {tensors} state tensors, the generator, rewards, dones and aux over a chunk "
              f"of {n} x 16 updates run eagerly and one from CUDA graphs{extra_check}; "
              f"{gathers[name]:.4f} all-gathers an update (one a unit, an act's and the sampled "
              f"rows' an iteration)")
        for mode, reps in (("host-paced", 1), ("replayed", 3)):
            for i in (0, 1, 1, 0):
                t = pair[i]
                run = t.run_chunk if mode == "host-paced" else graphs[i].run
                times.setdefault((name, mode, i), []).append(
                    timed_chunks(t, run, envs[i], step, n, reps))
        resident = (state_bytes(pair[0]), state_bytes(pair[1]))
    return {k: min(v) for k, v in times.items()}, gathers, resident


TP2_PATHS = (("gail_autograd", tuple(alg_args("GAIL", False))), ("gail_kernels", ()))


def tp2_trainer(load_config, Trainer, extra):
    """9b's trainer: 8b's (8 envs, 8 updates an iteration, full widths) on
    `extra`'s path under the layout, its ring given one iteration."""
    out_dir = os.path.join(REPO, "outputs", "chip_smoke", "tp2")
    args = [a for a in DP_ARGS if not a.startswith("num_envs")] + ["num_envs=8"]
    t = Trainer(load_config(args + list(extra) + list(DP) + list(SHARD)
                            + [f"output_dir={out_dir}"]), out_dir=out_dir)
    env = t.env.reset()
    t.run_chunk(env, 0, 1, 0)
    return t, env


def _tp2_rank(rank, store, out):
    """9b's rank: a gloo group of two ranks on the one card under the layout.
    On each path: 3 iterations x 8 updates, then the state of record, the
    whole state (gathered) and the resident bytes; ms an update over 4 more
    iterations; the peak memory."""
    import torch
    import torch.distributed as dist
    from iltpu_torch.config import load_config
    from iltpu_torch.parallel import allgather_blocks, allreduce_mean_, initialize_multihost
    from iltpu_torch.trainer import Trainer

    os.environ["LOCAL_RANK"] = "0"  # both ranks on the one card
    torch.cuda.set_device(0)
    initialize_multihost(f"file://{store}", 2, rank, backend="gloo")
    res = {}
    for path, extra in TP2_PATHS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t, env = tp2_trainer(load_config, Trainer, extra)
        allgather_blocks.launches = allreduce_mean_.launches = 0
        t.run_chunk(env, 8, 3, 8)
        torch.cuda.synchronize()
        leaves = t.layout.leaves
        res[path] = {
            "gathers": allgather_blocks.launches, "reduces": allreduce_mean_.launches,
            "record": {k: v.to("cpu", copy=True) for k, v in t.state_tensors().items()},
            "cols": {n: (x.cols.start, x.cols.stop) for n, x in leaves.items()},
            "whole": whole_state(t), "resident": state_bytes(t)}
        t0 = time.perf_counter()
        t.run_chunk(env, 32, 4, 8)
        torch.cuda.synchronize()
        res[path].update(ms=1e3 * (time.perf_counter() - t0) / 32,
                         peak=torch.cuda.max_memory_allocated())
        del t, env
    torch.save(res, f"{out}.rank{rank}")
    dist.destroy_process_group()


def check_layout_two_ranks(dev):
    """9b: two ranks on the one card over gloo with CUDA tensors, under the
    layout: GAIL autograd (3 x 8 updates) against the same iterations on a
    one-rank NCCL mesh under the layout at the chain tolerance, and GAIL on
    the kernels (replicated, so) bit for bit; each rank's blocks
    concatenated equal the gathered whole state bit for bit; the
    all-gathers and all-reduces counted; the resident state bytes at world
    1 and 2 and each rank's peak memory."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as tmp
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    want, one = {}, {}
    for path, extra in TP2_PATHS:
        t, env = tp2_trainer(load_config, Trainer, extra)
        t.run_chunk(env, 8, 3, 8)
        torch.cuda.synchronize()
        want[path], one[path] = whole_state(t), state_bytes(t)
    out = os.path.join(REPO, "outputs", "chip_smoke", "tp2.pt")
    store = tempfile.mkdtemp(prefix="chip_smoke_tp2_")
    t0 = time.time()
    try:
        ranks = tmp.spawn(_tp2_rank, args=(f"{store}/store", out), nprocs=2, join=False)
        while not ranks.join(timeout=5):
            if time.time() - t0 > 240:
                for p in ranks.processes:
                    p.kill()
                raise AssertionError("layout 9b: the two ranks did not finish in 240 s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    got = [torch.load(f"{out}.rank{r}") for r in range(2)]
    summary = {}
    for path, _ in TP2_PATHS:
        w, whole = want[path], got[0][path]["whole"]
        if sorted(whole) != sorted(w) or sorted(got[1][path]["whole"]) != sorted(w):
            raise AssertionError(f"layout 9b {path}: the state's names differ")
        for r in range(2):
            differ = [k for k, v in got[r][path]["whole"].items() if not torch.equal(v, whole[k])]
            if differ:
                raise AssertionError(f"layout 9b {path}: rank {r}'s whole state differs from rank "
                                     f"0's in {differ[:12]}")
        cols = got[0][path]["cols"]
        for k in cols:
            if k.startswith("expert."):
                continue
            cat = torch.cat([got[r][path]["record"][k] for r in range(2)], -1)
            if not torch.equal(cat, whole[k]):
                raise AssertionError(f"layout 9b {path}: the ranks' blocks of {k} do not "
                                     "concatenate to the whole leaf")
        floats = [k for k, v in w.items() if v.is_floating_point()]
        ints = [k for k in w if k not in floats and not torch.equal(whole[k], w[k])]
        if ints:
            raise AssertionError(f"layout 9b {path}: the ring's counters differ: {ints}")
        if path == "gail_kernels":
            differ = [k for k in floats if not torch.equal(whole[k], w[k])]
            if differ:
                raise AssertionError(f"layout 9b {path}: two ranks differ from one in {differ[:12]}")
            err = (0.0, 0.0)
        else:
            err = compare(f"layout 9b {path}", [(k, whole[k].to(dev)) for k in floats],
                          [(k, w[k].to(dev)) for k in floats], TOL_CHAIN)
        g = got[0][path]
        want_reduces = 24 * (3 if path == "gail_autograd" else 0)
        want_gathers = 3 * (2 + 8)  # an act, the sampled rows and 8 units an iteration
        if (g["gathers"], g["reduces"]) != (want_gathers, want_reduces):
            raise AssertionError(f"layout 9b {path}: {g['gathers']} all-gathers and {g['reduces']} "
                                 f"all-reduces, want {want_gathers} and {want_reduces}")
        summary[path] = (err, g["ms"], one[path], [got[r][path]["resident"] for r in range(2)],
                         [got[r][path]["peak"] for r in range(2)], sorted(cols))
        print(f"layout 9b {path}: two gloo ranks on one card under shard_params against one rank "
              f"(NCCL, under the layout): max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g} over "
              f"{len(w)} state tensors{' (bit for bit: the kernels run replicated)' if not err[0] else ''}; "
              f"every rank's blocks concatenate to the whole leaves bit for bit, in {len(cols)} "
              f"sharded leaves; {g['gathers']} all-gathers, {g['reduces']} all-reduces; resident "
              f"state {one[path]} bytes at world 1, {summary[path][3]} a rank at world 2; peak "
              f"memory {summary[path][4]} bytes a rank; {g['ms']:.3f} ms an update (one card "
              f"staging through the host, not a scaling figure); {time.time() - t0:.1f} s")
    return summary


def host_acting_costs(dev, N=512, n=50):
    """5f: what host acting pays an iteration at 512 envs, in ms of the
    host's clock: the observations' (and rewards' and dones') copy to the
    host and the actions' copy back through pinned buffers, each waited
    for, and the numpy forward of the actor (width 256, pointmass shapes)
    that samples the actions; the parameter sync as well."""
    import numpy as np
    import torch
    from iltpu_torch.models import SoftActor
    from iltpu_torch.models.host_inference import HostActor, HostReads

    actor = SoftActor(5, 2, 256, 2, device=dev)
    actor.reset_parameters(torch.Generator(device=dev).manual_seed(3))
    reads, host = HostReads(dev), HostActor(actor, actor.net.leaves())
    obs, rew, done = torch.randn(N, 5, device=dev), torch.randn(N, device=dev), torch.zeros(
        N, dtype=torch.bool, device=dev)
    rng = np.random.default_rng(0)
    actions = host.sample(obs.cpu().numpy(), rng)

    def timed(fn):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    d2h = timed(lambda: reads.wait(reads.start([rew, done, obs])))
    h2d = timed(lambda: (reads.to_device(actions), torch.cuda.synchronize()))
    obs_h = obs.cpu().numpy()
    forward = timed(lambda: host.sample(obs_h, rng))
    sync = timed(lambda: (host.start_sync(actor.net.leaves()), host.refresh()))
    print(f"host acting at {N} envs, ms an iteration on the host's clock: obs, rewards and dones "
          f"to the host {d2h:.4f}, actions to the card {h2d:.4f}, numpy actor forward + sample "
          f"{forward:.4f}, parameter sync (copy, wait, numpy copies) {sync:.4f}")
    return d2h, h2d, forward, sync


# Phase 10: the MuJoCo envs on the C++ stepper built against third_party/mujoco.
HOPPER = ("env=hopper", "env_backend=native",
          f"expert_data.source={os.path.join(REPO, 'data', 'hopper_expert.npz')}")


def native_env(name):
    """The env args of `name` on the stepper, with its expert data."""
    return (f"env={name}", "env_backend=native",
            f"expert_data.source={os.path.join(REPO, 'data', name + '_expert.npz')}")


def check_stepper(dev, N=512, steps=1000):
    """10a: the stepper built from the repo, libmujoco mapped from the copy
    decoded from the tree's third_party/, 512 hopper envs x 1,000 steps of seeded actions twice
    from one seed, every output (auto-resets and the absorbing bit
    included) bit-equal; the host ms of one step, and of one step through
    the trainer's adapter (`HostEnv`: the actions' copy to the host, the C
    call, the packed block's copy to the card), with the C call inside it
    and each of the two copies alone. Returns (step ms, adapter ms, the C
    call's ms inside the adapter, actions-to-host ms, block-to-card ms)."""
    import hashlib

    import numpy as np
    import torch
    from iltpu_torch.envs import native
    from iltpu_torch.envs.vecenv import HostEnv

    t0 = time.time()
    lib = native.ensure_built()
    built_s = time.time() - t0
    env = native.NativeVecEnv("hopper", N, seed=17)
    with open("/proc/self/maps") as f:
        maps = sorted({line.split()[-1] for line in f if "libmujoco" in line})
    if maps != [native.LIBMUJOCO] or not native.LIBMUJOCO.startswith(REPO + os.sep):
        raise AssertionError(f"stepper: libmujoco mapped from {maps}, not from "
                             f"{native.LIBMUJOCO} in the tree")
    with open(maps[0], "rb") as f:
        mapped_sha = hashlib.sha256(f.read()).hexdigest()
    if mapped_sha != native.LIBMUJOCO_SHA256:
        raise AssertionError(f"stepper: the mapped libmujoco has sha256 {mapped_sha}, "
                             f"not {native.LIBMUJOCO_SHA256}")
    print(f"stepper: {os.path.relpath(lib, REPO)} built in {built_s:.2f} s with g++; libmujoco "
          f"mapped from {maps}, decoded from "
          f"{os.path.relpath(native.LIBMUJOCO_PACKED, REPO)}, sha256 {mapped_sha}")

    def run():
        h, times, ends, terms = hashlib.sha256(), [], 0, 0
        h.update(env.reset(17).tobytes())
        rng = np.random.default_rng(3)
        for _ in range(steps):
            a = rng.uniform(-1, 1, (N, env.action_size)).astype(np.float32)
            t = time.perf_counter()
            out = env.step(a)
            times.append(1e3 * (time.perf_counter() - t))
            for x in out:
                h.update(x.tobytes())
            ends += int((out[2] + out[3]).sum())
            terms += int(out[2].sum())
        return h.hexdigest(), ends, terms, times

    first, second = run(), run()
    if first[:3] != second[:3]:
        raise AssertionError(f"stepper: two runs from one seed differ: {first[:3]} vs {second[:3]}")
    if first[2] == 0:
        raise AssertionError("stepper: no episode ended in 1,000 steps: no reset was checked")
    step_ms = float(np.median(first[3] + second[3]))
    env.close()

    adapter = HostEnv(native.NativeVecEnv("hopper", N, seed=17), dev, 17)
    state = adapter.reset()
    g = torch.Generator(device=dev).manual_seed(5)
    inner, c_step = [], adapter.env.step

    def timed_step(a):  # the C call inside the adapter's step, on the host's clock
        t = time.perf_counter()
        out = c_step(a)
        inner.append(1e3 * (time.perf_counter() - t))
        return out

    adapter.env.step = timed_step
    times, d2h, h2d = [], [], []
    block = torch.empty((N, adapter._width), pin_memory=True)
    for _ in range(200):
        a = torch.rand(N, 3, generator=g, device=dev) * 2 - 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        adapter.step(state, a)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()  # each copy alone, waited for
        buf, event = adapter.fetch(a)
        event.synchronize()
        d2h.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        block.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        h2d.append(1e3 * (time.perf_counter() - t))
    adapter.env.step = c_step
    adapter.close()
    adapter_ms, inner_ms = float(np.median(times)), float(np.median(inner))
    d2h_ms, h2d_ms = float(np.median(d2h)), float(np.median(h2d))
    print(f"stepper: {N} hopper envs x {steps} steps twice from one seed: bit-equal (sha256 "
          f"{first[0][:16]}), {first[1]} episode ends ({first[2]} terminal) a run; host ms a step "
          f"{step_ms:.4f} (mean {np.mean(first[3] + second[3]):.4f}); through HostEnv, 200 steps "
          f"(actions to the host, the step, the packed block to the card) {adapter_ms:.4f}, of "
          f"which the C call {inner_ms:.4f} (medians; the rest, {adapter_ms - inner_ms:.4f}, is "
          f"the copies, the packing and the outputs' views); alone: the actions ({N} x 3) to the "
          f"host {d2h_ms:.4f}, the block ({N} x {adapter._width} floats) to the card {h2d_ms:.4f}")
    return step_ms, adapter_ms, inner_ms, d2h_ms, h2d_ms


def native_rows(name, n=4, seed=23):
    """`rows()` of check_against_cpu: each call one step of n envs of the
    stepper under seeded actions, as CPU tensors (obs, actions, rewards,
    next_obs, terminals, timeouts)."""
    import numpy as np
    import torch
    from iltpu_torch.envs.native import NativeVecEnv

    env = NativeVecEnv(name, n, seed=seed)
    obs = [env.reset()]
    rng = np.random.default_rng(seed)

    def rows():
        a = rng.uniform(-1, 1, (n, env.action_size)).astype(np.float32)
        next_obs, r, term, tout, after = env.step(a)
        out = [obs[0], a, r, next_obs, term, tout]
        obs[0] = after
        return [torch.from_numpy(np.array(x)) for x in out]

    return rows


# 10d: the kernels at every shape iltpu's configurations give: the six
# envs' discriminator inputs (S, A; walker2d and halfcheetah share theirs)
# x the sweep's discriminator widths x its batches
# (iltpu/config/conf/search_space.yaml:164-170; tuned.yaml's GAIL@25 width
# 128, GAIL@5 batch 1024).
ENV_INPUTS = (("pendulum", 4, 1), ("pointmass", 5, 2), ("hopper", 12, 3),
              ("walker2d/halfcheetah", 18, 6), ("ant", 112, 8))
DISC_WIDTHS = (32, 64, 128)
BATCHES = (128, 256, 512, 1024)
# the GAIL step's corners where the wide variant runs: (B, S, A, Hd)
WIDE_CORNERS = ((1024, 112, 8, 128), (256, 112, 8, 64), (1024, 18, 6, 128), (1024, 12, 3, 128))


def check_coverage():
    """Every (B, D, Hd) of ENV_INPUTS x DISC_WIDTHS x BATCHES: the GAIL step's
    variant and dynamic shared memory (gail_update.smem_bytes raises where no
    variant takes a shape) and the K-blocked kernel's cooperative grid at
    SAC width 256 (its occupancy query on this card, at least two blocks)."""
    from iltpu_torch.ops import build
    from iltpu_torch.ops import gail_update as gu
    from iltpu_torch.ops import kblock_update as kb

    lib = build.load("kblock_update")
    for env, S, A in ENV_INPUTS:
        D, shapes = S + A, []
        for Hd in DISC_WIDTHS:
            for B in BATCHES:
                smem = gu.smem_bytes(B, D, Hd)
                per_sm, sms, k_smem, k_gail = kb.grid(lib, B, S, A, 256, Hd)
                if per_sm * sms < 2:
                    raise AssertionError(f"kblock_update B={B} D={D} Hd={Hd}: a cooperative grid "
                                         f"of {per_sm * sms} block(s)")
                shapes.append(f"{B}x{Hd} {gu.variant(B, D, Hd)} on {gu.blocks(B, D, Hd)} block(s) "
                              f"(segments, the cluster), {smem} B (K-blocked {per_sm}x{sms} blocks: "
                              f"GAIL {k_gail} / SAC {per_sm * sms - k_gail}, {k_smem} B)")
        print(f"coverage {env} D={D}, batch x width: " + "; ".join(shapes))


def check_route_turns(dev, S=12, A=3):
    """10d: the GAIL step at hopper's (256, 15, 64), the main path's, in both
    variants in turns (tiled, wide, wide, tiled, tiled, wide): each turn's
    errors against the plain version, device, host-paced and host-issue
    times, and each variant's bound."""
    from iltpu_torch import profile_phases
    from iltpu_torch.ops import gail_update as gu

    turns = {}
    for variant in ("tiled", "wide", "wide", "tiled", "tiled", "wide"):
        e, t, (hyper, st, args, mix) = check_gail(S, A, True, dev, variant=variant)
        st = clone(st)
        issued = issue_us(lambda: profile_phases.variant_step(variant, hyper, st, *args, mix))
        turns.setdefault(variant, []).append((e[0], *t, issued))
    bounds = {v: gail_bound_ms(S, A, 256, 64, (hyper, st, args, mix), v) for v in turns}
    print(f"kernel gail_update B=256 S={S} A={A} Hd=64 (D={S + A}), the routed variant "
          f"{gu.variant(256, S + A, 64)}, in turns: " + "; ".join(
              f"{v} max_abs_err {max(x[0] for x in r):.3g}, "
              + " and ".join(f"{x[1]:.4f}" for x in r) + " ms on the device ("
              + " and ".join(f"{x[2]:.4f}" for x in r) + " ms host-paced; issued in "
              + " and ".join(f"{x[4]:.1f}" for x in r) + " us on the host), bound "
              f"{bounds[v][0]:.5f} ms by {bounds[v][1]}" for v, r in turns.items()))


def check_every_shape(dev, results):
    """10d: the coverage sweep; the GAIL step at WIDE_CORNERS, BCE and
    Mixup, and at hopper's (256, 15, 64) in both variants in turns
    (`check_route_turns`); the K-blocked kernel at ant's (256, 120, 64)
    (K = 1, 2, 16 bit-identical to per-update calls, K = 5 against its plain
    version); the row sums at 256 x 256, D 120; PWIL's transport at ant's
    120-feature atoms (PWIL_ANT_CASES); the SAC step at ant's (112, 8) at
    batch 1024; each against its plain version with its times and bound,
    into `results`."""
    import torch
    from iltpu_torch.ops import gail_update as gu

    check_coverage()
    for B, S, A, Hd in WIDE_CORNERS:
        err, times = (0.0, 0.0), None
        for bce in (True, False):
            e, t, case = check_gail(S, A, bce, dev, B=B, Hd=Hd)
            err = worse(err, e)
            if bce:
                times = (*t, *gail_bound_ms(S, A, B, Hd, case))
        results[("gail", f"B={B} D={S + A} Hd={Hd}")] = (err[0], *times)
        print(f"kernel gail_update {gu.variant(B, S + A, Hd)} B={B} S={S} A={A} Hd={Hd} on "
              f"{gu.blocks(B, S + A, Hd)} blocks, {gu.smem_bytes(B, S + A, Hd)} bytes of shared "
              f"memory a block, BCE and Mixup (float64 the arbiter): max_abs_err "
              f"{err[0]:.3g}, max_rel_err {err[1]:.3g}, {timing(times)}")
    check_route_turns(dev)
    check_kblock_configs(112, 8, "ant", dev, results)
    rowsum = check_rowsum(dev, ((256, 256, 120),))
    results[("rowsum", "ant")] = rowsum[("gmmil_witness_reward", 256, 256, 120)]
    pwil = check_pwil(dev, PWIL_ANT_CASES)
    results[("pwil", "ant")] = pwil["ant_run"]
    check_sac_shape(112, 8, "ant B=1024", dev, results, B=1024, cancelling=True)
    torch.cuda.synchronize()


# Phase 11: GAIL, PWIL and GMMIL on ant (D = 120) on their kernels, and GAIL at
# the tuned overlays' widths (discriminator 128, batch 1024) on ant, walker2d
# and hopper; (name, arguments, launches owed).
ANT = (*native_env("ant"), "num_envs=64", "steps=1024", "training.start=256",
       "training.timing_skip_steps=512", "memory.size=10000")
TUNED_WIDTHS = ("imitation.discriminator.hidden_size=128", "training.batch_size=1024")
SMALL_ENVS = ("num_envs=16", "steps=1024", "training.start=256", "training.timing_skip_steps=512",
              "memory.size=10000")
WIDE_RUNS = (
    ("ant_gail", ANT, per_update),
    ("ant_gail_kblock16", (*ANT, "training.update_block=16"), blocked),
    ("ant_gail_wide128_b1024", (*ANT, *TUNED_WIDTHS), per_update),
    ("ant_pwil", (*ANT, *alg_args("PWIL")), pwil_path),
    ("ant_gmmil", (*ANT, *GMMIL_ARGS), gmmil),
    ("walker2d_wide128_b1024", (*native_env("walker2d"), *SMALL_ENVS, *TUNED_WIDTHS), per_update),
    ("hopper_wide128_b1024", (*native_env("hopper"), *SMALL_ENVS, *TUNED_WIDTHS), per_update),
)


# Phase 11's steady env-steps/s when the wide GAIL step was one block on the
# CUDA cores (PERF.md §5), beside which this run's print.
ONE_BLOCK_RATES = {"ant_gail": 999.3, "ant_gail_kblock16": 1361.4, "ant_gail_wide128_b1024": 244.0,
              "ant_pwil": 1813.2, "ant_gmmil": 1479.0, "walker2d_wide128_b1024": 366.5,
              "hopper_wide128_b1024": 381.2}


def check_wide_trainers(dev, rates, pre, smi):
    """Phase 11: WIDE_RUNS through `Trainer.run`, each kernel launched once an
    owed update (the transport once an iteration, the K-blocked kernel once
    per 16); then the first chunk (8 updates) of transition_core on ant's
    stepper rows, card against CPU at 1e-4 / 1e-5, on GAIL per update and
    update_block=4, PWIL and GMMIL; on GAIL per update two more chunks,
    where the card's SAC state must lie at most max(1.0, the CPU's
    distance) x the chain tolerance from the float64 run's (a moment of the
    critic's last layer falls through zero in the second, so its carried
    rounding meets a tolerance that shrank with it). Returns each run's
    launch counts."""
    t11, counted = time.time(), {}
    for name, extra, expect in WIDE_RUNS:
        counted[name], rates[name], pre[name] = run_trainer(name, extra, owed(expect))
    for extra, want in (
        ((), launches_of(sac_update=8, gail_update=8)),
        (("training.update_block=4",), launches_of(kblock_update=2)),
        (tuple(alg_args("PWIL")), launches_of(sac_update=8, pwil_transport=1)),
        (tuple(GMMIL_ARGS), launches_of(sac_update=8, gmmil_witness_reward=8)),
    ):
        err, launched = check_against_cpu(dev, (*native_env("ant"), *extra),
                                          rows=native_rows("ant"), iterations=1,
                                          watched=0 if extra else 2)
        if launched != want:
            raise AssertionError(f"reference ant {extra}: launches {launched} != {want}")
        print(f"reference: transition_core ant {' '.join(extra) or 'GAIL'} (state 112, action 8, "
              f"the stepper's rows) on the card vs the CPU, the first chunk of 8 updates: max_abs_err "
              f"{err[0]:.3g}, max_rel_err {err[1]:.3g}, launches {launched}")
    print("wide shapes, steady env-steps/s (the one-block wide step's): " + ", ".join(
        f"{name} {rates[name]:.1f} ({ONE_BLOCK_RATES[name]})" for name, _, _ in WIDE_RUNS)
          + f" on {smi}; phase 11 took {time.time() - t11:.1f} s")
    return counted


def check_mujoco(dev, results, rates, pre, launches, smi):
    """Phase 10 (10a-10d): adds to `results` the kernels' errors and times
    at the new shapes, to `rates` and `pre` each run's, and to `launches`
    the per-update and K-blocked kernels' counts on the main path (10b,
    pipelined as bench.py runs it, and update_block=16)."""
    def rate(k):
        return f"{rates[k]:.1f}" if k in rates else "not run"

    t10 = time.time()
    step_ms, adapter_ms, inner_ms, d2h_ms, h2d_ms = check_stepper(dev)  # 10a

    main_path = (*HOPPER, "training.start=100")
    for name, extra, expect in (  # 10b, in turns
        ("hopper", (), per_update),
        ("hopper_pipeline", ("training.pipeline=true",), per_update),
        ("hopper_host_acting", ("training.host_acting=true",), per_update),
        ("hopper_kblock16_pipeline", ("training.update_block=16", "training.pipeline=true"),
         blocked),
        ("hopper_pipeline_again", ("training.pipeline=true",), per_update),
        ("hopper_again", (), per_update),
    ):
        counted, rates[name], pre[name] = run_trainer(name, (*main_path, *extra), owed(expect))
        if name == "hopper_pipeline":  # the main path: bench.py's default acting
            launches.update(sac_update=counted["sac_update"], gail_update=counted["gail_update"])
        if name == "hopper_kblock16_pipeline":
            launches["kblock_update"] = counted["kblock_update"]
    err, launched = check_against_cpu(dev, HOPPER, rows=native_rows("hopper"))
    if launched != launches_of(sac_update=24, gail_update=24):
        raise AssertionError(f"reference hopper: launches {launched}")
    print(f"reference: transition_core GAIL hopper (state 12, action 3, the stepper's rows) on the "
          f"card vs the CPU, 3 x 8 updates: max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}, "
          f"launches {launched}")
    small = ("num_envs=16", "steps=1024", "training.start=256", "training.timing_skip_steps=512",
             "memory.size=10000")
    for name, extra, expect in (  # 10c
        ("ant_sac_autograd", (*native_env("ant"), *alg_args("SAC", False), "num_envs=64",
                              "steps=2048", "training.timing_skip_steps=1024",
                              "memory.size=10000"), none),
        ("walker2d", (*native_env("walker2d"), *small), per_update),
        ("halfcheetah", (*native_env("halfcheetah"), *small), per_update),
    ):
        counted, rates[name], pre[name] = run_trainer(name, extra, owed(expect))
    for S, A, where in ((18, 6, "walker2d/halfcheetah"), (112, 8, "ant")):  # 10d
        check_sac_shape(S, A, where, dev, results)
    check_every_shape(dev, results)
    print("MuJoCo envs, steady env-steps/s: hopper GAIL on the kernels at 512 envs: plain "
          f"{rates['hopper']:.1f} and {rates['hopper_again']:.1f}, pipelined "
          f"{rates['hopper_pipeline']:.1f} and {rates['hopper_pipeline_again']:.1f}, host acting "
          f"{rates['hopper_host_acting']:.1f}, update_block=16 pipelined "
          f"{rates['hopper_kblock16_pipeline']:.1f} (pointmass in this call: plain "
          f"{rate('gail')} and {rate('gail_again')}, pipelined "
          f"{rate('gail_pipeline')}, host acting {rate('gail_host_acting')}, "
          f"update_block=16 pipelined {rate('gail_kblock16_pipeline')}); ant SAC autograd "
          f"(64 envs) {rates['ant_sac_autograd']:.1f}, walker2d GAIL (16 envs) "
          f"{rates['walker2d']:.1f}, halfcheetah GAIL (16 envs) {rates['halfcheetah']:.1f}; the "
          f"stepper's host ms a 512-env hopper step {step_ms:.4f}, through HostEnv "
          f"{adapter_ms:.4f} (the C call in it {inner_ms:.4f}; the actions' copy {d2h_ms:.4f}, "
          f"the block's {h2d_ms:.4f}); on {smi}; phase 10 took {time.time() - t10:.1f} s")


def d4rl_fixtures():
    """data/d4rl/fixture.py: the HDF5 fixtures decoded from their committed
    text forms, and formats_latest.hdf5's seeded arrays."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "d4rl_fixture", os.path.join(REPO, "data", "d4rl", "fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def d4rl_fixture():
    """data/d4rl/hopper_expert.hdf5, decoded from its committed text form."""
    return d4rl_fixtures().unpack()


def png_size(path):
    """(width, height) of a PNG whose signature, IHDR and every chunk's CRC
    check out (it must end with IEND)."""
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: no PNG signature")
    p, tags = 8, []
    while p < len(data):
        n = int.from_bytes(data[p:p + 4], "big")
        tag, body = data[p + 4:p + 8], data[p + 8:p + 8 + n]
        if zlib.crc32(tag + body) != int.from_bytes(data[p + 8 + n:p + 12 + n], "big"):
            raise AssertionError(f"{path}: bad CRC in {tag}")
        if not tags:
            if tag != b"IHDR":
                raise AssertionError(f"{path}: first chunk {tag}")
            size = (int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big"))
        tags.append(tag)
        p += 12 + n
    if tags[-1] != b"IEND" or b"IDAT" not in tags:
        raise AssertionError(f"{path}: chunks {tags}")
    return size


PLOTS = ("test_returns", "train_returns", "predicted_rewards", "sac_alpha", "sac_entropy",
         "Q_values")


def check_d4rl_hdf5(rates, pre, smi):
    """Phase 12: (12a) D4RL's HDF5 fixture through the port's reader, equal
    to data/hopper_expert.npz, h5py never imported; (12b) the main path
    (10b's pipelined GAIL on 512 hopper envs) with expert_data.source=hdf5,
    its expert ring bit-equal to the npz run's, each kernel launched once an
    owed update; (12c) the six plots that run wrote, valid 600 x 400 PNGs,
    and the ms of one `_plots` call. Returns 12a's read in ms."""
    import shutil

    from iltpu_torch.data import load_d4rl_hdf5
    from iltpu_torch.data.hdf5 import read_datasets
    from iltpu_torch.data.replay import COLUMNS

    t12 = time.time()
    path = d4rl_fixture()
    t0 = time.perf_counter()
    data = load_d4rl_hdf5(path)
    load_ms = 1e3 * (time.perf_counter() - t0)
    data.update(read_datasets(path, ["rewards"]))
    same_as_npz(data, "12a")
    if "h5py" in sys.modules:
        raise AssertionError("12a: h5py was imported")
    print(f"d4rl hdf5: {path} ({os.path.getsize(path)} bytes, {len(data['observations'])} rows) "
          f"read by load_d4rl_hdf5 in {load_ms:.2f} ms wall, equal to data/hopper_expert.npz "
          f"(floats bit-equal, flags bool), h5py not imported, on {smi}")

    # 12b: 16 iterations of 512 envs (hopper's episodes end from ~16 steps an env on: the
    # train_returns plot), the steady window the last 8, a log each iteration (the update
    # plots), the final evaluation (the test_returns plot) after the window
    hdf5 = ("expert_data.source=hdf5", f"expert_data.path={path}")
    args = (*HOPPER, "training.start=100", "training.pipeline=true", "steps=8192",
            "training.timing_skip_steps=4096", "logging.interval=512")
    shutil.rmtree(os.path.join(REPO, "outputs", "chip_smoke", "hopper_hdf5_pipeline"),
                  ignore_errors=True)  # no plots of an earlier call
    kept = []
    counted, rates["hopper_hdf5_pipeline"], pre["hopper_hdf5_pipeline"] = run_trainer(
        "hopper_hdf5_pipeline", (*args, *hdf5), owed(per_update), keep=kept)
    trainer = kept[0]
    rows = same_expert_ring(trainer, args, "hopper_expert_npz", "12b")
    print(f"d4rl hdf5: GAIL on 512 hopper envs from the HDF5 file, pipelined: expert ring "
          f"({rows} rows, {len(COLUMNS)} columns) bit-equal to the npz trainer's, launches "
          f"{counted} for {trainer.updates_done} owed updates; steady "
          f"{rates['hopper_hdf5_pipeline']:.1f} env-steps/s (10b pipelined in this call: "
          f"{rates['hopper_pipeline']:.1f} and {rates['hopper_pipeline_again']:.1f}; this run logs "
          f"each iteration) on {smi}")

    # 12c
    written = sorted(f for f in os.listdir(trainer.out_dir) if f.endswith(".png"))
    if written != sorted(f"{p}.png" for p in PLOTS):
        raise AssertionError(f"12c: plots written {written}")
    for name in written:
        if png_size(os.path.join(trainer.out_dir, name)) != (600, 400):
            raise AssertionError(f"12c: {name} is not 600 x 400")
    t0 = time.perf_counter()
    trainer._plots()
    plots_ms = 1e3 * (time.perf_counter() - t0)
    for mod in ("matplotlib", "PIL", "h5py"):
        if mod in sys.modules:
            raise AssertionError(f"12c: {mod} was imported")
    m = trainer.metrics
    print(f"d4rl hdf5: the run's six plots valid 600 x 400 PNGs ({', '.join(written)}); one _plots "
          f"call {plots_ms:.2f} ms wall ({len(m['test_steps'])} evaluations, "
          f"{len(m['train_steps'])} episode ends, {len(m['update_steps'])} logged updates); "
          f"on {smi}; phase 12 took {time.time() - t12:.1f} s")
    return load_ms


def same_as_npz(data, phase):
    """`data` (load_d4rl_hdf5's and the rewards) equal to data/hopper_expert.npz:
    the floats bit-equal, the flags bool."""
    import numpy as np

    with np.load(os.path.join(REPO, "data", "hopper_expert.npz")) as npz:
        if sorted(data) != sorted(npz.files):
            raise AssertionError(f"{phase}: keys {sorted(data)} != the npz's {sorted(npz.files)}")
        for k in npz.files:
            flag = k in ("terminals", "timeouts")
            if data[k].dtype != (bool if flag else np.float32) or data[k].shape != npz[k].shape:
                raise AssertionError(f"{phase}: {k} {data[k].dtype} {data[k].shape}")
            same = (np.array_equal(data[k].astype(np.float32), npz[k]) if flag
                    else data[k].tobytes() == npz[k].tobytes())
            if not same:
                raise AssertionError(f"{phase}: {k} differs from the npz's")


def same_expert_ring(trainer, args, name, phase):
    """The expert ring of `trainer` (a run from an HDF5 file) bit-equal to
    that of a trainer built with `args` on the npz; returns its rows."""
    import torch
    from iltpu_torch.config import load_config
    from iltpu_torch.data.replay import COLUMNS
    from iltpu_torch.trainer import Trainer

    out_dir = os.path.join(REPO, "outputs", "chip_smoke", name)
    npz_trainer = Trainer(load_config(TRAINER_ARGS + list(args) + [f"output_dir={out_dir}"]),
                          out_dir=out_dir)
    npz_trainer.env.close()
    for col in COLUMNS:
        a, b = trainer.expert.rows(col), npz_trainer.expert.rows(col)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{phase}: the expert ring's {col} differs from the npz run's")
    return int(trainer.expert.rows("states").shape[0])


def measured(value, unit=""):
    """A number of this call, or "not run" where its phase was not run."""
    return "not run" if value is None else f"{value:.2f}{unit}"


def check_latest_hdf5(rates, pre, read_12a_ms, smi):
    """Phase 15: h5py's newer formats (libver='latest') on the card's
    machine. (15a) hopper_expert_latest.hdf5 (superblock v3, OHDR headers,
    fixed-array chunk indexes) through load_d4rl_hdf5 equal to
    data/hopper_expert.npz, and formats_latest.hdf5 (every structure the
    reader reads) through read_datasets equal to its arrays made again from
    their seed, h5py never imported; (15b) 10b's pipelined main path from
    the latest file: its expert ring bit-equal to the npz run's, each kernel
    launched once an owed update, its steady env-steps/s."""
    from iltpu_torch.data import load_d4rl_hdf5
    from iltpu_torch.data.hdf5 import read_datasets
    from iltpu_torch.data.replay import COLUMNS

    t15 = time.time()
    fixtures = d4rl_fixtures()
    path = fixtures.unpack("hopper_expert_latest.hdf5")
    t0 = time.perf_counter()
    data = load_d4rl_hdf5(path)
    load_ms = 1e3 * (time.perf_counter() - t0)
    data.update(read_datasets(path, ["rewards"]))
    same_as_npz(data, "15a")
    formats = fixtures.unpack("formats_latest.hdf5")
    want = fixtures.formats_arrays()
    t0 = time.perf_counter()
    got = read_datasets(formats, list(want))
    formats_ms = 1e3 * (time.perf_counter() - t0)
    fixtures.same(got, want)
    if "h5py" in sys.modules:
        raise AssertionError("15a: h5py was imported")
    print(f"hdf5 latest (15a): {path} ({os.path.getsize(path)} bytes, {len(data['observations'])} "
          f"rows) read by load_d4rl_hdf5 in {load_ms:.2f} ms wall (12a's earliest-format file: "
          f"{measured(read_12a_ms, ' ms')}), equal to data/hopper_expert.npz (floats bit-equal, flags bool); "
          f"{formats} ({os.path.getsize(formats)} bytes, {len(want)} datasets) read by "
          f"read_datasets in {formats_ms:.2f} ms wall, equal to fixture.formats_arrays() (dtype, "
          f"shape, bytes); h5py not imported; on {smi}")

    # 15b: 10b's main path, pipelined, from the latest file
    args = (*HOPPER, "training.start=100", "training.pipeline=true")
    hdf5 = ("expert_data.source=hdf5", f"expert_data.path={path}")
    kept = []
    counted, rates["hopper_latest_pipeline"], pre["hopper_latest_pipeline"] = run_trainer(
        "hopper_latest_pipeline", (*args, *hdf5), owed(per_update), keep=kept)
    trainer = kept[0]
    rows = same_expert_ring(trainer, args, "hopper_latest_npz", "15b")
    print(f"hdf5 latest (15b): GAIL on 512 hopper envs from the latest-format file, pipelined: "
          f"expert ring ({rows} rows, {len(COLUMNS)} columns) bit-equal to the npz trainer's, "
          f"launches {counted} for {trainer.updates_done} owed updates; steady "
          f"{rates['hopper_latest_pipeline']:.1f} env-steps/s (12b from the earliest-format file: "
          f"{measured(rates.get('hopper_hdf5_pipeline'))}; 10b pipelined: "
          f"{measured(rates.get('hopper_pipeline'))} and "
          f"{measured(rates.get('hopper_pipeline_again'))}) on {smi}; phase 15 took "
          f"{time.time() - t15:.1f} s")


def check_remainder_hdf5(rates, pre, smi):
    """Phase 15c: the last of HDF5 that iltpu's loader reads through h5py,
    on the card's machine. hopper_expert_vds.hdf5 (each key virtual over
    row blocks of the two large fixtures) and hopper_expert_links.hdf5
    (each key an external link into one of them) through load_d4rl_hdf5
    equal to data/hopper_expert.npz; formats_remainder.hdf5 (external raw
    data, an external link, virtual datasets, a deflated root link heap
    with a huge link name, floats of other layouts) through read_datasets
    equal to `fixture.remainder_arrays()`; each read's host ms; h5py never
    imported. Then 10b's pipelined main path from the virtual file for
    2,048 steps: its expert ring bit-equal to the npz run's, each kernel
    launched once an owed update, its steady env-steps/s."""
    from iltpu_torch.data import load_d4rl_hdf5
    from iltpu_torch.data.hdf5 import read_datasets

    t15 = time.time()
    fixtures = d4rl_fixtures()
    reads = []
    for name in ("hopper_expert_vds.hdf5", "hopper_expert_links.hdf5"):
        path = fixtures.unpack(name)
        t0 = time.perf_counter()
        data = load_d4rl_hdf5(path)
        reads.append(f"{name} ({os.path.getsize(path)} bytes) {1e3 * (time.perf_counter() - t0):.2f} ms")
        data.update(read_datasets(path, ["rewards"]))
        same_as_npz(data, "15c")
    formats = fixtures.unpack("formats_remainder.hdf5")
    want = fixtures.remainder_arrays()
    before = os.environ.get("HDF5_EXTFILE_PREFIX")
    os.environ["HDF5_EXTFILE_PREFIX"] = "${ORIGIN}"  # the raw file beside it
    try:
        t0 = time.perf_counter()
        got = read_datasets(formats, list(want))
        formats_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        if before is None:
            del os.environ["HDF5_EXTFILE_PREFIX"]
        else:
            os.environ["HDF5_EXTFILE_PREFIX"] = before
    fixtures.same(got, want)
    if "h5py" in sys.modules:
        raise AssertionError("15c: h5py was imported")
    print(f"hdf5 remainder (15c): load_d4rl_hdf5 of {'; '.join(reads)} host wall, each equal to "
          f"data/hopper_expert.npz (floats bit-equal, flags bool); {formats} "
          f"({os.path.getsize(formats)} bytes, {len(want)} datasets) read by read_datasets in "
          f"{formats_ms:.2f} ms host wall, equal to fixture.remainder_arrays() (dtype, shape, "
          f"bytes); h5py not imported; on {smi}")

    # 10b's main path, pipelined, from the virtual file
    path = fixtures.unpack("hopper_expert_vds.hdf5")
    args = (*HOPPER, "training.start=100", "training.pipeline=true", "steps=2048",
            "training.timing_skip_steps=1024")
    hdf5 = ("expert_data.source=hdf5", f"expert_data.path={path}")
    kept = []
    counted, rates["hopper_vds_pipeline"], pre["hopper_vds_pipeline"] = run_trainer(
        "hopper_vds_pipeline", (*args, *hdf5), owed(per_update), keep=kept)
    trainer = kept[0]
    rows = same_expert_ring(trainer, args, "hopper_vds_npz", "15c")
    print(f"hdf5 remainder (15c): GAIL on 512 hopper envs from the virtual-dataset file, pipelined, "
          f"2,048 steps: expert ring ({rows} rows) bit-equal to the npz trainer's, launches "
          f"{counted} for {trainer.updates_done} owed updates; steady "
          f"{rates['hopper_vds_pipeline']:.1f} env-steps/s (15b from the latest-format file: "
          f"{measured(rates.get('hopper_latest_pipeline'))}) on {smi}; phase 15c took "
          f"{time.time() - t15:.1f} s")


# Phase 7's GAIL runs: phase 5's kernel path at a small size
SMALL_ARGS = [a for a in TRAINER_ARGS if not a.startswith(
    ("num_envs", "steps", "training.start", "training.timing", "memory.size"))] + [
    "num_envs=64", "steps=1024", "training.start=256", "memory.size=10000"]


def kernel_names(*names):
    """The `__global__` functions of each source `csrc/<name>.cu` (the GAIL
    step's: the tiled variants' one-block kernel and the wide variant's
    cluster kernel)."""
    out = {}
    for name in names:
        with open(os.path.join(REPO, "iltpu_torch", "csrc", f"{name}.cu")) as f:
            found = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                               f.read())
        if not found or "__launch_bounds__" in found:
            raise AssertionError(f"{name}.cu: no __global__ function read: {found}")
        out[name] = found
    return out


def check_profiler_window(results):
    """7a: a GAIL run with the per-update kernels at phase 5's width whose
    profiler window covers exactly one host-loop iteration (512 env steps
    and its updates). The Chrome trace must parse, and hold each kernel's
    `__global__` function as many times as that iteration's updates; the
    launch counters the whole run's updates. Prints each kernel's median
    duration in the trace beside phase 3's CUDA-event time."""
    import numpy as np
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    out_dir = os.path.join(REPO, "outputs", "chip_smoke", "profiler")
    trace_dir = os.path.join(out_dir, "trace")
    args = TRAINER_ARGS + ["steps=3072", f"profiling.trace_dir={trace_dir}",
                           "profiling.start_step=2048", "profiling.steps=512",
                           f"output_dir={out_dir}"]
    t = Trainer(load_config(args), out_dir=out_dir)
    reset_counts()
    t0 = time.time()
    score = t.run()
    wall = time.time() - t0
    n = t.updates_done
    if counts() != launches_of(sac_update=n, gail_update=n) or not np.isfinite(score):
        raise AssertionError(f"profiler window: launch counters {counts()} for {n} updates, "
                             f"score {score}")
    w = t.profiler
    N = t.cfg.num_envs
    # the iterations whose top falls inside the window
    in_window = sum(t._updates_owed(s + N) - t._updates_owed(s)
                    for s in range(0, t.cfg.steps, N) if w.start_step <= s < w.stop_step)
    with open(w.path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    line = []
    for name, fns in kernel_names("sac_update", "gail_update").items():
        fn = "|".join(fns)
        durs = [e["dur"] for e in kernels if re.search(rf"\b({fn})\b", e["name"])]
        if len(durs) != in_window:
            raise AssertionError(f"profiler window: {len(durs)} {fn} events in the trace, "
                                 f"{in_window} updates in the window")
        key = "sac" if name == "sac_update" else "gail"
        line.append(f"{name} ({fn}) {len(durs)} events, median {np.median(durs) / 1e3:.4f} ms "
                    f"(phase 3, CUDA events: {results[(key, 'pointmass')][1]:.4f} ms on the device)")
    print(f"profiler window: steps {w.start_step}-{w.stop_step} of a {t.cfg.steps}-step GAIL run "
          f"({n} updates, {wall:.2f} s wall, counters {counts()}), trace "
          f"{os.path.relpath(w.path, REPO)} ({os.path.getsize(w.path)} bytes, {len(events)} "
          f"events, {len(kernels)} kernels): " + "; ".join(line))


def check_multirun():
    """7b: `iltpu_torch.train.main(["-m", "seed=1,2", ...])` on the GAIL
    kernel path at a small size: two job directories with iltpu's outputs,
    `multirun.yaml` read back by the port's reader, launches equal to the
    two schedules' updates. Returns the job directories."""
    import shutil

    import numpy as np
    from iltpu_torch.config import load_config
    from iltpu_torch.config.yaml_subset import loads
    from iltpu_torch.train import main as train_main

    out = os.path.join(REPO, "outputs", "chip_smoke", "multirun")
    shutil.rmtree(out, ignore_errors=True)
    args = SMALL_ARGS + [f"output_dir={out}"]
    reset_counts()
    t0 = time.time()
    scores = train_main(["-m", "seed=1,2", *args])
    wall = time.time() - t0
    launched = counts()
    (root,) = [os.path.join(out, "multirun", d) for d in os.listdir(os.path.join(out, "multirun"))]
    jobs = [os.path.join(root, str(i)) for i in range(2)]
    for d in jobs:
        missing = [x for x in ("config.yaml", "metrics.pkl", "agent", "discriminator")
                   if not os.path.exists(os.path.join(d, x))]
        if missing:
            raise AssertionError(f"multirun: {d} lacks {missing}")
    with open(os.path.join(root, "multirun.yaml")) as f:
        record = loads(f.read())
    want_jobs = [" ".join([f"seed={s}", *args]) for s in (1, 2)]
    if record != {"jobs": want_jobs, "scores": scores} or not np.isfinite(scores).all():
        raise AssertionError(f"multirun: multirun.yaml {record} against scores {scores}")
    with open(os.path.join(jobs[1], "config.yaml")) as f:
        if loads(f.read()) != dict(load_config(["seed=2", *args])):
            raise AssertionError("multirun: config.yaml is not the job's resolved config")
    n = schedule(load_config(args), 1)[1]
    if launched != launches_of(sac_update=2 * n, gail_update=2 * n):
        raise AssertionError(f"multirun: launch counters {launched} != 2 x {n} updates")
    print(f"multirun: 2 jobs (seed=1,2) in {wall:.2f} s wall, scores {scores}, launches "
          f"{launched} (2 x {n} updates), {os.path.relpath(root, REPO)}")
    return jobs


TRIAL_STEPS = 1280  # 7c: past the search space's training.start=1000 (281 updates an env)


def _counted_run_one(packed):
    """`train_all._run_one` in a forkserver worker, its launch counts
    written to `<env dir>/launches.json` for 7c (a worker's counters are its
    own): 7c puts it in `_run_one`'s place in the parent, and the worker
    unpickles it from this script, where `train_all` is not patched."""
    from iltpu_torch import train_all

    reset_counts()
    score = train_all._run_one(packed)
    env, _, out_dir = packed
    with open(os.path.join(out_dir, env, "launches.json"), "w") as f:
        json.dump(counts(), f)
    return score


def check_train_all():
    """7c: `iltpu_torch.train_all.main([... --envs pointmass,pendulum --sweep
    4 --sobol 2])` without --serial: each trial two forkserver workers on
    the card at once, each with its own CUDA context. The GAIL search
    space sets discriminator depths, activations and losses that the GAIL
    kernel refuses (iltpu's ValueError), so the trials run the SAC kernel
    and the autograd discriminator step. Each trial takes training.start
    from the search space (1000 or 10000): at 1,280 steps on 64 envs a
    trial that drew 1000 runs 281 updates an env, one that drew 10000
    none. Each worker's launches must be its schedule's (the SAC kernel
    once an update, nothing else), and some trial must train. iltpu's
    optimiser fits its GP only after three told trials: trials 0-2 are
    Sobol's, 3 GP-EI's. A worker's exception propagates through pool.map
    and fails the phase."""
    import contextlib
    import io
    import shutil

    import numpy as np
    from iltpu_torch import train_all
    from iltpu_torch.analysis import load_metrics
    from iltpu_torch.config import load_config

    work = os.path.join(REPO, "outputs", "chip_smoke", "train_all")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    overrides = [a for a in SMALL_ARGS if not a.startswith(("training.", "steps"))] + [
        "training.sac_pallas=true", f"steps={TRIAL_STEPS}"]
    args = overrides + ["--envs", "pointmass,pendulum", "--sweep", "4", "--sobol", "2"]
    here, printed, run_one = os.getcwd(), io.StringIO(), train_all._run_one
    os.chdir(work)
    train_all._run_one = _counted_run_one
    try:
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            best = train_all.main(args)
        wall = time.time() - t0
    finally:
        train_all._run_one = run_one
        os.chdir(here)
    with open(os.path.join(work, "outputs", "all_GAIL", "sweep.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    methods = [r["method"] for r in rows]
    if methods != ["sobol"] * 3 + ["gp-ei"]:
        raise AssertionError(f"train_all: trials {methods}")
    trained, updates = [], []  # a trial's slower worker's seconds in Trainer.run; its updates an env
    for r in rows:
        if (sorted(r["per_env"]) != ["pendulum", "pointmass"] or r["min_score"] != min(r["per_env"].values())
                or not np.isfinite(list(r["per_env"].values())).all()):
            raise AssertionError(f"train_all: trial {r}")
        trial_dir = os.path.join(work, "outputs", "all_GAIL", f"trial_{r['trial']:03d}")
        trained.append(max(load_metrics(os.path.join(trial_dir, env))["training_time"]
                           for env in r["per_env"]))
        updates.append([])
        for env in r["per_env"]:
            cfg = load_config(overrides + [f"{k}={v}" for k, v in r["params"].items()] + [f"env={env}"])
            n = sum(schedule(cfg, 1))
            with open(os.path.join(trial_dir, env, "launches.json")) as f:
                launched = json.load(f)
            if launched != launches_of(sac_update=n):
                raise AssertionError(f"train_all: trial {r['trial']} {env} (training.start "
                                     f"{cfg.training.start}) launched {launched}, {n} updates owed")
            updates[-1].append(n)
    if not any(map(any, updates)):
        raise AssertionError(f"train_all: no trial trained (training.start "
                             f"{[r['params']['training.start'] for r in rows]})")
    last = json.loads(printed.getvalue().strip().splitlines()[-1])
    top = max(rows, key=lambda r: r["min_score"])
    if last["best_trial"] != top["trial"] or last["min_score"] != best or best != top["min_score"]:
        raise AssertionError(f"train_all: best-trial line {last} against {rows}")
    print(f"train_all: a 4-trial sweep, {TRIAL_STEPS} steps a trial, 2 concurrent forkserver workers "
          f"a trial, in {wall:.2f} s wall ({wall / len(rows):.2f} s a trial; the slower worker's "
          f"training loop {[round(x, 2) for x in trained]} s): training.start "
          f"{[r['params']['training.start'] for r in rows]}, SAC kernel launches {updates} "
          f"(each worker's, its env's updates), methods {methods}, min scores "
          f"{[r['min_score'] for r in rows]}; best-trial line {json.dumps(last)[:160]}...")


def check_aggregation(jobs):
    """7d: `collect_seed_sweep` over 7b's two job directories, then the IQM
    of the final evaluation and its stratified bootstrap CI (2,000 reps)."""
    import numpy as np
    from iltpu_torch.analysis import collect_seed_sweep, iqm, stratified_bootstrap_ci

    steps, tensor, _ = collect_seed_sweep("", "GAIL", ["pointmass"],
                                          run_dirs_by_env={"pointmass": jobs})
    final = tensor[..., -1]
    point, lo, hi = stratified_bootstrap_ci(final, iqm, reps=2000)
    if tensor.shape[:2] != (2, 1) or not (np.isfinite([point, lo, hi]).all() and lo <= point <= hi):
        raise AssertionError(f"aggregation: tensor {tensor.shape}, IQM {point} CI [{lo}, {hi}]")
    print(f"aggregation: 2 seeds x 1 env at steps {list(steps)}: IQM {point:.4f}, 95% CI "
          f"[{lo:.4f}, {hi:.4f}] (stratified bootstrap, 2,000 reps)")
    return point, lo, hi


def report_out(name):
    """A fresh directory for phase 13's `name` under outputs/chip_smoke/reports."""
    import shutil

    d = os.path.join(REPO, "outputs", "chip_smoke", "reports", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def check_seed_sweep_report(jobs, aggregation, smi):
    """13a: `python -m iltpu_torch.analysis.seed_sweep_report` on 7b's two
    jobs, linked into the `<ALG>_<env>/<run>` layout that `--root` globs:
    its results 7d's IQM and CI at the same 2,000 reps, its figure a valid
    PNG of 960 x 420 (one env panel and the aggregate, 4 x 3.5 in each at
    120 dpi)."""
    from iltpu_torch.analysis import seed_sweep_report

    root = report_out("seed_sweep")
    os.makedirs(os.path.join(root, "GAIL_pointmass"))
    for i, d in enumerate(jobs):
        os.symlink(d, os.path.join(root, "GAIL_pointmass", str(i)))
    png = os.path.join(root, "sample_efficiency.png")
    t0 = time.time()
    results = seed_sweep_report.main(["--root", root, "--algorithms", "GAIL", "--envs", "pointmass",
                                      "--reps", "2000", "--out", png])
    wall_ms = 1e3 * (time.time() - t0)
    r = results["GAIL"]
    if (r["iqm"], r["ci_lo"], r["ci_hi"]) != aggregation or (r["seeds"], r["envs"]) != (2, 1):
        raise AssertionError(f"seed-sweep report: {r} against 7d's IQM and CI {aggregation}")
    if png_size(png) != (960, 420):
        raise AssertionError(f"seed-sweep report: {png} is {png_size(png)}, not 960 x 420")
    print(f"seed-sweep report (13a): 7b's 2 seeds, IQM {r['iqm']:.4f} [{r['ci_lo']:.4f}, "
          f"{r['ci_hi']:.4f}] = 7d's, {r['evals']} evals, a 960 x 420 PNG, {wall_ms:.2f} ms wall on "
          f"the host; on {smi}")


def check_hp_opt_report(smi):
    """13b: `python -m iltpu_torch.analysis.hp_opt_report` on 7c's
    `sweep.jsonl`: the table's rows in descending `min_score`, every trial
    once, its figure a valid PNG of iltpu's size for the sweep's parameters."""
    import contextlib
    import io
    import math

    from iltpu_torch.analysis import hp_opt_report

    sweep = os.path.join(REPO, "outputs", "chip_smoke", "train_all", "outputs", "all_GAIL", "sweep.jsonl")
    png = os.path.join(report_out("hp_opt"), "hp_opt.png")
    printed = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        columns, ranked = hp_opt_report.main([sweep, "--out", png])
    wall_ms = 1e3 * (time.time() - t0)
    with open(sweep) as f:
        trials = sorted(json.loads(line)["trial"] for line in f)
    scores = [r["min_score"] for r in ranked]
    shown = [int(line.split()[0]) for line in printed.getvalue().splitlines()[1:1 + len(ranked)]]
    if (scores != sorted(scores, reverse=True) or sorted(r["trial"] for r in ranked) != trials
            or shown != [r["trial"] for r in ranked] or columns[:3] != ["trial", "min_score", "method"]):
        raise AssertionError(f"hp-opt report: columns {columns}, rows {ranked}, printed "
                             f"{printed.getvalue()}")
    n = sum(c.startswith("param:") for c in columns)
    cols = min(n, 4)
    size = (round(3.5 * cols * 120), round(3 * (math.ceil(n / cols) + 1) * 120))
    if png_size(png) != size:
        raise AssertionError(f"hp-opt report: {png} is {png_size(png)}, not {size}")
    print(f"hp-opt report (13b): 7c's {len(ranked)} trials x {n} parameters, min scores "
          f"{[round(x, 4) for x in scores]} in order, a {size[0]} x {size[1]} PNG, {wall_ms:.2f} ms "
          f"wall on the host; on {smi}")


def check_validate_learning(smi):
    """13c: `python -m iltpu_torch.validate_learning` on the card into a
    directory of its own: GAIL on hopper, tuned, hopper_expert_v2, min_alpha
    0.05, 256 envs on the C++ stepper, seeds 1 and 2 of 20,480 steps each
    with an evaluation of 5 episodes every 10,240: the SAC and GAIL kernels
    launched once an owed update, each row's eval curve 2 finite points;
    then the seed-sweep report on the rows it wrote, its numbers those
    recomputed from the rows."""
    import shutil

    import numpy as np
    import iltpu_torch.validate_learning as vl
    from iltpu_torch.analysis import iqm, seed_sweep_report, stratified_bootstrap_ci
    from iltpu_torch.config import load_config

    root = report_out("validation")
    os.makedirs(os.path.join(root, "data"))
    shutil.copy(os.path.join(REPO, "data", "hopper_expert_v2.npz"), os.path.join(root, "data"))
    vl.ROOT = root
    vl.RESULTS_JSONL, vl.RESULTS_MD = (os.path.join(root, "RESULTS_TORCH.jsonl"),
                                       os.path.join(root, "RESULTS_TORCH.md"))
    steps, extra = 20480, "reinforcement.min_alpha=0.05"
    args = ["--algorithms", "GAIL", "--envs", "hopper", "--steps", str(steps), "--trajectories", "10",
            "--tuned", "--dataset-suffix", "_v2", "--extra", extra, "--eval-interval", "10240",
            "--eval-episodes", "5"]
    cfg = load_config(["algorithm=GAIL", "env=hopper", f"steps={steps}", "num_envs=256",
                       "imitation.trajectories=10"], use_tuned=True)
    n = sum(schedule(cfg, 1))
    walls = []
    for seed in (1, 2):
        reset_counts()
        t0 = time.time()
        vl.main(args + ["--seed", str(seed)])
        walls.append(time.time() - t0)
        if counts() != launches_of(sac_update=n, gail_update=n):
            raise AssertionError(f"validate_learning seed {seed}: launches {counts()} != {n} updates")
    with open(vl.RESULTS_JSONL) as f:
        rows = sorted((json.loads(line) for line in f), key=lambda r: r["seed"])
    if [r["seed"] for r in rows] != [1, 2] or not all(
            len(r["eval_curve"]) == 2 and np.isfinite(r["eval_curve"]).all() for r in rows):
        raise AssertionError(f"validate_learning: rows {rows}")
    png = os.path.join(root, "sample_efficiency.png")
    t0 = time.time()
    results = seed_sweep_report.main(["--from-results", vl.RESULTS_JSONL, "--algorithms", "GAIL",
                                      "--envs", "hopper", "--tuned", "yes", "--dataset",
                                      "hopper_expert_v2", "--extra", extra, "--reps", "2000",
                                      "--out", png])
    wall_ms = 1e3 * (time.time() - t0)
    final = np.array([[r["eval_curve"][-1]] for r in rows])
    point, lo, hi = stratified_bootstrap_ci(final, iqm, reps=2000)
    if (results["GAIL"]["iqm"], results["GAIL"]["ci_lo"], results["GAIL"]["ci_hi"]) != (point, lo, hi) \
            or png_size(png) != (960, 420):
        raise AssertionError(f"validate_learning: the report's {results} against the rows' "
                             f"({point}, {lo}, {hi})")
    print(f"validate_learning (13c): GAIL hopper tuned, hopper_expert_v2, {extra}, 256 envs on the "
          f"stepper, {steps} steps a seed, {n} updates each on sac_update and gail_update: seed 1 "
          f"{walls[0]:.2f} s wall ({steps / walls[0]:.1f} env-steps/s), seed 2 {walls[1]:.2f} s "
          f"({steps / walls[1]:.1f} env-steps/s), the Trainer built, run and evaluated; eval curves "
          f"{[[round(v, 4) for v in r['eval_curve']] for r in rows]}; the report on its rows: IQM "
          f"{point:.4f} [{lo:.4f}, {hi:.4f}] as recomputed, {wall_ms:.2f} ms wall on the host; on {smi}")


class TimedLines:
    """Standard output captured line by line, each line with the time it was
    written."""

    def __init__(self):
        self.partial, self.lines = "", []

    def write(self, text):
        self.partial += text
        while "\n" in self.partial:
            line, self.partial = self.partial.split("\n", 1)
            self.lines.append((time.time(), line))
        return len(text)

    def flush(self):
        pass


def captured(fn, argv):
    """(fn(argv), [(time, line)] it printed, seconds it took)."""
    import contextlib

    out = TimedLines()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.lines, t0, time.time() - t0


def check_d4rl_columns(path, kept):
    """D4RL's six float32 columns of equal length, in `kept` episodes each
    ending (and only there) in a terminal or a timeout. Returns the rows."""
    import numpy as np
    from iltpu_torch.generate_expert_data import COLUMNS

    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    n = len(data["rewards"])
    if list(data) != list(COLUMNS) or any(v.dtype != np.float32 or len(v) != n for v in data.values()):
        raise AssertionError(f"{path}: columns {[(k, v.dtype, v.shape) for k, v in data.items()]}")
    ends = np.flatnonzero(data["terminals"] + data["timeouts"])
    if len(ends) != kept or (kept and ends[-1] != n - 1):
        raise AssertionError(f"{path}: {len(ends)} episode ends at {ends[:8]} in {n} rows, "
                             f"{kept} episodes kept")
    return n


def check_expert_data(rates, pre, smi):
    """Phase 14: (14a) the expert trained and rolled out on the card by
    `generate_expert_data`, (14b) harvested from its checkpoints, (14c)
    its file through the main path's kernels, (14d) the results matrix and
    the run diagnostics on the card's host."""
    import shutil

    import numpy as np
    from iltpu_torch import generate_expert_data as ged
    from iltpu_torch.analysis import adril_diagnosis, decay_diagnosis, load_metrics, results_matrix
    from iltpu_torch.config import load_config

    t14 = time.time()
    root = os.path.join(REPO, "outputs", "chip_smoke", "expert_data")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    npz = os.path.join(root, "hopper_expert.npz")
    argv = ["--env", "hopper", "--env-backend", "native", "--steps", "4096", "--num-envs", "8",
            "--episodes", "2", "--max-attempts", "6", "--seed", "0"]
    cfg = load_config(ged.overrides(ged.parser().parse_args(argv + ["--out", npz])))
    reset_counts()
    _, lines, t0, wall = captured(ged.main, argv + ["--out", npz])
    launched = counts()
    text = [line for _, line in lines]
    trained_at = next(t for t, line in lines if line.startswith("expert trained:"))
    kept = sum(line.startswith("episode ") for line in text)
    dropped = sum(" dropped (" in line for line in text)
    training = os.path.join(root, "expert_training")
    if cfg.training.sac_pallas or launched != launches_of() or kept != 2:
        raise AssertionError(f"14a: sac_pallas={cfg.training.sac_pallas}, launches {launched}, "
                             f"{kept} episodes kept: {text}")
    rows = check_d4rl_columns(npz, kept)
    if not os.path.isdir(os.path.join(training, "agent")):
        raise AssertionError(f"14a: {training} has no agent/")
    train_s = trained_at - t0
    rates["expert_sac_autograd"] = 4096 / train_s
    print(f"expert data (14a): SAC on 8 hopper envs, 4096 steps, the autograd update (training."
          f"sac_pallas={cfg.training.sac_pallas}, no kernel launched: {launched}), trained in "
          f"{train_s:.2f} s wall ({4096 / train_s:.1f} env-steps/s, the Trainer's build and "
          f"{len(range(cfg.evaluation.interval, 4097, cfg.evaluation.interval))} evaluations of "
          f"{cfg.evaluation.episodes} episodes included); {kept} episodes kept, {dropped} dropped, "
          f"{rows} transitions; the command {1e3 * wall:.2f} ms wall; on {smi}")
    for line in text:
        print(f"  14a| {line}")

    # 14b: a harvest from both snapshots, then greedy twice from agent/
    snapshots = ",".join(os.path.join(training, d) for d in ("agent", "agent_best"))
    harvest = os.path.join(root, "harvest.npz")
    _, lines, _, wall = captured(ged.main, ["--env", "hopper", "--env-backend", "native", "--from-checkpoint",
                                            snapshots, "--stochastic", "0.3", "--episodes", "2",
                                            "--max-attempts", "6", "--out", harvest])
    text = [line for _, line in lines]
    kept = sum(line.startswith("episode ") for line in text)
    rows = check_d4rl_columns(harvest, kept)
    greedy = []
    for i in range(2):
        path = os.path.join(root, f"greedy_{i}.npz")
        _, _, _, g_wall = captured(ged.main, ["--env", "hopper", "--env-backend", "native",
                                              "--from-checkpoint", os.path.join(training, "agent"),
                                              "--episodes", "2", "--max-attempts", "6", "--out", path])
        with np.load(path) as f:
            greedy.append(({k: f[k].tobytes() for k in f.files}, g_wall))
    if greedy[0][0] != greedy[1][0] or kept == 0:
        raise AssertionError(f"14b: greedy rollouts differ or nothing harvested: {text}")
    print(f"expert data (14b): harvest from agent/ and agent_best/ at --stochastic 0.3: {kept} kept, "
          f"{sum(' dropped (' in line for line in text)} dropped, {rows} transitions, "
          f"{1e3 * wall:.2f} ms wall; greedy from agent/ twice, bit-equal files, "
          f"{1e3 * greedy[0][1]:.2f} and {1e3 * greedy[1][1]:.2f} ms wall; on {smi}")
    for line in text:
        print(f"  14b| {line}")

    # 14c: the generated file through the main path's kernels, pipelined
    args = ("env=hopper", "env_backend=native", f"expert_data.source={npz}", "imitation.trajectories=2",
            "num_envs=64", "steps=4096", "training.start=100", "training.pipeline=true",
            "logging.interval=512")
    t0 = time.time()
    counted, rates["expert_gail_pipeline"], pre["expert_gail_pipeline"] = run_trainer(
        "expert_gail_pipeline", args, owed(per_update))
    print(f"expert data (14c): GAIL on 64 hopper envs from 14a's file (2 trajectories), pipelined, "
          f"launches {counted} (each the owed updates), steady {rates['expert_gail_pipeline']:.1f} "
          f"env-steps/s, {1e3 * (time.time() - t0):.2f} ms wall; on {smi}")

    # 14d: the results matrix on both rows files, the diagnostics on 14a's and 14c's runs
    t0 = time.time()
    sizes = []
    for results in ("RESULTS.jsonl", "RESULTS_TORCH.jsonl"):
        for mode in ([], ["--best-variant"], ["--traj-grid"]):
            argv = ["--results", os.path.join(REPO, results), *mode]
            png = os.path.join(root, f"matrix_{results[:-6]}{''.join(mode)}.png")
            spec = results_matrix.figure_spec(results_matrix.parser().parse_args(argv))
            captured(results_matrix.main, argv + ["--out", png])
            want = (1800, 420 * spec["grid"][0]) if mode == ["--traj-grid"] else (1650, 1050)
            if png_size(png) != want or not spec["legend"]:
                raise AssertionError(f"14d: {png} is {png_size(png)}, not {want}; legend {spec['legend']}")
            sizes.append(f"{results} {' '.join(mode) or 'primary'} {want[0]} x {want[1]}")
    matrix_ms = 1e3 * (time.time() - t0)
    gail_dir = os.path.join(REPO, "outputs", "chip_smoke", "expert_gail_pipeline")
    rows_file = os.path.join(root, "rows.jsonl")
    with open(rows_file, "w") as f:
        for alg, traj, run in (("SAC", 1, training), ("GAIL", 2, gail_dir)):
            m = load_metrics(run)
            curve = [float(np.mean(x)) for x in m["test_returns_normalized"]]
            f.write(json.dumps({"algorithm": alg, "env": "hopper", "trajectories": traj, "seed": 0,
                                "num_envs": {"SAC": 8, "GAIL": 64}[alg], "final_normalized_score": float(np.mean(curve)),
                                "best_normalized_score": max(curve), "last_normalized_score": curve[-1],
                                "out_dir": os.path.relpath(run, adril_diagnosis.ROOT)}) + "\n")
    t0 = time.time()
    table = []
    for alg, traj in (("SAC", 1), ("GAIL", 2)):
        png = os.path.join(root, f"diagnosis_{alg}.png")
        panels, lines, _, _ = captured(adril_diagnosis.main, ["--rows", f"{alg}:hopper:{traj}",
                                                              "--results", rows_file, "--out", png])
        text = [line for _, line in lines]
        if len(text) != 4 or not panels or png_size(png) != (2160, 432):
            raise AssertionError(f"14d: adril_diagnosis on {alg}: {text}, figure {png_size(png)}")
        table.append(text[2])
    decay = []
    for run in (training, gail_dir):
        _, lines, _, _ = captured(decay_diagnosis.main, [os.path.join(run, "metrics.pkl")])
        decay.append([line for _, line in lines])
        if len(decay[-1]) < 3:
            raise AssertionError(f"14d: decay_diagnosis on {run}: {decay[-1]}")
    diag_ms = 1e3 * (time.time() - t0)
    for mod in ("matplotlib", "PIL"):
        if mod in sys.modules:
            raise AssertionError(f"14d: {mod} was imported")
    print(f"expert data (14d): results_matrix {'; '.join(sizes)} in {matrix_ms:.2f} ms wall; "
          f"adril_diagnosis rows {table}, 2160 x 432 figures, and decay_diagnosis "
          f"({len(decay[0])} and {len(decay[1])} lines) in {diag_ms:.2f} ms wall; on {smi}")
    for line in decay[1]:
        print(f"  14d| {line}")
    print(f"phase 14 took {time.time() - t14:.1f} s")


def gif_blocks(path):
    """Walk an animated GIF's blocks: the GIF89a header and logical screen,
    a global colour table if flagged, then extensions (the NETSCAPE2.0 loop
    block, a graphics control block before each image), images (their local
    colour table and LZW sub-blocks) and the trailer. Returns the size, the
    loop count, each frame's delay in hundredths of a second and each
    image's (local palette, LZW minimum code size, data bytes)."""
    data = open(path, "rb").read()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path}: header {data[:6]!r}")
    w, h = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    p = 13 + (3 * 2 ** ((data[10] & 7) + 1) if data[10] & 0x80 else 0)

    def sub_blocks(p):
        out = bytearray()
        while data[p]:
            out += data[p + 1:p + 1 + data[p]]
            p += 1 + data[p]
        return bytes(out), p + 1

    loop, delays, images, pending = None, [], [], None
    while True:
        tag = data[p]
        if tag == 0x3B:
            if p != len(data) - 1:
                raise AssertionError(f"{path}: {len(data) - 1 - p} bytes after the trailer")
            break
        if tag == 0x21:
            label = data[p + 1]
            body, q = sub_blocks(p + 2)
            if label == 0xFF and body[:11] == b"NETSCAPE2.0":
                loop = int.from_bytes(body[12:14], "little")
            elif label == 0xF9:
                if pending is not None:
                    raise AssertionError(f"{path}: two graphics control blocks before an image")
                pending = int.from_bytes(body[1:3], "little")
            p = q
        elif tag == 0x2C:
            iw, ih = int.from_bytes(data[p + 5:p + 7], "little"), int.from_bytes(data[p + 7:p + 9], "little")
            flags = data[p + 9]
            p += 10
            palette = None
            if flags & 0x80:
                n = 3 * 2 ** ((flags & 7) + 1)
                palette, p = data[p:p + n], p + n
            if (iw, ih) != (w, h) or pending is None:
                raise AssertionError(f"{path}: image {iw} x {ih} of {w} x {h}, control block {pending}")
            code_size = data[p]
            body, p = sub_blocks(p + 1)
            images.append((palette, code_size, body))
            delays.append(pending)
            pending = None
        else:
            raise AssertionError(f"{path}: block 0x{tag:02x} at byte {p}")
    return (w, h), loop, delays, images


def lzw_decode(body, code_size, n):
    """GIF's LZW decoder, for one image's `n` indices."""
    clear, end = 1 << code_size, (1 << code_size) + 1
    out, acc, bits, pos = bytearray(), 0, 0, 0
    size, table, prev = code_size + 1, None, None
    while True:
        while bits < size:
            acc |= body[pos] << bits
            pos += 1
            bits += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        bits -= size
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            size, prev = code_size + 1, None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            if len(table) < 4096:
                table.append(prev + entry[:1])
                if len(table) == 1 << size and size < 12:
                    size += 1
        out += entry
        prev = entry
    if len(out) != n:
        raise AssertionError(f"LZW decoded {len(out)} indices, want {n}")
    return bytes(out)


def check_render(dev, rates, pre, smi):
    """Phase 16: render=true on the card. (16a) 10b's pipelined main path
    (GAIL on 512 hopper envs, the SAC and GAIL kernels) for 2,048 steps with
    render=true: each kernel launched once an owed update, then the greedy
    rollout rendered on the card into rollout.npz ((N, 480, 480, 3) uint8)
    and rollout.gif (N frames); (16b) the rollout's scenes again, cast on the
    card (bit-equal to the npz), and with frames of a 500-frame halfcheetah
    rollout (zero actions: it never terminates), 24 frames cast on the CPU:
    the share of equal pixels (at least 99.5%) and the largest difference
    elsewhere; (16c) ms a frame cast on the card in batches of 16 and one at
    a time, the palette's and LZW's ms a frame, the scene export's us a
    step, the 500-frame render's parts (rollout, cast, npz, GIF); (16d)
    `python -m iltpu_torch.render_rollout` on 16a's agent/: the frame count
    it prints, the npz, and the GIF walked block by block (header, loop
    block, a control block and an image a frame, the first and last images
    decoded to their palette's colours)."""
    import numpy as np
    import torch
    from iltpu_torch.envs import host, render
    from iltpu_torch.envs.native import NativeVecEnv
    from iltpu_torch.utils import gif, raycast

    t16 = time.time()
    kept = []
    args = (*HOPPER, "training.start=100", "training.pipeline=true", "render=true", "steps=2048",
            "training.timing_skip_steps=1024")
    counted, rates["hopper_render"], pre["hopper_render"] = run_trainer(
        "hopper_render", args, owed(per_update), keep=kept)
    t = kept[0]
    npz, gif_path = (os.path.join(t.out_dir, f"rollout.{e}") for e in ("npz", "gif"))
    with np.load(npz) as f:
        frames = f["frames"]
    n = len(frames)
    size, loop, delays, images = gif_blocks(gif_path)
    if frames.dtype != np.uint8 or frames.shape != (n, 480, 480, 3) or not 1 <= n <= 500 \
            or len(images) != n or size != (480, 480) or loop != 0 or set(delays) != {3}:
        raise AssertionError(f"16a: frames {frames.shape} {frames.dtype}, GIF {size} loop {loop}, "
                             f"{len(images)} images, delays {sorted(set(delays))}")
    print(f"render (16a): GAIL on 512 hopper envs, pipelined, render=true: launches {counted} for "
          f"{t.updates_done} owed updates; {n} frames {frames.shape} {frames.dtype}, rollout.npz "
          f"{os.path.getsize(npz)} bytes, rollout.gif {os.path.getsize(gif_path)} bytes ({len(images)} "
          f"images, delay {delays[0]} cs, loop {loop}); on {smi}")

    # 16b: the same scenes on the card and on the CPU; halfcheetah never terminates, so with
    # zero actions its rollout runs the whole 500 frames of a render
    greedy = t._greedy_fn()
    scenes, textures = host.rollout_scenes("hopper", greedy, seed=t.cfg.seed + 39916801, max_frames=500)
    if len(scenes) != n:
        raise AssertionError(f"16b: {len(scenes)} scenes again, {n} frames")
    tex = raycast.Textures(textures, dev)
    again = raycast.render_scenes(scenes, tex, device=dev, batch=16)
    if not np.array_equal(again, frames):
        raise AssertionError("16b: the scenes cast again on the card differ from rollout.npz")
    t0 = time.perf_counter()
    long_scenes, long_textures = host.rollout_scenes(
        "halfcheetah", lambda obs: np.zeros((len(obs), 6), np.float32), seed=0, max_frames=500)
    roll_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    long_frames = raycast.render_scenes(long_scenes, long_textures, device=dev, batch=16)
    cast_s = time.perf_counter() - t0
    cpu_tex = [raycast.Textures(x, "cpu") for x in (textures, long_textures)]
    picked = [(scenes, cpu_tex[0], frames, i) for i in range(min(n, 24))]
    step = max(1, 500 // max(1, 24 - len(picked)))
    picked += [(long_scenes, cpu_tex[1], long_frames, i) for i in range(0, 500, step)][:24 - len(picked)]
    t0 = time.time()
    diff = np.concatenate([np.abs(raycast.render_scenes([sc[i]], tx, device="cpu").astype(np.int16)
                                  - fr[i:i + 1].astype(np.int16)).max(-1) for sc, tx, fr, i in picked])
    cpu_s = time.time() - t0
    share = float((diff == 0).mean())
    if share < 0.995:
        raise AssertionError(f"16b: only {share:.5f} of the pixels equal on the card and the CPU")
    print(f"render (16b): {len(picked)} scenes ({min(n, 24)} of 16a's, the rest every {step} of a "
          f"500-frame halfcheetah rollout) cast on the card and on the CPU: {share:.6f} of the "
          f"pixels equal (limit 0.995), {int((diff == 1).sum())} off by 1, the largest difference "
          f"{int(diff.max())} of 255 ({int((diff > 2).sum())} pixels past 2: silhouette edges); "
          f"the card's frames cast again bit-equal to rollout.npz; the CPU took "
          f"{1e3 * cpu_s / len(picked):.1f} ms a frame ({torch.get_num_threads()} threads)")

    # 16c: times
    def card_ms(batch, frames_of):
        raycast.render_scenes(frames_of[:batch], tex, device=dev, batch=batch)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raycast.render_scenes(frames_of, tex, device=dev, batch=batch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / len(frames_of)

    tex = raycast.Textures(long_textures, dev)
    batched_ms, single_ms = card_ms(16, long_scenes[:64]), card_ms(1, long_scenes[:32])
    t0 = time.perf_counter()
    palettes = [gif.quantize(f) for f in long_frames[:64]]
    quant_ms = 1e3 * (time.perf_counter() - t0) / 64
    t0 = time.perf_counter()
    for _, idx in palettes:
        gif.lzw(idx)
    lzw_ms = 1e3 * (time.perf_counter() - t0) / 64
    long_out = os.path.join(REPO, "outputs", "chip_smoke", "render_halfcheetah")
    os.makedirs(long_out, exist_ok=True)
    t0 = time.perf_counter()
    np.savez_compressed(os.path.join(long_out, "rollout.npz"), frames=long_frames)
    npz_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gif.save_frames_gif(long_frames, os.path.join(long_out, "rollout.gif"), fps=30)
    gif_s = time.perf_counter() - t0
    env = NativeVecEnv("hopper", 1)
    env.set_auto_reset(False)
    env.reset()
    cam = render.camera("hopper", env.geom_xpos(0))
    rng = np.random.default_rng(0)
    export = []
    for _ in range(200):
        env.step(rng.uniform(-0.2, 0.2, (1, 3)).astype(np.float32))
        t0 = time.perf_counter()
        env.scene(0, cam)
        export.append(time.perf_counter() - t0)
    env.close()
    export_us = 1e6 * float(np.median(export))
    print(f"render (16c): halfcheetah (9 geoms), {batched_ms:.3f} ms a 480 x 480 frame cast on the "
          f"card in batches of 16, {single_ms:.3f} ms one at a time; the palette (numpy median cut) "
          f"{quant_ms:.2f} ms and LZW (C++) {lzw_ms:.3f} ms a frame on the host (64 frames); the scene export "
          f"(hopper) {export_us:.2f} us a step (median of 200); a 500-frame render's parts: the "
          f"rollout with its scenes {roll_s:.2f} s, the cast {cast_s:.2f} s, the npz {npz_s:.2f} s, "
          f"the GIF {gif_s:.2f} s ({os.path.getsize(os.path.join(long_out, 'rollout.gif'))} bytes); "
          f"on {smi}")

    # 16d: the script on 16a's agent
    out = os.path.join(REPO, "outputs", "chip_smoke", "render_script", "rollout")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "iltpu_torch.render_rollout", "--env", "hopper",
                        "--agent", os.path.join(t.out_dir, "agent"), "--out", out],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    script_s = time.time() - t0
    if r.returncode:
        raise AssertionError(f"16d: render_rollout exited {r.returncode}: {r.stderr[-2000:]}")
    m = re.fullmatch(r"wrote (.+)\.npz / (.+)\.gif \((\d+) frames\)", r.stdout.strip())
    if not m or m.group(1) != out or m.group(2) != out:
        raise AssertionError(f"16d: printed {r.stdout!r}")
    k = int(m.group(3))
    with np.load(out + ".npz") as f:
        frames2 = f["frames"]
    size, loop, delays, images = gif_blocks(out + ".gif")
    if frames2.shape != (k, 480, 480, 3) or len(images) != k or set(delays) != {2} or loop != 0:
        raise AssertionError(f"16d: {frames2.shape}, {len(images)} images, delays {set(delays)}, "
                             f"loop {loop}")
    worst = 0
    for i in sorted({0, k - 1}):
        palette, code_size, body = images[i]
        idx = np.frombuffer(lzw_decode(body, code_size, 480 * 480), np.uint8)
        rgb = np.frombuffer(palette, np.uint8).reshape(-1, 3)[idx].reshape(480, 480, 3)
        want_palette, want_idx = gif.quantize(frames2[i])
        if not np.array_equal(idx.reshape(480, 480), want_idx):
            raise AssertionError(f"16d: image {i}'s decoded indices differ from its quantization")
        worst = max(worst, float(np.abs(rgb.astype(np.int16) - frames2[i]).mean()))
    print(f"render (16d): python -m iltpu_torch.render_rollout on 16a's agent/ ({script_s:.1f} s): "
          f"{k} frames, npz {frames2.shape}, GIF walked: {size[0]} x {size[1]}, loop {loop}, "
          f"{len(images)} control blocks and images at {delays[0]} cs, the first and last images "
          f"decoded to their quantized indices (mean abs error {worst:.3f} of 255); phase 16 took "
          f"{time.time() - t16:.1f} s")


def ptxas_report(log):
    """The `-Xptxas -v` register lines of a build log, and every function
    with spills."""
    out, fn = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        elif "Used" in line:
            out.append(line.split(":", 1)[1].strip())
        elif fn and re.search(r"[1-9]\d* bytes spill (stores|loads)", line):
            out.append(f"{fn[:80]}: {line.strip()}")
    return "; ".join(out)


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(REPO, "iltpu_torch")):
        fail(f"the iltpu_torch package is not beside {__file__}: run from a checkout")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}, {torch.cuda.device_count()} visible, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # 2. build
    from iltpu_torch.ops import build
    from iltpu_torch.ops import kblock_update as kb
    from iltpu_torch.ops import sac_update as su

    from iltpu_torch.ops import gail_update as gu

    names = (*build.NAMES, "gail_phases")  # the phase timer: 10d times both GAIL variants
    secs = build.build_all(names)
    print(f"build: {', '.join(names)} in {secs:.2f} s (one nvcc each, in parallel)")
    for name in build.NAMES:
        print(f"build {name}: {ptxas_report(build.build_log(name))}")
    for S, A in ((5, 2), (12, 3)):
        print(f"build gail_update: S={S} A={A}: {gu.smem_bytes(256, S + A, 64)} bytes of dynamic "
              f"shared memory (batch 256, width 64)")
        for name, (per_sm, sms, smem, *gail) in (
            ("sac_update", su.grid(build.load("sac_update"), 256, S, A, 256)),
            ("kblock_update", kb.grid(build.load("kblock_update"), 256, S, A, 256, 64)),
        ):
            print(f"build {name}: S={S} A={A}: {per_sm} co-resident block(s) of 512 threads per "
                  f"SM x {sms} SMs = a cooperative grid of {per_sm * sms}"
                  + (f" ({gail[0]} run GAIL, the rest SAC)" if gail else "")
                  + f", {smem} bytes of dynamic shared memory a block")

    # 3. kernels against their plain versions
    results = {}
    for S, A, where in ((5, 2, "pointmass"), (12, 3, "hopper")):
        check_sac_shape(S, A, where, dev, results)
        err, times = (0.0, 0.0), None
        for bce in (True, False):
            e, t, case = check_gail(S, A, bce, dev)
            err = worse(err, e)
            if bce:  # the bench configuration is the main path's
                times = (*t, *gail_bound_ms(S, A, 256, 64, case))
        results[("gail", where)] = (err[0], *times)
        print(f"kernel gail_update {where} S={S} A={A}: max_abs_err {err[0]:.3g}, max_rel_err "
              f"{err[1]:.3g}, {timing(times)}")
    from iltpu_torch import profile_phases

    for S, A, B, Hd, bce, case in GAIL_VARIANTS:
        routed = gu.variant(B, S + A, Hd)
        # where the route passes over a tiled variant that takes the shape, that one too
        tiled_too = routed == "wide" and profile_phases.variant_smem_bytes(B, S + A, Hd, "tiled")
        for variant in (None, "tiled") if tiled_too else (None,):
            err, _, _ = check_gail(S, A, bce, dev, B=B, Hd=Hd, timed=False, variant=variant, **case)
            print(f"kernel gail_update variant S={S} A={A} B={B} Hd={Hd} {'BCE' if bce else 'Mixup'} "
                  f"{case}: {variant or routed}"
                  f"{f' (routed, {gu.blocks(B, S + A, Hd)} block(s))' if variant is None else ''}, "
                  f"{profile_phases.variant_smem_bytes(B, S + A, Hd, variant or routed)} bytes of "
                  f"shared memory, max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}")
    # the Mixup draw at alpha 0.5: Beta(0.5, 0.5) from the trainer's capture-safe sampler
    for S, A in ((5, 2), (12, 3)):
        err, _, _ = check_gail(S, A, False, dev, timed=False, alpha=0.5)
        print(f"kernel gail_update S={S} A={A} Mixup with a Beta(0.5, 0.5) mix, 1 step and a chain "
              f"of 5: max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}")
    # a batch past the GEMM's whole-depth panels: the ring of 128-deep chunks
    err, _ = check_sac(5, 2, 0.0, dev, B=1024, timed=False)
    print(f"kernel sac_update pointmass B=1024 (chunked weight-gradient depth): max_abs_err "
          f"{err[0]:.3g}, max_rel_err {err[1]:.3g}")
    # the tuned GAIL@10 batch on hopper (tuned.yaml: 512) at min_alpha 0.05: 13c's and the
    # parity run's SAC step, its weight gradients past the whole-depth panels
    err, _ = check_sac(12, 3, 0.05, dev, B=512, timed=False)
    per_sm, sms, smem = su.grid(build.load("sac_update"), 512, 12, 3, 256)
    print(f"kernel sac_update hopper B=512 min_alpha=0.05 (the tuned GAIL@10 batch): a cooperative "
          f"grid of {per_sm} x {sms} blocks, {smem} bytes of dynamic shared memory a block, "
          f"max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}")
    torch.cuda.synchronize()

    # 3b. the K-blocked kernel
    for S, A, where in ((5, 2, "pointmass"), (12, 3, "hopper")):
        check_kblock_configs(S, A, where, dev, results)
        e, same, _ = check_kblock(S, A, False, 0.0, dev, timed=False, alpha=0.5)
        if not all(same.values()):
            raise AssertionError(f"kblock_update {where} Beta(0.5, 0.5): not bit-identical to K "
                                 f"per-update calls at K in {[K for K, v in same.items() if not v]}")
        print(f"kernel kblock_update {where} S={S} A={A} Mixup with a Beta(0.5, 0.5) mix: "
              f"bit-identical to K per-update calls at K={sorted(same)}, K=5 against the plain "
              f"version: max_abs_err {e[0]:.3g}, max_rel_err {e[1]:.3g}")

    # 3c. the row-sum kernel
    rowsum = check_rowsum(dev)
    # GMMIL's path launches the kernel through the fused reward
    results[("rowsum", "pointmass")] = rowsum[("gmmil_witness_reward", 256, 256, 7)]
    torch.cuda.synchronize()

    # 3f. PWIL's transport kernel
    pwil = check_pwil(dev)
    results[("pwil", "pointmass")] = pwil["pointmass"]
    torch.cuda.synchronize()

    # 3d. the autograd SAC update against the SAC kernel
    for S, A, where in ((5, 2, "pointmass"), (12, 3, "hopper")):
        err, times = (0.0, 0.0), None
        for min_alpha in (0.0, 0.05):
            e, t = check_autograd_sac(S, A, min_alpha, dev, timed=not min_alpha)
            err, times = worse(err, e), times or t
        print(f"autograd sac {where} S={S} A={A} vs the SAC kernel, 1 step and a chain of 8, "
              f"min_alpha 0 and 0.05: max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}; "
              f"{times[0]:.4f} ms an update on the device (traced, {times[1]:.1f} launches), "
              f"{times[2]:.4f} ms host-paced (the kernel: {results[('sac', where)][1]:.4f} on the "
              f"device, {results[('sac', where)][2]:.4f} host-paced)")
    # 3e. the autograd discriminator update + reward against the GAIL kernel
    for bce in (True, False):
        err, times = check_autograd_gail(5, 2, bce, dev)
        print(f"autograd gail pointmass {'BCE' if bce else 'Mixup'} vs the GAIL kernel, 1 step and "
              f"a chain of 5: max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}; {times[0]:.4f} ms "
              f"a step + reward on the device (traced, {times[1]:.1f} launches), {times[2]:.4f} ms "
              f"host-paced")
    torch.cuda.synchronize()

    # 4. the whole update path against the CPU, on each path
    for extra, want in (
        ((), launches_of(sac_update=24, gail_update=24)),
        (("training.update_block=4",), launches_of(kblock_update=6)),
        (tuple(GMMIL_ARGS), launches_of(sac_update=24, gmmil_witness_reward=24)),
        (tuple(alg_args("AdRIL", False)), launches_of()),
        (tuple(alg_args("AdRIL")), launches_of(sac_update=24)),
        (tuple(alg_args("RED", False)), launches_of()),
        (tuple(alg_args("DRIL", False)), launches_of()),
        (tuple(alg_args("SAC", False)), launches_of()),
        (tuple(alg_args("DRIL")), launches_of(sac_update=24)),  # BC aux in place before the kernel
        (tuple(alg_args("GAIL")), launches_of(sac_update=24)),  # the autograd GAIL step
        (tuple(alg_args("PWIL")), launches_of(sac_update=24, pwil_transport=3)),
        # the GAIL input options on the autograd step; Mixup at alpha 0.5 on both kernels
        ((*alg_args("GAIL"), *OPTIONS), launches_of(sac_update=24)),
        ((*alg_args("GAIL"), "imitation.state_only=true"), launches_of(sac_update=24)),
        (MIXUP05, launches_of(sac_update=24, gail_update=24)),
        (("training.update_block=4", *MIXUP05), launches_of(kblock_update=6)),
    ):
        err, launched = check_against_cpu(dev, extra)
        if launched != want:
            raise AssertionError(f"reference {extra}: launches {launched} != {want}")
        print(f"reference: transition_core {' '.join(extra) or 'GAIL'} on the card vs the CPU, "
              f"3 x 8 updates: max_abs_err {err[0]:.3g}, max_rel_err {err[1]:.3g}, launches {launched}")

    # 5. the trainer, through its normal entry, on each path
    pretrain = "imitation.pretraining.iterations=1000"
    launches, rates, pre = {}, {}, {}
    for name, extra, expect, kernels in (
        ("gail", (), per_update, ("sac_update", "gail_update")),
        ("gail_kblock16", ("training.update_block=16",), blocked, ("kblock_update",)),
        ("gmmil", tuple(GMMIL_ARGS), gmmil, ("gaussian_rowsum", "gmmil_witness_reward")),
        ("sqil", tuple(alg_args("SQIL")), sac_only, ()),
        ("adril", tuple(alg_args("AdRIL")), sac_only, ()),
        ("dril", (*alg_args("DRIL"), pretrain), sac_only, ()),
        ("red", (*alg_args("RED"), pretrain), sac_only, ()),
        ("sac_autograd", (*alg_args("SAC", False), "steps=2048", "training.timing_skip_steps=1024"),
         none, ()),
        ("bc", (*alg_args("BC", False), "bc_pretraining.iterations=1000"), none, ()),
    ):
        counted, rates[name], pre[name] = run_trainer(name, extra, expect)
        launches.update({k: counted[k] for k in kernels})
    # 5e. PWIL on the host loop; the on-device loop on each kernel path and
    # the slowest autograd ones
    device = "training.on_device_loop=true"
    for name, extra, expect, kernels in (
        ("pwil", tuple(alg_args("PWIL")), pwil_path, ("pwil_transport",)),
        ("gail_device", (device,), per_update, ()),
        ("gail_kblock16_device", (device, "training.update_block=16"), blocked_all, ()),
        ("gmmil_device", (device, *GMMIL_ARGS), gmmil, ()),
        ("pwil_device", (device, *alg_args("PWIL")), pwil_path, ()),
        ("dril_device", (device, *alg_args("DRIL"), "imitation.pretraining.iterations=100"),
         sac_only, ()),
        ("sac_autograd_device", (device, *alg_args("SAC", False)), none, ()),
    ):
        counted, rates[name], pre[name] = run_trainer(name, extra, expect)
        launches.update({k: counted[k] for k in kernels})
    print("trainer on-device loop vs host loop, steady env-steps/s: " + ", ".join(
        f"{k} {rates[k + '_device']:.1f} vs {rates[k]:.1f}"
        for k in ("gail", "gail_kblock16", "gmmil", "pwil", "dril", "sac_autograd")) + f" on {smi}")
    # 5f. pipelined and host acting (bench.py's GAIL configuration, on pointmass), each run
    # right after the plain host loop's run of the same path
    for name, extra, expect in (
        ("gail_again", (), per_update),
        ("gail_pipeline", ("training.pipeline=true",), per_update),
        ("gail_host_acting", ("training.host_acting=true",), per_update),
        ("gail_kblock16_again", ("training.update_block=16",), blocked),
        ("gail_kblock16_pipeline", ("training.update_block=16", "training.pipeline=true"), blocked),
    ):
        counted, rates[name], pre[name] = run_trainer(name, extra, expect)
    print("trainer pipelined and host acting vs the plain host loop, steady env-steps/s: "
          f"gail pipelined {rates['gail_pipeline']:.1f} and host acting "
          f"{rates['gail_host_acting']:.1f} vs {rates['gail_again']:.1f} (phase 5: "
          f"{rates['gail']:.1f}), gail_kblock16 pipelined {rates['gail_kblock16_pipeline']:.1f} vs "
          f"{rates['gail_kblock16_again']:.1f} (phase 5b: {rates['gail_kblock16']:.1f}) on {smi}")
    host_acting_costs(dev)

    # 6. a chunk from CUDA graphs against the same chunk run eagerly, on every path
    check_graphs(dev)
    # 6b. checkpoint and resume on the card, then graphs captured after the load
    check_resume(dev)

    # 7. tooling: the profiler window, a multirun, a train_all sweep, the aggregation
    check_profiler_window(results)
    jobs = check_multirun()
    check_train_all()
    aggregation = check_aggregation(jobs)

    # 8. data parallel: NCCL at world size 1, then two gloo ranks on the one card
    import torch.distributed as dist

    t8 = time.time()
    dp_times, coll_ms = check_data_parallel_world1(dev)
    dp2_ms = check_data_parallel_two_ranks(dev)

    def allreduces(k):
        return lambda t: launches_of(allreduce_mean_=k * t.updates_done)

    # 64 envs: the first chunk's eager warm-up iteration (64 host-paced updates) stays short;
    # the capture precedes the steady window
    autograd = (*alg_args("GAIL", False), "num_envs=64", "steps=2048", "training.start=256",
                "training.timing_skip_steps=1024", "memory.size=10000")
    for name, extra, expect in (
        ("gail_again_dp", ("training.fused_update_scan=false", *DP), per_update),
        ("gail_autograd_device", (device, *autograd), none),
        ("gail_autograd_device_dp", (device, *autograd, *DP), allreduces(3)),
    ):
        counted, rates[name], pre[name] = run_trainer(name, extra, expect)
    phase8_s = time.time() - t8

    # 9. the tensor-parallel layout: world 1 on NCCL (phase 8's group), two gloo ranks
    # on the card, and the host loop plain, with data_axis and with shard_params in turns
    t9 = time.time()
    tp_times, tp_gathers, tp_resident = check_layout_world1(dev)
    tp2 = check_layout_two_ranks(dev)

    def sharded(t):  # per_update's, and the layout's all-gathers: one an update, an act's
        # an iteration, the sampled rows' an iteration with updates, the final evaluation's,
        # agent_best's and the run outputs'
        N, c = t.cfg.num_envs, t.cfg
        its = sum(1 for s in range(N, c.steps + N, N) if s >= max(c.training.start, 1))
        return dict(per_update(t), allgather_blocks=t.updates_done + t.step_done // N + its + 3)

    unfused = ("training.fused_update_scan=false",)
    host_loop = {"plain": (unfused, per_update), "dp": ((*unfused, *DP), per_update),
                 "shard": ((*unfused, *DP, *SHARD), sharded)}
    for i, way in enumerate(("plain", "dp", "shard", "shard", "dp", "plain")):
        name = f"gail_tp_{way}{i // 3}"
        counted, rates[name], pre[name] = run_trainer(name, *host_loop[way])
    dist.destroy_process_group()
    print("data parallel one-rank NCCL collectives, ms a call eager / replayed from a graph: "
          + ", ".join(f"{k} {e:.4f} / {r:.4f}" for k, (e, r) in coll_ms.items()) + f" on {smi}")
    print("data parallel ms an update at world 1 (16 envs, 16 updates an iteration, full widths; "
          "with data_axis vs without): " + ", ".join(
              f"{name} {mode} {dp_times[(name, mode, 1)]:.4f} vs {dp_times[(name, mode, 0)]:.4f}"
              for name, _, _ in DP_PATHS for mode in ("host-paced", "replayed"))
          + f"; two gloo ranks on the card (8b) {dp2_ms:.3f}; trainer steady env-steps/s: gail "
          f"host loop {rates['gail_again_dp']:.1f} with data_axis (phase 5: {rates['gail']:.1f}), "
          f"autograd GAIL on-device (64 envs) {rates['gail_autograd_device_dp']:.1f} with vs "
          f"{rates['gail_autograd_device']:.1f} without, on {smi}; phase 8 took "
          f"{phase8_s:.1f} s")
    print("layout ms an update at world 1 (16 envs, 16 updates an iteration, full widths; "
          "shard_params vs data_axis alone): " + ", ".join(
              f"{name} {mode} {tp_times[(name, mode, 1)]:.4f} vs {tp_times[(name, mode, 0)]:.4f}"
              for name, _, _ in TP_PATHS for mode in ("host-paced", "replayed"))
          + "; all-gathers an update " + ", ".join(f"{k} {v:.4f}" for k, v in tp_gathers.items())
          + f"; resident state bytes at world 1 {tp_resident[1]} under the layout, "
          f"{tp_resident[0]} without; two gloo ranks (9b) " + ", ".join(
              f"{p} {v[1]:.3f} ms an update, resident {v[3]} and peak {v[4]} bytes a rank "
              f"(world 1 resident {v[2]})" for p, v in tp2.items())
          + "; GAIL kernels on the host loop, steady env-steps/s in turns: " + ", ".join(
              f"{way} {rates[f'gail_tp_{way}0']:.1f} and {rates[f'gail_tp_{way}1']:.1f}"
              for way in ("plain", "dp", "shard"))
          + f" on {smi}; phase 9 took {time.time() - t9:.1f} s")

    # 10. the MuJoCo envs: the stepper, iltpu's main path (GAIL on 512 hopper envs, bench.py's
    # configuration), the other envs and SAC, the kernels at each env's shapes
    check_mujoco(dev, results, rates, pre, launches, smi)

    # 11. GAIL, PWIL and GMMIL on ant on their kernels; GAIL at the tuned widths
    wide_launches = check_wide_trainers(dev, rates, pre, smi)

    # 12. D4RL's HDF5 expert data through the port's reader, the main path on it, the plots
    read_12a_ms = check_d4rl_hdf5(rates, pre, smi)

    # 13. the analysis layer: the two reports on phase 7's outputs, the learning-validation
    # harness on the card (GAIL on hopper through the SAC and GAIL kernels) and the report on its rows
    t13 = time.time()
    check_seed_sweep_report(jobs, aggregation, smi)
    check_hp_opt_report(smi)
    check_validate_learning(smi)
    print(f"phase 13 took {time.time() - t13:.1f} s")

    # 14. expert data generated on the card (autograd SAC), harvested, through the main path's
    # kernels; the results matrix and the run diagnostics on the card's host
    check_expert_data(rates, pre, smi)

    # 15. h5py's newer formats through the port's reader, the main path on a latest-format file
    check_latest_hdf5(rates, pre, read_12a_ms, smi)
    # 15c. the rest of what h5py reads (virtual datasets, external links and raw data, filtered
    # heaps, floats of other layouts), the main path on the virtual-dataset file
    check_remainder_hdf5(rates, pre, smi)

    # 16. render=true: the main path, then its greedy rollout cast on the card, the GIF
    check_render(dev, rates, pre, smi)

    # the row-sum kernel's launches on its path: both of its entries
    launches["gaussian_rowsum"] += launches.pop("gmmil_witness_reward")
    print("trainer steady env-steps/s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in rates.items() if v is not None) + f" on {smi}")
    print("trainer pretraining ms an iteration: " + ", ".join(
        f"{k} {v:.4f}" for k, v in pre.items() if v is not None) + f" on {smi}")

    # the kernels line: each at its path's shapes, launches from that path's run: the per-update
    # and K-blocked kernels on the main path (hopper, 10b), the row sums on GMMIL's (5c) and
    # PWIL's transport on PWIL's (5e), both on pointmass; then each at the wide shapes (10d),
    # launches from the phase 11 run of that shape (PWIL's: its 64 pools of ant's atoms)
    rows = []
    sites = {"sac_update": "iltpu/ops/pallas_sac.py:564", "gail_update": "iltpu/ops/pallas_gail.py:319",
             "kblock_update": "iltpu/ops/pallas_fused_block.py:241",
             "gaussian_rowsum": "iltpu/ops/pallas_pairwise.py:101",
             "pwil_transport": "iltpu/rewards/pwil.py:107"}
    for name, key, path, count in (
        ("sac_update", ("sac", "hopper"), "hopper", launches["sac_update"]),
        ("gail_update", ("gail", "hopper"), "hopper", launches["gail_update"]),
        ("kblock_update", ("kblock", "hopper"), "hopper", launches["kblock_update"]),
        ("gaussian_rowsum", ("rowsum", "pointmass"), "pointmass", launches["gaussian_rowsum"]),
        ("pwil_transport", ("pwil", "pointmass"), "pointmass", launches["pwil_transport"]),
        ("gail_update", ("gail", "B=256 D=120 Hd=64"), "ant_gail",
         wide_launches["ant_gail"]["gail_update"]),
        ("gail_update", ("gail", "B=1024 D=120 Hd=128"), "ant_gail_wide128_b1024",
         wide_launches["ant_gail_wide128_b1024"]["gail_update"]),
        ("gail_update", ("gail", "B=1024 D=24 Hd=128"), "walker2d_wide128_b1024",
         wide_launches["walker2d_wide128_b1024"]["gail_update"]),
        ("gail_update", ("gail", "B=1024 D=15 Hd=128"), "hopper_wide128_b1024",
         wide_launches["hopper_wide128_b1024"]["gail_update"]),
        ("kblock_update", ("kblock", "ant"), "ant_gail_kblock16",
         wide_launches["ant_gail_kblock16"]["kblock_update"]),
        ("sac_update", ("sac", "ant"), "ant_gail", wide_launches["ant_gail"]["sac_update"]),
        ("sac_update", ("sac", "ant B=1024"), "ant_gail_wide128_b1024",
         wide_launches["ant_gail_wide128_b1024"]["sac_update"]),
        ("gaussian_rowsum", ("rowsum", "ant"), "ant_gmmil",
         wide_launches["ant_gmmil"]["gmmil_witness_reward"]),
        ("pwil_transport", ("pwil", "ant"), "ant_pwil", wide_launches["ant_pwil"]["pwil_transport"]),
    ):
        err, ms, paced_ms, plain_ms, bound, by = results[key]
        rows.append({
            "name": name, "route": "cuda", "source": f"iltpu_torch/csrc/{name}.cu",
            "replaces": sites[name], "path": path, "shape": key[1], "launches": count,
            "max_abs_err": err, "ms": ms, "host_paced_ms": paced_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
        })
        if name in ("sac_update", "kblock_update"):  # the SAC step's plan (a micro-update's)
            B, S, A = SAC_PLAN_SHAPES[key[1]]
            if name == "sac_update":  # every block of its grid
                per_sm, sms, _ = su.grid(build.load("sac_update"), B, S, A, 256)
                blocks = per_sm * sms
            else:  # the blocks GAIL leaves
                per_sm, sms, _, gail = kb.grid(build.load("kblock_update"), B, S, A, 256, 64)
                blocks = per_sm * sms - gail
            plan = su.plan(build.load("sac_update"), B, S, A, 256, blocks)
            rows[-1]["sac_plan"] = {k: plan[k] for k in ("phases", "row_items", "gemm_rounds")}
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
