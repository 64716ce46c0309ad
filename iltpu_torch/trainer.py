"""Training orchestrator: the port of `iltpu/trainer.py`.

One iteration (`Trainer.iteration`, shared by both loops) samples actions
from the actor, steps `num_envs` array envs on the device, computes PWIL's
reward where PWIL runs, appends the step to the replay ring (absorbing wrap
inline), takes ONE bulk sample of n_updates x batch rows from the replay and
from the expert buffer, then runs n_updates per-update bodies. Every tensor
stays on the device. The host loop reads the episode ends once per
iteration; the on-device loop (`training.on_device_loop=true`) once per
chunk of iterations, which on the card replay CUDA graphs
(`iltpu_torch/graphs.py`).

The envs are built by `env_backend`, as iltpu builds them: `jax` steps the
array envs (pointmass, pendulum) on the device; `native` the MuJoCo envs
(hopper, walker2d, halfcheetah, ant) by the C++ stepper built against
`third_party/mujoco` (`envs/native.py`); `auto` the stepper where it
builds, else gymnasium's; `mujoco` gymnasium's envs (`envs/host.py`), where
gymnasium is installed. A MuJoCo env steps on the host behind
`envs.vecenv.HostEnv`: each step copies the actions to the host and one
packed block of its outputs to the device. Its runs take the host loop
(`training.on_device_loop=true` too, as in iltpu), evaluate through
`envs.host.evaluate_policy` on the stepper (`native`, `auto`) or gymnasium
(`mujoco`), normalise by the D4RL scores of `envs/scores.py`, and with
`save_trajectories=true` write `trajectories.pkl` from gymnasium's envs.

The per-update body follows iltpu's `update_fn`: the reward by algorithm
-> optional expert mixing (`mix_expert_data=mixed_batch`, not for AdRIL)
-> optional BC auxiliary step on the actor's own AdamW state -> the SAC
step. The reward is:

- GAIL/AIRL/FAIRL: a discriminator step, then the reward of the UPDATED
  discriminator: the GAIL kernel (`training.disc_pallas=true`) or the
  autograd `adversarial_imitation_update` (BCE, PUGAIL, Mixup). With
  `training.fused_update_scan=true` and `training.update_block=K > 1`, an
  iteration whose n_updates K divides runs n_updates / K launches of the
  K-blocked kernel (K x GAIL -> SAC in one launch), as iltpu does.
- GMMIL: the MMD witness reward through the row-sum kernel.
- PWIL: the greedy-transport reward the ring stored at env-step time (the
  transport kernel; the training return keeps the env's reward).
- AdRIL/SQIL: the balanced (or half-batch) relabelling.
- DRIL: +-1 from the dropout ensemble's uncertainty against its threshold.
- RED: exp(-sigma_1 * the predictor's error).
- SAC and BC: the env's reward.

The SAC step is the SAC kernel (`training.sac_pallas=true`) or the autograd
`SACLearner.update`; both update the same flat state. Before the loop:
BC pretraining (and BC's early exit), DRIL's ensemble and RED's predictor
pretraining, PWIL's relabelling of the expert rewards (with
`mix_expert_data` other than none) and the `prefill_memory` transfer.

Everything an iteration updates is updated in place (`state_tensors`), so a
captured iteration replays against the live state. On the card the
kernels of `iltpu_torch/csrc/` run; on the CPU (platform=cpu) their plain
versions. Entry points run on the card (`platform` null or gpu) and raise
when CUDA is missing.

The host loop has iltpu's two acting modes. `training.pipeline=true` issues
the next iteration's act and env step before this iteration's updates, so
the actor reads params one iteration stale, and reads each iteration's
rewards and dones through a pinned copy that does not wait for the
updates; the generator draws in the plain loop's order. With
`training.host_acting=true` a numpy copy of the actor samples the actions
on the host (`models.host_inference.HostActor`), from params synced one
iteration behind. Either flag with `training.on_device_loop=true` takes the
on-device loop, as iltpu does.

`checkpointing.interval` writes the whole state (`convert.train_state_tree`,
iltpu's layout) with the step, metrics, score and the generator's state
to `checkpoint/`, at iltpu's cadences; `checkpointing.resume` copies one
back into the tensors the trainer built. The run writes `agent/`,
`discriminator/` and the best evaluation's `agent_best/` as
`utils.checkpoint` directories, and `metrics.pkl`. `profiling.trace_dir`
opens iltpu's profiler window over the host loop (`ProfilerWindow`:
torch.profiler, a Chrome trace, with the host loop's spans in it). The
span recorder (`utils.spans.Recorder`, off by default; on through
`trainer.spans = Recorder()` before `run()`) keeps in memory where the
host loop is, iteration by iteration: its front, its updates one unit at
a time, the env step and each wait on the card. After every evaluation (and at BC's
early exit) rank 0 writes iltpu's six metric plots (`utils.plotting`, PNG
without matplotlib). `expert_data.source=hdf5` reads D4RL's HDF5 file
through the port's own reader (`data.hdf5`). `render=true` on a MuJoCo env
renders a greedy rollout at the end (`envs.host.render_rollout`: the
stepper's scenes ray cast on the trainer's device) into iltpu's
`rollout.npz` and `rollout.gif`; kernel flags that iltpu refuses raise
iltpu's ValueError.
`evaluation.on_host` (iltpu's default, true) evaluates through a numpy copy
of the actor (`models.host_inference.host_greedy_fn`); false, through the
device forward.

`parallel.data_axis` runs data parallel (`iltpu_torch.parallel`), one
process (a rank) a device, on `cuda:<local rank>`: a data-parallel run is
the single-device run to reduction-order rounding, as iltpu's mesh is.
Every rank seeds the same generator, steps the same envs, fills the same
ring, samples the same global batch and draws the same noise; ranks never
exchange state. Only an update's gradient steps split the work: each rank
takes its shard of the policy batch, the expert batch and the per-row
draws, and the autograd steps (critic, actor and temperature, the
discriminator, the BC auxiliary step) all-reduce their gradients. The
rewards, the expert mixing, the kernels and pretraining run replicated on
the whole batch, so the metrics and rewards are the single-device run's.
Only rank 0 writes run outputs.

With `parallel.shard_params` as well, the state is laid out as iltpu lays
it out (`iltpu_torch.parallel.tensor`): each rank keeps only its column
block of each leaf iltpu's `param_shardings` shards, and each piece of work
that reads such leaves (`_work`: an update unit, an act, an evaluation, the
host actor's sync, a pretraining, the run outputs, a checkpoint) gathers
them whole in one collective, runs as above, and keeps its block of what it
updated. The front appends the block's columns of a sharded ring column and
gathers the sampled rows. The numbers are the data-parallel run's.
"""

import contextlib
import os
import pickle
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from iltpu_torch import convert
from iltpu_torch.config import DotDict, validate_config
from iltpu_torch.data import (
    build_expert_transitions,
    load_d4rl_hdf5,
    random_d4rl_dataset,
    replay_append_batch,
    replay_from_transitions,
    replay_init,
    replay_sample,
    replay_transfer,
)
from iltpu_torch.data.replay import COLUMNS
from iltpu_torch.envs import SPECS, make_env
from iltpu_torch.envs.host import evaluate_policy, render_rollout, rollout_scenes
from iltpu_torch.models import SoftActor, TwinCritic
from iltpu_torch.models.actor import DRIL_ENSEMBLE_SIZE
from iltpu_torch.models.distributions import beta_sample
from iltpu_torch.models.host_inference import HostActor, HostReads, host_greedy_fn
from iltpu_torch.ops.gail_update import GAILHyper, gail_update
from iltpu_torch.ops.kblock_update import kblock_update
from iltpu_torch.ops.sac_update import sac_update
from iltpu_torch.parallel import TensorLayout, local_rank, make_mesh, shard_batch
from iltpu_torch.rewards import (
    GAILDiscriminator,
    GMMILDiscriminator,
    PWILDiscriminator,
    REDDiscriminator,
    init_relabeller,
    mix_expert_agent_transitions,
    resample_and_relabel,
)
from iltpu_torch.rewards.adril import round_of
from iltpu_torch.updates import (
    AdversarialConfig,
    SACLearner,
    actor_opt_state,
    adversarial_imitation_update,
    behavioural_cloning_update,
    target_estimation_update,
)
from iltpu_torch.utils.checkpoint import load_aux, load_checkpoint, save_checkpoint
from iltpu_torch.utils.plotting import lineplot
from iltpu_torch.utils.spans import Recorder

TRAINABLE_DISCRIMINATORS = ("DRIL", "GAIL", "RED")

# The sharded leaves a piece of work reads, by name prefix (`Trainer._work`)
ACTOR = ("sac.a[",)
UPDATE = ("sac.", "disc.p[", "disc.target[")
POOLS = ("disc.expert_weights[",)


VIEW_CHUNK = 64  # updates whose views one unbind a key takes (`per_update`)


def per_update(d: Dict[str, torch.Tensor]) -> Iterator[Dict[str, torch.Tensor]]:
    """The dicts of `d`'s views along its leading axis, one an update, in
    order: each key's views from one `unbind` a chunk of VIEW_CHUNK updates,
    equal to `v[c]` in shape, strides and storage. Taken chunk by chunk as
    they are asked for, so the card never waits for a whole iteration's."""
    keys, vals = list(d), list(d.values())
    for c in range(0, vals[0].shape[0], VIEW_CHUNK):
        yield from (dict(zip(keys, row))
                    for row in zip(*(v[c:c + VIEW_CHUNK].unbind(0) for v in vals)))


def resolve_device(platform: Optional[str], rank: Optional[int] = None) -> torch.device:
    """`cpu` selects the CPU; null or `gpu` the card, raising without CUDA:
    `cuda:<rank>` for a rank's own card, else the current one."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform in (None, "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"platform={platform} runs on the GPU, and CUDA is not available; "
                "pass platform=cpu to run on the CPU"
            )
        return torch.device("cuda") if rank is None else torch.device("cuda", rank)
    raise ValueError(f"unknown platform {platform!r}: cpu or gpu")


def check_supported(cfg: DotDict) -> None:
    """Raise iltpu's ValueError for the configurations iltpu refuses."""
    t, icfg, rcfg = cfg.training, cfg.imitation, cfg.reinforcement
    alg = cfg.algorithm
    d = icfg.get("discriminator") or {}
    if t.get("sac_pallas") and not all(
        rcfg[n]["depth"] == 2 and rcfg[n]["activation"] == "relu" for n in ("actor", "critic")
    ):
        raise ValueError(
            "training.sac_pallas=true requires depth-2 relu actor/critic MLPs without dropout "
            f"or spectral norm (algorithm={alg})"
        )
    if t.get("disc_pallas") and not (
        alg == "GAIL" and icfg.get("loss_function") in ("BCE", "Mixup")
        and not d.get("reward_shaping") and not d.get("subtract_log_policy")
        and not icfg.get("state_only") and d.get("depth") == 1 and d.get("activation") == "relu"
        and icfg.get("mix_expert_data") == "none"
    ):
        raise ValueError(
            "training.disc_pallas=true supports the BCE and Mixup GAIL configurations (depth-1 "
            f"relu, no shaping/log-pi/state-only/mixing); got algorithm={alg}"
        )
    if t.get("fused_update_scan") and not (
        alg == "GAIL" and t.get("sac_pallas") and t.get("disc_pallas") and not icfg.get("bc_aux_loss")
        and cfg.parallel.get("data_axis") is None
    ):
        raise ValueError(
            "training.fused_update_scan=true requires algorithm=GAIL with training.sac_pallas "
            "and training.disc_pallas, no bc_aux_loss, and a single-device (mesh-free) run"
        )


def _load_expert_dataset(cfg: DotDict, env) -> Dict[str, np.ndarray]:
    src = cfg.expert_data.source
    if src == "hdf5":  # before the .npz test, as iltpu: an .npz path goes to the HDF5 reader
        return load_d4rl_hdf5(cfg.expert_data.path)
    if src == "npz" or str(src).endswith(".npz") or (cfg.expert_data.path or "").endswith(".npz"):
        path = src if str(src).endswith(".npz") else cfg.expert_data.path
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    assert src == "synthetic", f"unknown expert_data.source {src}"
    raw_obs = env.obs_size - (1 if cfg.imitation.absorbing else 0)
    n_traj = max(cfg.imitation.trajectories, 10)
    length = min(env.max_episode_steps, 100)
    return random_d4rl_dataset(
        np.random.default_rng(cfg.seed), [length] * n_traj, raw_obs, env.action_size
    )


class ProfilerWindow:
    """iltpu's profiler window over the host loop (`prof`, the `profiling`
    config: `trace_dir`, none for no window, `start_step` 2000 and `steps`
    200 by default), through torch.profiler:
    it opens at the top of the first iteration at or past `start_step`,
    closes at the top of the first one at or past `start_step + steps` or
    at the loop's end, once a run, and writes a Chrome trace into
    `trace_dir` (`path`). CPU activities, and CUDA ones on the card. While
    it is open, the span recorder `spans` (set by the host loop) enters each
    span as a `record_function` too."""

    def __init__(self, prof: Optional[Dict], device: torch.device, prefix: str = ""):
        prof = prof or {}
        self.dir = prof.get("trace_dir")
        self.start_step = int(prof.get("start_step", 2000))
        self.stop_step = self.start_step + int(prof.get("steps", 200))
        self.device, self.prefix = device, prefix
        self.prof = self.path = self.spans = None

    def at(self, step: int):
        """The top of the iteration that starts at env step `step`."""
        if self.dir and self.prof is None and step >= self.start_step:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            if self.spans is not None:
                self.spans.profiling = True
        if self.prof is not None and step >= self.stop_step:
            self.close()

    def close(self):
        """Stop the window, if open, and write its trace."""
        if self.prof is None:
            return
        if self.spans is not None:
            self.spans.profiling = False
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, f"{self.prefix}host_loop.{os.getpid()}."
                                           f"{time.time_ns()}.pt.trace.json")
        self.prof.export_chrome_trace(self.path)
        self.prof = self.dir = None


class Trainer:
    def __init__(self, cfg: Dict, out_dir: str = ".", file_prefix: str = ""):
        self.cfg = cfg = validate_config(cfg)
        check_supported(cfg)
        self.mesh = None
        data_axis = cfg.parallel.get("data_axis")
        if data_axis:  # the process group's ranks, this one on its own device
            self.mesh = make_mesh(cfg.parallel.get("num_devices"), data_axis,
                                  resolve_device(cfg.get("platform"), local_rank()))
            n = self.mesh.world_size
            B = cfg.training.batch_size
            assert B % n == 0, f"batch_size {B} must divide the {n}-device data mesh"
        self.device = dev = self.mesh.device if self.mesh else resolve_device(cfg.get("platform"))
        self.writer = self.mesh is None or self.mesh.rank == 0  # only rank 0 writes
        self.out_dir = out_dir
        self.prefix = file_prefix
        self.spans: Optional[Recorder] = None  # the host loop's span recorder, off
        if self.writer:
            os.makedirs(out_dir, exist_ok=True)
        self.gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        self.env = make_env(cfg.env, cfg.num_envs, absorbing=cfg.imitation.absorbing,
                            device=dev, generator=self.gen, backend=cfg.env_backend, seed=cfg.seed)
        self.host_env = cfg.env_backend != "jax"  # a MuJoCo env, stepped on the host
        S, A = self.env.obs_size, self.env.action_size
        self.state_size, self.action_size = S, A
        ref = SPECS[cfg.env] if self.host_env else self.env.env
        self.norm_min, self.norm_max = ref.ref_min_score, ref.ref_max_score

        raw = _load_expert_dataset(cfg, self.env)
        if cfg.expert_data.get("terminals_to_timeouts", False):
            raw = dict(raw)
            t = np.asarray(raw["terminals"]).astype(bool)
            raw["timeouts"] = (np.asarray(raw["timeouts"]).astype(bool) | t).astype(np.float32)
            raw["terminals"] = np.zeros_like(raw["timeouts"])
        transitions, n_traj = build_expert_transitions(
            raw,
            trajectories=cfg.imitation.trajectories,
            subsample=cfg.imitation.subsample,
            absorbing=cfg.imitation.absorbing,
            rng=np.random.default_rng(cfg.seed),
        )
        self.expert = replay_from_transitions(transitions, n_traj, cfg.imitation.absorbing, dev)

        rcfg, icfg = cfg.reinforcement, cfg.imitation
        self.actor = SoftActor(S, A, rcfg.actor.hidden_size, rcfg.actor.depth,
                               rcfg.actor.activation, device=dev)
        self.critic = TwinCritic(S, A, rcfg.critic.hidden_size, rcfg.critic.depth,
                                 rcfg.critic.activation, device=dev)
        self.learner = SACLearner(
            self.actor,
            self.critic,
            learning_rate=cfg.training.learning_rate,
            weight_decay=cfg.training.weight_decay,
            discount=rcfg.discount,
            entropy_target=rcfg.target_temperature * A,
            polyak_factor=rcfg.polyak_factor,
            min_alpha=float(rcfg.get("min_alpha", 0.0) or 0.0),
        )
        self.sac = self.learner.init(self.gen)
        self.replay = replay_init(cfg.memory.size, S, A, icfg.absorbing, dev)

        t = cfg.training
        self.sac_pallas = bool(t.get("sac_pallas"))
        self.disc_pallas = bool(t.get("disc_pallas"))
        self.fused_scan = bool(t.get("fused_update_scan"))
        self.algorithm = alg = cfg.algorithm
        self.update_block = int(t.get("update_block", 1) or 1)
        self.disc = self.disc_state = self.disc_hyper = None
        d = DotDict(icfg.get("discriminator") or {})
        if alg == "GMMIL":
            self.disc = GMMILDiscriminator(S, A, state_only=icfg.state_only)
            self.disc_state = self.disc.init(dev)
        elif alg == "GAIL":
            self.disc = GAILDiscriminator(
                S, A,
                state_only=icfg.state_only,
                reward_shaping=bool(d.reward_shaping),
                subtract_log_policy=bool(d.subtract_log_policy),
                discount=rcfg.discount,
                reward_function=d.reward_function,
                hidden_size=d.hidden_size,
                depth=d.depth,
                activation=d.activation,
                spectral_norm=icfg.spectral_norm,
                device=dev,
            )
            self.disc_state = self.disc.init(self.gen)
            self.disc_hyper = GAILHyper(
                grad_penalty=float(icfg.grad_penalty),
                lr=float(icfg.learning_rate),
                weight_decay=float(icfg.weight_decay),
                reward_function=d.reward_function,
                loss_function=icfg.loss_function,
                entropy_bonus=float(icfg.entropy_bonus),
            )
            self.adv_cfg = AdversarialConfig(
                loss_function=icfg.loss_function,
                grad_penalty=float(icfg.grad_penalty),
                entropy_bonus=float(icfg.entropy_bonus),
                pos_class_prior=float(icfg.pos_class_prior),
                nonnegative_margin=float(icfg.nonnegative_margin),
                learning_rate=float(icfg.learning_rate),
                weight_decay=float(icfg.weight_decay),
            )
        elif alg == "DRIL":
            # the actor-shaped dropout ensemble, with an AdamW state of its own
            self.disc = SoftActor(S, A, d.hidden_size, d.depth, d.activation,
                                  input_dropout=d.input_dropout, dropout=d.dropout, device=dev)
            self.disc.reset_parameters(self.gen)
            p = self.disc.net.leaves()
            self.disc_state = {"p": p, "m": [torch.zeros_like(x) for x in p],
                               "v": [torch.zeros_like(x) for x in p],
                               "t": torch.zeros(1, device=dev)}
            self.dril_threshold = torch.zeros((), device=dev)
        elif alg == "RED":
            self.disc = REDDiscriminator(
                S, A, state_only=icfg.state_only, hidden_size=d.hidden_size, depth=d.depth,
                activation=d.activation, input_dropout=d.input_dropout, dropout=d.dropout,
                reward_bandwidth_scale=icfg.reward_bandwidth_scale, device=dev,
            )
            self.disc_state = self.disc.init(self.gen)
        elif alg == "PWIL":
            self.disc = PWILDiscriminator(
                S, A, state_only=icfg.state_only, reward_scale=icfg.reward_scale,
                reward_bandwidth_scale=icfg.reward_bandwidth_scale,
                time_horizon=self.env.max_episode_steps,
                expert_states=self.expert.rows("states"), expert_actions=self.expert.rows("actions"),
            )
            self.disc_state = self.disc.init(cfg.num_envs)  # one atom pool per env
        elif alg == "AdRIL":
            self.relabel = init_relabeller(dev)

        self.metrics = dict(
            train_steps=[], train_returns=[], test_steps=[], test_returns=[],
            test_returns_normalized=[], update_steps=[], predicted_rewards=[],
            alphas=[], entropies=[], Q_values=[],
        )
        self.score = []
        self._log_queue = []
        self.step_done = self.updates_done = self.start_step = 0
        # the agent_best floor: seeded once from an existing snapshot's score
        self._best_prior, self._best_seeded = float("-inf"), False
        if cfg.checkpointing.resume:
            self._resume(cfg.checkpointing.resume)  # whole leaves: the layout keeps its blocks
        # iltpu lays the state out on its mesh only: without data_axis it ignores the flag
        self.layout = None
        if self.mesh is not None and cfg.parallel.get("shard_params"):
            self.layout = TensorLayout(self, self.mesh)

    def _work(self, *prefixes: str, write: bool = True):
        """A piece of work on the whole leaves named by `prefixes` (all when
        none) under the tensor-parallel layout (`TensorLayout.work`), else
        nothing to do."""
        return self.layout.work(*prefixes, write=write) if self.layout else contextlib.nullcontext()

    def _samples(self, draws):
        """`replay_sample` of each (ring, n, raw integers), in order; under
        the layout the rows of every block column in one collective."""
        batches = [replay_sample(rs, n, self.gen, r) for rs, n, r in draws]
        if self.layout:
            self.layout.whole_rows(batches, [rs for rs, _, _ in draws])
        return batches

    # ------------------------------------------------------------ updates

    def draw_noise(self, n_updates: int) -> Dict[str, torch.Tensor]:
        """Every per-update draw of one iteration, in bulk from the trainer's
        generator, each with a leading n_updates axis (the replay and expert
        sample integers are drawn by replay_sample when absent): GAIL's
        penalty interpolation `eps_gp` and Mixup draw `mix` (Beta(alpha,
        alpha); a uniform at alpha 1, as iltpu), SAC's `eps2` and
        `eps_new`, and the keep-masks of DRIL's five members for each layer
        k that drops (`dril_mask<k>`, (n_updates, 5, B, width))."""
        B, A, g, dev = self.cfg.training.batch_size, self.action_size, self.gen, self.device
        gail = self.algorithm == "GAIL"
        noise = {}
        if gail:
            noise["eps_gp"] = torch.rand((n_updates, B), generator=g, device=dev)
        noise["eps2"] = torch.randn((n_updates, B, A), generator=g, device=dev)
        noise["eps_new"] = torch.randn((n_updates, B, A), generator=g, device=dev)
        if gail and self.cfg.imitation.loss_function == "Mixup":
            alpha = float(self.cfg.imitation.mixup_alpha)
            noise["mix"] = (torch.rand((n_updates, B), generator=g, device=dev) if alpha == 1.0
                            else beta_sample(alpha, (n_updates, B), g, dev))  # Beta(1, 1) exactly
        if self.algorithm == "DRIL":
            masks = self.disc.net.draw_masks((n_updates, DRIL_ENSEMBLE_SIZE, B), g)
            noise.update({f"dril_mask{k}": m for k, m in enumerate(masks) if m is not None})
        return noise

    def _step_ids(self, step, n: int) -> torch.Tensor:
        """(n,) float32 step + 1 of an iteration's transitions, from a host
        int or from the device's step counter (0-d int64)."""
        if isinstance(step, torch.Tensor):
            return (step + 1).to(torch.float32).expand(n)
        return torch.full((n,), float(step + 1), device=self.device)

    @torch.no_grad()
    def front(
        self, step, obs, actions, rewards, next_obs, terminals, timeouts, n_updates: int,
        noise: Optional[Dict[str, torch.Tensor]] = None,
    ):
        """An iteration's work before its updates: PWIL's reward at env-step
        time (the ring stores it, and the pools of the envs that ended are
        refilled), the ring append, then the iteration's draws and ONE bulk
        sample of n_updates x batch rows from the replay and from the expert
        buffer. `step` is a host int or the device's step counter; `noise`
        injects the draws of `draw_noise` and the raw replay and expert
        sample integers (`replay`, `expert`). Returns (aux, batches, expert
        batches, draws), the last three with a leading n_updates axis (None
        when n_updates is 0)."""
        aux = {}
        if self.algorithm == "PWIL":
            dones = (terminals + timeouts) > 0
            with self._work(*POOLS):
                _, rewards = self.disc.compute_reward(self.disc_state, obs, actions, dones)
            aux["pwil_rewards"] = rewards
        replay_append_batch(self.replay, self._step_ids(step, obs.shape[0]), obs, actions, rewards,
                            next_obs, terminals, timeouts,
                            keep=self.layout.keep(self.replay) if self.layout else None)
        if n_updates == 0:
            return aux, None, None, None
        if noise is None:
            noise = self.draw_noise(n_updates)
        B = self.cfg.training.batch_size
        batches, expert_batches = (
            {k: v.reshape((n_updates, B) + v.shape[1:]) for k, v in batch.items()}
            for batch in self._samples([(self.replay, n_updates * B, noise.get("replay")),
                                        (self.expert, n_updates * B, noise.get("expert"))]))
        draws = {k: v for k, v in noise.items() if k not in ("replay", "expert")}
        return aux, batches, expert_batches, draws

    def unit(self, n_updates: int) -> int:
        """Updates a launch takes: K on the K-blocked path (GAIL with
        training.fused_update_scan and update_block=K > 1, when K divides the
        iteration's n_updates, as iltpu), else 1."""
        K = self.update_block
        if self.algorithm == "GAIL" and self.fused_scan and K > 1 and n_updates % K == 0:
            return K
        return 1

    @torch.no_grad()
    def update_unit(self, step, tb, eb, nz) -> Dict[str, torch.Tensor]:
        """One unit of updates on batches, expert batches and draws with a
        leading axis of `unit` rows: one K-blocked launch (K x GAIL -> SAC)
        when that is above 1, else the per-update body. Returns the aux."""
        with self._work(*UPDATE):
            if tb["states"].shape[0] > 1:
                out = kblock_update(self.learner.hyper, self.disc_hyper, self.sac, self.disc_state,
                                    tb, eb, nz)
                return {"discriminator_loss": out["loss"][0], "predicted_rewards": out["rewards"],
                        "alphas": out["alpha"], "entropies": -out["log_probs"],
                        "Q_values": out["Q_values"]}
            return self.update(step, *({k: v[0] for k, v in d.items()} for d in (tb, eb, nz)))

    @torch.no_grad()
    def run_updates(self, step, batches, expert_batches, draws, n_updates: int):
        """The iteration's n_updates in units, in order; the last one's aux.
        A unit of one update calls `self.update` on that update's (B, ...)
        views (`per_update`), through the instance: an instance-level
        override sees every update."""
        aux = {}
        u = self.unit(n_updates)
        sp = self.spans
        if sp is not None:
            sp.begin("updates", n_updates)
        views = zip(*(per_update(d) for d in (batches, expert_batches, draws))) if u == 1 else None
        for c in range(0, n_updates, u):
            if sp is not None:
                sp.begin("update", u)
            if u == 1:
                tb, eb, nz = next(views)
                with self._work(*UPDATE):
                    aux = self.update(step, tb, eb, nz)
            else:
                aux = self.update_unit(step, *({k: v[c:c + u] for k, v in d.items()}
                                               for d in (batches, expert_batches, draws)))
            if sp is not None:
                sp.end()
        if sp is not None:
            sp.end()
        return aux

    @torch.no_grad()
    def transition_core(
        self, step, obs, actions, rewards, next_obs, terminals, timeouts,
        n_updates: int, noise: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """`front`, then its n_updates updates (iltpu's transition_core).
        Returns the last update's aux, with PWIL's rewards."""
        front = self.front(step, obs, actions, rewards, next_obs, terminals, timeouts, n_updates,
                           noise)
        return self._updates_of(step, front, n_updates)

    def update(self, step, tb, eb, nz) -> Dict[str, torch.Tensor]:
        """One update (iltpu's `update_fn`) on the policy batch `tb`, the
        expert batch `eb` and this update's draws `nz`: the reward -> mixing
        -> BC auxiliary step -> SAC step. PWIL's reward is the one the ring
        stored. `step` is a host int or the device's step counter. Under
        data parallel the autograd gradient steps take this rank's shard of
        the rows and draws (`shard`); the rest sees the whole batch. Returns
        the aux, of the whole batch."""
        alg, icfg, mesh = self.algorithm, self.cfg.imitation, self.mesh

        def shard(x):
            return x if mesh is None else shard_batch(x, mesh)

        aux = {}
        if alg == "GAIL":
            if self.disc_pallas:
                d_loss, gail_rewards = gail_update(
                    self.disc_hyper, self.disc_state, eb["states"], eb["actions"], eb["weights"],
                    tb["states"], tb["actions"], tb["weights"], nz["eps_gp"], nz.get("mix"),
                )
                aux["discriminator_loss"] = d_loss[0]
            else:
                # log pi at the update's pre-SAC actor params (shared with self.sac["a"])
                log_pi = self.actor.log_prob if self.disc.subtract_log_policy else None
                aux["discriminator_loss"] = adversarial_imitation_update(
                    self.disc, self.disc_state, shard(tb), shard(eb), self.adv_cfg,
                    shard(nz["eps_gp"]), shard(nz.get("mix")), log_pi, mesh)
        if icfg.mix_expert_data == "mixed_batch" and alg != "AdRIL":
            tb = mix_expert_agent_transitions(tb, eb)
        tb = dict(tb)
        if alg == "AdRIL":
            # diagnostics of the raw policy batch, before the relabelling
            if icfg.update_freq > 0:
                stale = round_of(step, icfg.update_freq) > torch.ceil(tb["step"] / icfg.update_freq)
                aux["diag_adril_stale_frac"] = stale.float().mean()
            aux["diag_num_trajectories"] = self.replay.num_trajectories.float()
            flip, tb = resample_and_relabel(
                self.relabel, tb, eb, step, self.replay.num_trajectories,
                self.expert.num_trajectories, update_freq=icfg.update_freq, balanced=icfg.balanced,
            )
            self.relabel.copy_(flip)  # in place: a captured update replays against it
            aux["diag_relabel_reward_mean"] = tb["rewards"].mean()
        elif alg == "DRIL":
            masks = [nz.get(f"dril_mask{k}") for k in range(self.disc.net.n_layers)]
            tb["rewards"] = self.disc.dril_reward(tb["states"], tb["actions"], self.dril_threshold, masks)
        elif alg == "GAIL" and self.disc_pallas:
            tb["rewards"] = gail_rewards
        elif alg == "GAIL":  # the updated discriminator's, on the (mixed) batch
            tb["rewards"] = self.disc.predict_reward(
                tb["states"], tb["actions"], self.disc_state, tb["next_states"], tb["terminals"],
                log_pi and log_pi(tb["states"], tb["actions"]))
        elif alg == "GMMIL":
            self.disc_state, tb["rewards"] = self.disc.predict_reward(
                self.disc_state, tb["states"], tb["actions"], eb["states"], eb["actions"],
                tb["weights"], eb["weights"],
            )
        elif alg == "RED":
            tb["rewards"] = self.disc.predict_reward(self.disc_state, tb["states"], tb["actions"])
        if icfg.bc_aux_loss:
            # on the SAC actor's own AdamW state, in place, before the SAC step reads it
            behavioural_cloning_update(self.actor, actor_opt_state(self.sac), shard(eb),
                                       lr=self.learner.lr, weight_decay=self.learner.weight_decay,
                                       mesh=mesh)
        if self.sac_pallas:  # the kernel: replicated, on the whole batch
            out = sac_update(self.learner.hyper, self.sac, tb, nz["eps2"], nz["eps_new"])
        else:
            out = self.learner.update(self.sac, shard(tb), shard(nz["eps2"]), shard(nz["eps_new"]),
                                      mesh)
        aux.update(predicted_rewards=tb["rewards"], alphas=out["alpha"],
                   entropies=-out["log_probs"], Q_values=out["Q_values"])
        return aux

    @torch.no_grad()
    def sample_actions(self, env_state: Dict) -> torch.Tensor:
        """The actor's sample from the envs' observations."""
        with self._work(*ACTOR, write=False):
            return self.actor.sample(env_state["obs"], generator=self.gen)[0]

    @torch.no_grad()
    def act_env(self, env_state: Dict, actions=None):
        """Act from the envs' observations (the actor's sample, unless
        `actions` are given: on the device, or for a MuJoCo env a numpy
        array or what `HostEnv.fetch` returned) and step the envs, their
        state in place. Returns (the observations acted on, the actions,
        the env's outputs)."""
        if actions is None:
            actions = self.sample_actions(env_state)
        if self.host_env:  # the packed block holds both
            _, out = self.env.step(env_state, actions)
            return out["obs"], out["actions"], out
        obs = env_state["obs"].clone()  # the step overwrites the state
        _, out = self.env.step(env_state, actions)
        return obs, actions, out

    def _reads(self, reads: HostReads, out: Dict, env_state: Optional[Dict] = None):
        """Begin the host's reads of an env step's rewards and dones (and,
        given `env_state`, of the observations to act on next), for
        `reads.wait`; a MuJoCo env returned them on the host already."""
        host = out.get("host")
        if host is not None:
            keys = ("reward", "done", "obs")[:3 if env_state is not None else 2]
            return [torch.from_numpy(host[k]) for k in keys], None
        extra = [env_state["obs"]] if env_state is not None else []
        return reads.start([out["reward"], out["done"]] + extra)

    def front_of(self, step, acted, n_updates: int):
        """`front` on what `act_env` returned."""
        obs, actions, out = acted
        sp = self.spans
        if sp is not None:
            sp.begin("front", n_updates * self.cfg.training.batch_size)
        front = self.front(step, obs, actions, out["reward"], out["next_obs"], out["terminal"],
                           out["timeout"], n_updates)
        if sp is not None:
            sp.end()
        return front

    @torch.no_grad()
    def act_and_step(self, env_state: Dict, step, n_updates: int):
        """An iteration up to its updates: act from the envs' observations,
        step the envs (their state in place), then `front`. Returns (the
        env's outputs, front's (aux, batches, expert batches, draws))."""
        acted = self.act_env(env_state)
        return acted[2], self.front_of(step, acted, n_updates)

    def iteration(self, env_state: Dict, step, n_updates: int):
        """One iteration of either loop: act -> env step -> PWIL reward ->
        append -> draws and bulk samples -> n_updates updates. Returns (the
        env's outputs, the aux)."""
        out, front = self.act_and_step(env_state, step, n_updates)
        return out, self._updates_of(step, front, n_updates)

    def run_chunk(self, env_state: Dict, step: int, n_iters: int, upi: int):
        """n_iters iterations of `upi` updates from env step `step`, one by
        one through `iteration`: (rewards (n_iters, N), dones, the last
        aux), on the device."""
        rewards, dones, aux = [], [], {}
        for i in range(n_iters):
            out, aux = self.iteration(env_state, step + i * self.cfg.num_envs, upi)
            rewards.append(out["reward"])
            dones.append(out["done"])
        return torch.stack(rewards), torch.stack(dones), aux

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor an iteration updates, by name: the SAC state, the
        discriminator's (GMMIL's carry, PWIL's pools), AdRIL's flip, the
        replay ring with its scalars. A captured iteration replays against
        these very tensors. Under the tensor-parallel layout, a sharded
        leaf's is this rank's block."""
        out = {}

        def add(prefix, v):
            for i, t in enumerate(v if isinstance(v, list) else [v]):
                if isinstance(t, torch.Tensor):
                    out[f"{prefix}[{i}]"] = t

        for k, v in self.sac.items():
            add(f"sac.{k}", v)
        st = self.disc_state
        items = st.items() if isinstance(st, dict) else vars(st).items() if st is not None else ()
        for k, v in items:
            add(f"disc.{k}", v)
        if self.algorithm == "AdRIL":
            add("relabel", self.relabel)
        for k in COLUMNS + ("idx", "full", "num_trajectories"):
            add(f"replay.{k}", getattr(self.replay, k))
        if getattr(self, "layout", None):
            out.update(self.layout.blocks())
        return out

    # ------------------------------------------------------------- phases

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _greedy_fn(self):
        """iltpu's `_greedy_fn`: numpy observations -> numpy greedy actions,
        from one numpy copy of the actor with `evaluation.on_host` (iltpu's
        default), else through the device forward."""
        if self.cfg.evaluation.get("on_host", True):
            with self._work(*ACTOR, write=False):
                return host_greedy_fn(self.actor, self.sac["a"])

        @torch.no_grad()
        def greedy(obs: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
            with self._work(*ACTOR, write=False):
                return self.actor.greedy_action(x).cpu().numpy()

        return greedy

    def evaluate(self):
        """The greedy policy's returns over `evaluation.episodes` envs seeded
        from seed + 7919. With `evaluation.on_host` (iltpu's default) from
        one numpy copy of the actor, the actions copied to the envs each
        step and the returns summed in float64 (iltpu's `_greedy_fn` loop);
        else through the device forward. A MuJoCo env's episodes run in
        iltpu's `evaluate_policy`, on the stepper for `native` and `auto`
        (whichever `auto` took) and on gymnasium's envs for `mujoco`."""
        cfg = self.cfg
        n = cfg.evaluation.episodes
        if self.host_env:
            return evaluate_policy(cfg.env, self._greedy_fn(), n, absorbing=cfg.imitation.absorbing,
                                   seed=cfg.seed + 7919, env_cls=type(self.env.env)
                                   if cfg.env_backend in ("native", "auto") else None)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 7919)
        env = make_env(cfg.env, n, absorbing=cfg.imitation.absorbing, device=self.device,
                       generator=gen)
        st = env.reset()
        if cfg.evaluation.get("on_host", True):
            greedy = self._greedy_fn()
            reads = HostReads(self.device)
            obs = reads.wait(reads.start([st["obs"]]))[0]
            done, returns = np.zeros(n, bool), np.zeros(n)
            while not done.all():
                st, out = env.step(st, reads.to_device(greedy(obs)))
                r, d, obs = reads.wait(reads.start([out["reward"], out["done"], st["obs"]]))
                returns += np.where(done, 0.0, r)
                done |= d
            return returns.tolist()
        done = torch.zeros(n, dtype=torch.bool, device=self.device)
        returns = torch.zeros(n, device=self.device)
        with self._work(*ACTOR, write=False):
            while not bool(done.all()):
                st, out = env.step(st, self.actor.greedy_action(st["obs"]))
                returns += torch.where(done, 0.0, out["reward"])
                done |= out["done"]
        return returns.tolist()

    def _normalized(self, returns):
        return ((np.asarray(returns) - self.norm_min) / (self.norm_max - self.norm_min)).tolist()

    _LOG_KEYS = ("predicted_rewards", "alphas", "entropies", "Q_values")

    def _enqueue_log(self, step: int, aux):
        """Keep clones of the aux (and AdRIL's diag_* scalars) without a
        host read; `_flush_logs` reads them later."""
        keys = list(self._LOG_KEYS) + [k for k in aux if k.startswith("diag_")]
        self._log_queue.append((step, {k: aux[k].clone() for k in keys}))

    def _flush_logs(self):
        for step, entry in self._log_queue:
            self.metrics["update_steps"].append(step)
            self.metrics["predicted_rewards"].append(entry["predicted_rewards"].tolist())
            self.metrics["alphas"].append(float(entry["alphas"]))
            self.metrics["entropies"].append(entry["entropies"].tolist())
            self.metrics["Q_values"].append(entry["Q_values"].tolist())
            for k, v in entry.items():
                if k.startswith("diag_"):
                    self.metrics.setdefault(k, []).append(float(v))
        self._log_queue.clear()

    def _record_eval(self, step: int):
        """Evaluate (on every rank: its generator is its own) and record;
        rank 0 keeps the best agent."""
        self._flush_logs()
        test_returns = self.evaluate()
        normalized = self._normalized(test_returns)
        self.score.append(float(np.mean(normalized)))
        self.metrics["test_steps"].append(step)
        self.metrics["test_returns"].append(test_returns)
        self.metrics["test_returns_normalized"].append(normalized)
        with self._work("sac.", write=False):  # every rank: rank 0 alone knows the floor
            if not self.writer:
                return
            # iltpu's agent_best: rewritten on a strict improvement over this
            # run's scores and over the score inside an existing snapshot of the
            # port's (one with only iltpu's header.pkl gives no floor)
            best = os.path.join(self.out_dir, self.prefix + "agent_best")
            if not self._best_seeded:
                self._best_seeded = True
                try:
                    self._best_prior = float(load_aux(best)["score"])
                except (OSError, EOFError, KeyError, pickle.UnpicklingError):
                    pass  # no snapshot of the port's, or an unreadable one: no floor
            score = self.score[-1]
            if score > max(max(self.score[:-1], default=float("-inf")), self._best_prior):
                save_checkpoint(best, self._best_tree(step, score),
                                aux={"step": step, "score": score})
        self._plots()  # rank 0 only: the others returned above

    def _plots(self):
        """iltpu's six metric plots (`iltpu/trainer.py:1339-1362`), same names,
        labels and title, through the port's PNG writer."""
        m, pre = self.metrics, os.path.join(self.out_dir, self.prefix)
        cfg = self.cfg
        title = f"{cfg.algorithm}: {cfg.env}"
        if m["test_steps"]:
            lineplot(m["test_steps"], m["test_returns"], pre + "test_returns", title=title)
        if m["train_steps"]:
            lineplot(m["train_steps"], m["train_returns"], pre + "train_returns", title=title)
        if m["update_steps"]:
            if cfg.algorithm != "SAC":
                lineplot(m["update_steps"], m["predicted_rewards"], pre + "predicted_rewards",
                         yaxis="Predicted Reward", title=title)
            lineplot(m["update_steps"], m["alphas"], pre + "sac_alpha", yaxis="Alpha", title=title)
            lineplot(m["update_steps"], m["entropies"], pre + "sac_entropy", yaxis="Entropy",
                     title=title)
            lineplot(m["update_steps"], m["Q_values"], pre + "Q_values", yaxis="Q-value", title=title)

    def _best_tree(self, step: int, score: float) -> Dict:
        return dict(convert.agent_tree(self.sac), step=np.asarray(step), score=np.asarray(score))

    def _save(self):
        """iltpu's run outputs: `agent/` (actor, critic, log_alpha) and, for
        the trained discriminators, `discriminator/`, as checkpoint
        directories in iltpu's leaf order; `metrics.pkl`. Rank 0's only."""
        with self._work("sac.", "disc.", write=False):
            if not self.writer:
                return
            pre = os.path.join(self.out_dir, self.prefix)
            save_checkpoint(pre + "agent", convert.agent_tree(self.sac))
            if self.algorithm in TRAINABLE_DISCRIMINATORS:  # as iltpu: not GMMIL's
                save_checkpoint(pre + "discriminator", convert.disc_params_tree(self))
        with open(pre + "metrics.pkl", "wb") as f:
            pickle.dump(self.metrics, f)

    def _spare_rows(self) -> Dict[str, np.ndarray]:
        """The rings' spare rows (the writes of invalid rows), which iltpu's
        layout has no place for: the port's header keeps them, so a round
        trip restores every state tensor."""
        return {f"{ring}.{k}": getattr(getattr(self, ring), k)[-1].cpu().numpy()
                for ring in ("replay", "expert") for k in COLUMNS}

    def _checkpoint(self, step: int, updates_done: int):
        """The whole state (iltpu's layout) and, in the port's header, the
        step, metrics, score, update count, the generator's state and the
        rings' spare rows. Rank 0's only (every rank gathers the whole
        leaves under the tensor-parallel layout)."""
        self._flush_logs()
        with self._work(write=False):
            if not self.writer:
                return
            save_checkpoint(
                os.path.join(self.out_dir, self.prefix + "checkpoint"),
                convert.train_state_tree(self),
                aux={"step": step, "metrics": self.metrics, "score": self.score,
                     "updates_done": updates_done, "generator": self.gen.get_state().numpy(),
                     "spare_rows": self._spare_rows(), "replay_size": self.replay.size},
            )

    @torch.no_grad()
    def _resume(self, path: str):
        """Copy a checkpoint into the tensors this trainer built (the SAC
        state, the rings, the discriminator's, which other objects share),
        then the generator's state: before any graph is captured, and before
        the tensor-parallel layout keeps its blocks of the whole leaves. The ring
        keeps the checkpoint's size, as iltpu's does (memory.size is
        clamped to the run's steps): a ring of another size is rebuilt
        first, before anything holds it."""
        size = load_aux(path)["replay_size"]
        if size != self.replay.size:
            r = self.replay
            self.replay = replay_init(size, self.state_size, self.action_size, r.absorbing,
                                      self.device)
        tree, aux = load_checkpoint(path, like=convert.train_state_tree(self))
        convert.load_train_state_(self, tree)
        for name, row in aux["spare_rows"].items():
            ring, k = name.split(".")
            getattr(getattr(self, ring), k)[-1].copy_(torch.from_numpy(row))
        self.metrics, self.score = aux["metrics"], aux["score"]
        self.start_step, self.updates_done = aux["step"], aux["updates_done"]
        self.gen.set_state(torch.from_numpy(aux["generator"]))

    def _reset_env(self) -> Dict:
        """The envs' first state, from the trainer's generator; on a resumed
        run (envs are not checkpointed), from the run's seed, as iltpu
        resets them."""
        if self.start_step == 0:
            return self.env.reset()
        return self.env.reset(torch.Generator(self.device).manual_seed(self.cfg.seed))

    # ------------------------------------------------------- pretraining

    def _expert_batch(self):
        return self._samples([(self.expert, self.cfg.training.batch_size, None)])[0]

    def bc_pretrain(self):
        """BC pretraining of the SAC actor with a fresh AdamW state of its
        own (the actor's SAC moments and clock stay untouched)."""
        cfg = self.cfg.bc_pretraining
        p = self.sac["a"]
        with self._work(*ACTOR):
            st = {"p": p, "m": [torch.zeros_like(x) for x in p],
                  "v": [torch.zeros_like(x) for x in p], "t": torch.zeros(1, device=self.device)}
            for _ in range(cfg.iterations):
                behavioural_cloning_update(self.actor, st, self._expert_batch(),
                                           lr=cfg.learning_rate, weight_decay=cfg.weight_decay)

    def pretrain_discriminator(self):
        """DRIL: BC of the dropout ensemble, then its threshold over the
        whole expert buffer; RED: the predictor's regression, then sigma_1
        from the first batch-size expert rows."""
        icfg = self.cfg.imitation
        opt = dict(lr=icfg.learning_rate, weight_decay=icfg.weight_decay, generator=self.gen)
        with self._work(*UPDATE):
            dril = self.algorithm == "DRIL"
            update = behavioural_cloning_update if dril else target_estimation_update
            for _ in range(icfg.pretraining.iterations):
                update(self.disc, self.disc_state, self._expert_batch(),
                       **(dict(train_dropout=True) if dril else {}), **opt)
            with self._work("expert.", write=False):
                states, actions = self.expert.rows("states"), self.expert.rows("actions")
                if dril:
                    self.dril_threshold = self.disc.uncertainty_threshold(
                        states, actions, icfg.quantile_cutoff, generator=self.gen)
                else:
                    B = self.cfg.training.batch_size
                    self.disc.set_sigma(self.disc_state, states[:B], actions[:B])

    # ---------------------------------------------------------------- run

    @torch.no_grad()
    def run(self) -> float:
        cfg = self.cfg
        start_time = time.time()
        fresh = self.start_step == 0  # a resumed run skips the pretraining and prefill
        if cfg.bc_pretraining.iterations > 0 and fresh:
            self.bc_pretrain()
            if self.algorithm == "BC":  # the early exit: evaluate the cloned policy
                if cfg.check_time_usage:
                    self._sync()
                    self.metrics["pre_training_time"] = time.time() - start_time
                test_returns = self.evaluate()
                normalized = self._normalized(test_returns)
                self.metrics["test_steps"] = [0]
                self.metrics["test_returns"] = [test_returns]
                self.metrics["test_returns_normalized"] = [normalized]
                if self.writer:
                    self._plots()
                self._save()
                return float(np.mean(normalized))
        if self.algorithm in ("DRIL", "RED") and fresh:
            self.pretrain_discriminator()
            if cfg.check_time_usage:
                self._sync()
                self.metrics["pre_training_time"] = time.time() - start_time
                start_time = time.time()
        if self.algorithm == "PWIL" and cfg.imitation.mix_expert_data != "none" and fresh:
            # the expert rows' rewards become PWIL's, before any transfer
            with self._work("expert.", write=False):
                self.expert.rows("rewards").copy_(self.disc.relabel(*(
                    self.expert.rows(k) for k in ("states", "actions", "terminals", "timeouts"))))
        if cfg.imitation.mix_expert_data == "prefill_memory" and fresh:
            replay_transfer(self.replay, self.expert)
        # whatever the acting flags say, as iltpu; a MuJoCo env steps on the host loop
        if cfg.training.get("on_device_loop") and not self.host_env:
            self._device_loop()
        else:
            self._host_loop()
        if cfg.check_time_usage:
            self.metrics["training_time"] = time.time() - start_time
            self._record_eval(self.step_done)
        return self._finish()

    def _updates_owed(self, step: int) -> int:
        """The host loop's update count once the iteration that ends at env
        step `step` is done (none before the first): one update per
        `interval` env steps from training.start."""
        t = self.cfg.training
        return (step - t.start) // t.interval + 1 if step >= max(t.start, 1) else 0

    def _host_loop(self):
        """iltpu's host loop (`iltpu/trainer.py:1449-1637`): one iteration at
        a time, the host reading each iteration's rewards and dones. Plain
        acting reads them after the iteration's updates; pipelined acting
        issues the next iteration's act and env step before this one's
        updates and reads through a pinned copy that does not wait for
        them; host acting samples the next actions in numpy while the
        updates run. A MuJoCo env returns its rewards and dones on the host,
        and under pipelined acting steps once the updates are issued, while
        the device runs them. A resumed run continues from the checkpoint's
        step with the update count the schedule had reached there (iltpu's
        restarts from 0 and makes up every update in its first iteration)."""
        cfg = self.cfg
        N = cfg.num_envs
        host_act = bool(cfg.training.get("host_acting"))
        pipeline = bool(cfg.training.get("pipeline")) and not host_act
        env_state = self._reset_env()
        reads = HostReads(self.device)
        train_return = np.zeros(N)
        step = self.start_step
        updates_done = self._updates_owed(step)
        evals_done = step // cfg.evaluation.interval
        logs_done = 0
        # Steady-state window (benchmarks): from the first step >= skip,
        # with timing_marks=K giving K windows.
        timing_skip = int(cfg.training.get("timing_skip_steps", 0) or 0)
        timing_marks = int(cfg.training.get("timing_marks", 0) or 0)
        steady_t0 = steady_step0 = None
        mark_every = next_mark = 0
        acted = pending = None
        self.profiler = window = ProfilerWindow(
            cfg.get("profiling") if self.writer else None, self.device, self.prefix)
        if self.spans is None and window.dir:  # the window's trace shows the spans
            self.spans = Recorder(keep=False)
        sp = window.spans = reads.spans = self.spans
        if self.host_env:
            self.env.spans = sp
        if host_act:
            with self._work(*ACTOR, write=False):
                host_actor = HostActor(self.actor, self.sac["a"])
            act_rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xAC7]))
            obs = self.env.obs if self.host_env else reads.wait(reads.start([env_state["obs"]]))[0]
            actions = host_actor.sample(obs, act_rng)

        while step < cfg.steps:
            window.at(step)
            new_step = step + N
            n_updates = self._updates_owed(new_step) - updates_done
            updates_done += n_updates
            if sp is not None:
                sp.top(step, n_updates)
            if host_act:
                acted = self.act_env(env_state, actions if self.host_env else reads.to_device(actions))
                pending = self._reads(reads, acted[2], env_state)
                aux = self._updates_of(step, self.front_of(step, acted, n_updates), n_updates)
                host_actor.refresh()  # the params of the previous iteration's sync
                with self._work(*ACTOR, write=False):
                    host_actor.start_sync(self.sac["a"])
                rewards, dones, obs = reads.wait(pending)
                actions = host_actor.sample(obs, act_rng)
            elif pipeline:
                if acted is None:
                    acted = self.act_env(env_state)
                    pending = self._reads(reads, acted[2])
                front = self.front_of(step, acted, n_updates)
                mine, fetched = pending, None
                if sp is not None:  # the env step below produces the next iteration's
                    sp.acting = new_step
                if new_step < cfg.steps:  # the next act, from the params before these updates
                    if self.host_env:  # its host step runs once the updates are issued
                        fetched = self.env.fetch(self.sample_actions(env_state))
                    else:
                        acted = self.act_env(env_state)
                        pending = self._reads(reads, acted[2])
                aux = self._updates_of(step, front, n_updates)
                if fetched is not None:
                    acted = self.act_env(env_state, fetched)
                    pending = self._reads(reads, acted[2])
                rewards, dones = reads.wait(mine)
            else:
                out, aux = self.iteration(env_state, step, n_updates)
                rewards, dones = reads.wait(self._reads(reads, out))
            step = new_step
            if steady_t0 is None and timing_skip and step >= timing_skip:
                self._sync()
                steady_t0, steady_step0 = time.time(), step
                if timing_marks > 0:
                    mark_every = max(N, (cfg.steps - steady_step0) // timing_marks)
                    next_mark = steady_step0 + mark_every
                    self.metrics["steady_marks"] = [[int(step), steady_t0]]
            elif steady_t0 is not None and timing_marks > 0 and step >= next_mark:
                self._sync()
                self.metrics["steady_marks"].append([int(step), time.time()])
                while next_mark <= step:
                    next_mark += mark_every

            # the env's reward, also where PWIL's is stored
            train_return += rewards
            for e in np.flatnonzero(dones):
                self.metrics["train_steps"].append(step)
                self.metrics["train_returns"].append([float(train_return[e])])
                train_return[e] = 0.0

            if n_updates > 0 and cfg.logging.interval > 0 and step // cfg.logging.interval > logs_done:
                logs_done = step // cfg.logging.interval
                self._enqueue_log(step, aux)
            if step // cfg.evaluation.interval > evals_done and not cfg.check_time_usage:
                evals_done = step // cfg.evaluation.interval
                self._record_eval(step)
            if cfg.checkpointing.interval > 0 and step % cfg.checkpointing.interval < N:
                self._checkpoint(step, updates_done)
            if sp is not None:
                sp.end()

        window.close()
        if steady_t0 is not None:
            self._sync()
            self.metrics["steady_env_steps"] = step - steady_step0
            self.metrics["steady_time"] = time.time() - steady_t0
            if timing_marks > 0 and step > self.metrics["steady_marks"][-1][0]:
                self.metrics["steady_marks"].append(
                    [int(step), steady_t0 + self.metrics["steady_time"]]
                )
        self.step_done = step
        self.updates_done = updates_done

    def _updates_of(self, step, front, n_updates: int) -> Dict[str, torch.Tensor]:
        """The updates of an iteration whose `front` has run; its aux."""
        aux, batches, expert_batches, draws = front
        if n_updates:
            aux.update(self.run_updates(step, batches, expert_batches, draws, n_updates))
        return aux

    def _device_loop(self):
        """iltpu's on-device loop (`iltpu/trainer.py:1639-1762`): chunks of
        iterations with the host stepping in only between chunks, at the
        metric and eval boundaries; a chunk's rewards and dones come back in
        one read. On the card a chunk replays CUDA graphs
        (`iltpu_torch/graphs.py`), on the CPU it runs the same iterations
        one by one. iltpu's schedule: power-of-two chunks of at most
        `steady` iterations, clipped at training.start and at the end;
        num_envs // interval updates an iteration once past the start, none
        before; the steady marks at chunk granularity; a checkpoint at the
        first chunk end past each multiple of checkpointing.interval."""
        cfg = self.cfg
        N = cfg.num_envs
        interval = cfg.training.interval
        if not (N % interval == 0 or interval >= N):
            raise ValueError(f"num_envs {N} must be compatible with training.interval {interval}")
        upi_steady = max(N // interval, 1) if interval <= N else 1
        env_state = self._reset_env()
        train_return = np.zeros(N)
        ckpt = cfg.checkpointing.interval
        step, updates_done, logs_done = self.start_step, self.updates_done, 0
        evals_done = step // cfg.evaluation.interval
        checks_done = step // ckpt if ckpt > 0 else 0
        timing_skip = int(cfg.training.get("timing_skip_steps", 0) or 0)
        timing_marks = int(cfg.training.get("timing_marks", 0) or 0)
        steady_t0 = steady_step0 = None
        mark_every = next_mark = 0

        cadences = [] if cfg.check_time_usage else [cfg.evaluation.interval]
        if cfg.logging.interval > 0:
            cadences.append(cfg.logging.interval)
        if ckpt > 0:
            cadences.append(ckpt)
        base_iters = min(max(1, min(cadences) // N) if cadences else 1024, 1024)
        steady = 1 << (base_iters.bit_length() - 1)  # pow2 <= base_iters
        if self.device.type == "cuda":
            from iltpu_torch.graphs import ChunkGraphs

            run_chunk = ChunkGraphs(self, steady).run
        else:
            run_chunk = self.run_chunk

        while step < cfg.steps:
            limit = cfg.training.start if step < cfg.training.start else cfg.steps
            want = min(steady, max(1, -(-(limit - step) // N)))
            n_iters = 1 << (want.bit_length() - 1)  # pow2 <= want
            upi = upi_steady if step >= cfg.training.start else 0
            rewards, dones, aux = run_chunk(env_state, step, n_iters, upi)
            rewards, dones = rewards.cpu().numpy(), dones.cpu().numpy()  # the chunk's one read
            for i in range(n_iters):
                train_return += rewards[i]
                for e in np.flatnonzero(dones[i]):
                    self.metrics["train_steps"].append(step + (i + 1) * N)
                    self.metrics["train_returns"].append([float(train_return[e])])
                    train_return[e] = 0.0
            step += n_iters * N
            updates_done += n_iters * upi
            if steady_t0 is None and timing_skip and step >= timing_skip:
                steady_t0, steady_step0 = time.time(), step
                if timing_marks > 0:
                    mark_every = max(N, (cfg.steps - steady_step0) // timing_marks)
                    next_mark = steady_step0 + mark_every
                    self.metrics["steady_marks"] = [[int(step), steady_t0]]
            elif steady_t0 is not None and timing_marks > 0 and step >= next_mark:
                self.metrics["steady_marks"].append([int(step), time.time()])
                while next_mark <= step:
                    next_mark += mark_every

            if upi > 0 and cfg.logging.interval > 0 and step // cfg.logging.interval > logs_done:
                logs_done = step // cfg.logging.interval
                self._enqueue_log(step, aux)
            if step // cfg.evaluation.interval > evals_done and not cfg.check_time_usage:
                evals_done = step // cfg.evaluation.interval
                self._record_eval(step)
            if ckpt > 0 and step // ckpt > checks_done:
                checks_done = step // ckpt
                self._checkpoint(step, updates_done)

        if steady_t0 is not None:
            self.metrics["steady_env_steps"] = step - steady_step0
            self.metrics["steady_time"] = time.time() - steady_t0
            if timing_marks > 0 and step > self.metrics["steady_marks"][-1][0]:
                self.metrics["steady_marks"].append(
                    [int(step), steady_t0 + self.metrics["steady_time"]]
                )
        self.step_done = step
        self.updates_done = updates_done

    def _finish(self) -> float:
        self._flush_logs()
        cfg = self.cfg
        if cfg.render and self.host_env:  # iltpu renders the MuJoCo envs only
            self._render()
        if cfg.save_trajectories and self.host_env:  # gymnasium's envs, whatever the backend
            _, trajectories = evaluate_policy(
                cfg.env, self._greedy_fn(), cfg.evaluation.episodes,
                absorbing=cfg.imitation.absorbing, seed=cfg.seed + 104729, return_trajectories=True)
            if self.writer:
                with open(os.path.join(self.out_dir, self.prefix + "trajectories.pkl"), "wb") as f:
                    pickle.dump(trajectories, f)
        self._save()
        if self.host_env:  # its threads and MuJoCo's data
            self.env.close()
        return float(np.mean(self.score)) if self.score else 0.0


    def _render(self):
        """iltpu's render at the end of a run: a greedy rollout from seed +
        39916801, up to 500 frames, to `<prefix>rollout.npz` and
        `<prefix>rollout.gif` at 30 fps, cast on the trainer's device. Every
        rank rolls out (the actor's reads are collective under the
        tensor-parallel layout); rank 0 renders and writes."""
        cfg = self.cfg
        kw = dict(absorbing=cfg.imitation.absorbing, seed=cfg.seed + 39916801, max_frames=500)
        greedy = self._greedy_fn()
        if not self.writer:
            rollout_scenes(cfg.env, greedy, **kw)
            return
        render_rollout(cfg.env, greedy, os.path.join(self.out_dir, self.prefix + "rollout.npz"),
                       gif_path=os.path.join(self.out_dir, self.prefix + "rollout.gif"), fps=30,
                       device=self.device, **kw)


def train(cfg: Dict, out_dir: str = ".", file_prefix: str = "") -> float:
    """Functional entry point: returns the mean normalized score."""
    return Trainer(cfg, out_dir, file_prefix).run()
