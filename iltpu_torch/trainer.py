"""Training orchestrator: the port of `iltpu/trainer.py` for the GAIL
fused-update path (per update or K-blocked) and GMMIL on the SAC kernel.

One iteration steps `num_envs` array envs on the device, appends the step to
the replay ring (absorbing wrap inline), takes ONE bulk sample of
n_updates x batch rows from the replay and from the expert buffer, then
runs n_updates x (reward -> SAC kernel) on the flat update states, and
samples the next actions from the freshly updated actor. Every tensor stays
on the device; the host reads only the episode ends once per iteration. On
the card the updates are the hand-written kernels of `iltpu_torch/csrc/`;
on the CPU (platform=cpu) their plain versions. The reward is:

- GAIL: the GAIL kernel's discriminator step + reward head. With
  `training.update_block=K > 1`, an iteration whose n_updates K divides
  runs n_updates / K launches of the K-blocked kernel (K x GAIL -> SAC in
  one launch); the others run the per-update kernels, as iltpu does.
- GMMIL: the MMD witness reward through the row-sum kernel, with the
  bandwidths set on the first update.

Entry points run on the card (`platform` null or gpu) and raise when CUDA
is missing; `platform=cpu` selects the CPU. This slice supports exactly the
kernel paths: training.sac_pallas true; for GAIL also disc_pallas and
fused_update_scan true and the BCE or Mixup (alpha 1) configuration; for
GMMIL disc_pallas and fused_update_scan false (iltpu refuses both, with a
ValueError); no pipeline or host acting, env_backend=jax, no expert mixing
or bc_aux_loss. Anything else raises NotImplementedError naming the
ROADMAP.md item that will bring it.
"""

import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from iltpu_torch import convert
from iltpu_torch.config import DotDict, validate_config
from iltpu_torch.data import (
    build_expert_transitions,
    random_d4rl_dataset,
    replay_append_batch,
    replay_from_transitions,
    replay_init,
    replay_sample,
)
from iltpu_torch.envs import make_env
from iltpu_torch.models import SoftActor, TwinCritic
from iltpu_torch.ops.gail_update import GAILHyper, gail_update
from iltpu_torch.ops.kblock_update import kblock_update
from iltpu_torch.ops.sac_update import sac_update
from iltpu_torch.rewards import GAILDiscriminator, GMMILDiscriminator
from iltpu_torch.updates import SACLearner


def resolve_device(platform: Optional[str]) -> torch.device:
    """`cpu` selects the CPU; null or `gpu` the card, raising without CUDA."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform in (None, "gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"platform={platform} runs on the GPU, and CUDA is not available; "
                "pass platform=cpu to run on the CPU"
            )
        return torch.device("cuda")
    raise ValueError(f"unknown platform {platform!r}: cpu or gpu")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, '{item}'"
    )


def check_supported(cfg: DotDict) -> None:
    """Raise for anything off this slice's paths: ValueError where iltpu
    refuses the configuration too, NotImplementedError otherwise."""
    t, icfg, rcfg = cfg.training, cfg.imitation, cfg.reinforcement
    alg = cfg.algorithm
    if alg == "GMMIL" and t.get("fused_update_scan"):
        raise ValueError(
            "training.fused_update_scan=true requires algorithm=GAIL with training.sac_pallas "
            "and training.disc_pallas, no bc_aux_loss, and a single-device (mesh-free) run"
        )
    if alg == "GMMIL" and t.get("disc_pallas"):
        raise ValueError(
            "training.disc_pallas=true supports the BCE and Mixup GAIL configurations; "
            f"got algorithm={alg}"
        )
    checks = [
        (alg in ("GAIL", "GMMIL"), f"algorithm={alg}", "Other algorithms"),
        (t.get("sac_pallas") is True, "training.sac_pallas=false", "Autograd updates"),
        (not t.get("pipeline") and not t.get("host_acting"),
         "training.pipeline/host_acting", "Pipelined and host acting"),
        (not t.get("on_device_loop"), "training.on_device_loop", "On-device loop"),
        (cfg.env_backend == "jax", f"env_backend={cfg.env_backend}", "Native hopper env"),
        (icfg.get("mix_expert_data") == "none" and not icfg.get("bc_aux_loss"),
         "expert mixing/bc_aux_loss", "Other algorithms"),
        (all(rcfg[n]["depth"] == 2 and rcfg[n]["activation"] == "relu" for n in ("actor", "critic")),
         "actor/critic other than depth-2 relu", "Autograd updates"),
        (cfg.bc_pretraining.iterations == 0, "bc_pretraining", "Other algorithms"),
        (cfg.parallel.get("data_axis") is None, "parallel.data_axis", "Data parallel"),
        (cfg.checkpointing.interval == 0 and cfg.checkpointing.resume is None,
         "checkpointing", "Checkpoint and resume"),
        (not (cfg.get("profiling") or {}).get("trace_dir"), "profiling.trace_dir", "Tooling"),
    ]
    if alg == "GAIL":
        d = icfg.get("discriminator") or {}
        checks += [
            (t.get("disc_pallas") is True, "training.disc_pallas=false", "Autograd updates"),
            (t.get("fused_update_scan") is True, "training.fused_update_scan=false",
             "Autograd updates"),
            (icfg.get("loss_function") in ("BCE", "Mixup"),
             f"imitation.loss_function={icfg.get('loss_function')}", "GAIL options"),
            (icfg.get("loss_function") != "Mixup" or icfg.get("mixup_alpha") == 1,
             "imitation.mixup_alpha != 1", "GAIL options"),
            (not d.get("reward_shaping") and not d.get("subtract_log_policy")
             and not icfg.get("state_only"),
             "GAIL shaping/log-pi/state-only", "GAIL options"),
            (d.get("depth") == 1 and d.get("activation") == "relu",
             "a discriminator other than depth-1 relu", "GAIL options"),
        ]
    for ok, what, item in checks:
        if not ok:
            raise _not_ported(what, item)


def _load_expert_dataset(cfg: DotDict, env) -> Dict[str, np.ndarray]:
    src = cfg.expert_data.source
    if src == "npz" or str(src).endswith(".npz") or (cfg.expert_data.path or "").endswith(".npz"):
        path = src if str(src).endswith(".npz") else cfg.expert_data.path
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    if src != "synthetic":
        raise _not_ported(f"expert_data.source={src}", "Tooling")
    raw_obs = env.obs_size - (1 if cfg.imitation.absorbing else 0)
    n_traj = max(cfg.imitation.trajectories, 10)
    length = min(env.max_episode_steps, 100)
    return random_d4rl_dataset(
        np.random.default_rng(cfg.seed), [length] * n_traj, raw_obs, env.action_size
    )


class Trainer:
    def __init__(self, cfg: Dict, out_dir: str = ".", file_prefix: str = ""):
        self.cfg = cfg = validate_config(cfg)
        check_supported(cfg)
        self.device = dev = resolve_device(cfg.get("platform"))
        self.out_dir = out_dir
        self.prefix = file_prefix
        os.makedirs(out_dir, exist_ok=True)
        self.gen = torch.Generator(device=dev).manual_seed(cfg.seed)

        self.env = make_env(cfg.env, cfg.num_envs, absorbing=cfg.imitation.absorbing,
                            device=dev, generator=self.gen)
        S, A = self.env.obs_size, self.env.action_size
        self.state_size, self.action_size = S, A
        self.norm_min = self.env.env.ref_min_score
        self.norm_max = self.env.env.ref_max_score

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

        self.algorithm = cfg.algorithm
        self.update_block = int(cfg.training.get("update_block", 1) or 1)
        self.disc_hyper = None
        if self.algorithm == "GMMIL":
            self.disc = GMMILDiscriminator(S, A, state_only=icfg.state_only)
            self.disc_state = self.disc.init(dev)
        else:
            d = icfg.discriminator
            self.disc = GAILDiscriminator(
                S, A,
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

        self.metrics = dict(
            train_steps=[], train_returns=[], test_steps=[], test_returns=[],
            test_returns_normalized=[], update_steps=[], predicted_rewards=[],
            alphas=[], entropies=[], Q_values=[],
        )
        self.score = []
        self._log_queue = []

    # ------------------------------------------------------------ updates

    def draw_noise(self, n_updates: int) -> Dict[str, torch.Tensor]:
        """Every per-update draw of one iteration, in bulk from the trainer's
        generator (the replay and expert sample integers are drawn by
        replay_sample when absent)."""
        B, A, g, dev = self.cfg.training.batch_size, self.action_size, self.gen, self.device
        noise = {}
        if self.disc_hyper is not None:
            noise["eps_gp"] = torch.rand((n_updates, B), generator=g, device=dev)
        noise["eps2"] = torch.randn((n_updates, B, A), generator=g, device=dev)
        noise["eps_new"] = torch.randn((n_updates, B, A), generator=g, device=dev)
        if self.disc_hyper is not None and self.disc_hyper.loss_function == "Mixup":
            noise["mix"] = torch.rand((n_updates, B), generator=g, device=dev)  # Beta(1, 1)
        return noise

    def transition_core(
        self, step: int, obs, actions, rewards, next_obs, terminals, timeouts,
        n_updates: int, noise: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Ring append, then n_updates x (reward -> SAC step) on one bulk
        sample. `noise` injects eps_gp, eps2, eps_new, mix and the raw
        replay and expert sample integers (`replay`, `expert`)."""
        n = obs.shape[0]
        step_ids = torch.full((n,), float(step + 1), device=self.device)
        replay_append_batch(self.replay, step_ids, obs, actions, rewards, next_obs,
                            terminals, timeouts)
        if n_updates == 0:
            return {}
        if noise is None:
            noise = self.draw_noise(n_updates)
        B = self.cfg.training.batch_size

        def bulk(rs, r):
            batch = replay_sample(rs, n_updates * B, self.gen, r)
            return {k: v.reshape((n_updates, B) + v.shape[1:]) for k, v in batch.items()}

        batches = bulk(self.replay, noise.get("replay"))
        expert_batches = bulk(self.expert, noise.get("expert"))
        hyper = self.learner.hyper
        K = self.update_block
        if self.algorithm == "GAIL" and K > 1 and n_updates % K == 0:
            def chunks(d):
                return {k: v.reshape((n_updates // K, K) + v.shape[1:]) for k, v in d.items()}

            pb, eb = chunks(batches), chunks(expert_batches)
            nz = chunks({k: v for k, v in noise.items() if k not in ("replay", "expert")})
            for c in range(n_updates // K):
                out = kblock_update(
                    hyper, self.disc_hyper, self.sac, self.disc_state,
                    {k: v[c] for k, v in pb.items()}, {k: v[c] for k, v in eb.items()},
                    {k: v[c] for k, v in nz.items()},
                )
            aux = {"discriminator_loss": out["loss"][0], "predicted_rewards": out["rewards"]}
        else:
            mix = noise.get("mix")
            aux = {}
            for i in range(n_updates):
                tb = {k: v[i] for k, v in batches.items()}
                eb = {k: v[i] for k, v in expert_batches.items()}
                if self.algorithm == "GMMIL":
                    self.disc_state, tb["rewards"] = self.disc.predict_reward(
                        self.disc_state, tb["states"], tb["actions"], eb["states"],
                        eb["actions"], tb["weights"], eb["weights"],
                    )
                else:
                    d_loss, tb["rewards"] = gail_update(
                        self.disc_hyper, self.disc_state,
                        eb["states"], eb["actions"], eb["weights"],
                        tb["states"], tb["actions"], tb["weights"],
                        noise["eps_gp"][i], None if mix is None else mix[i],
                    )
                    aux["discriminator_loss"] = d_loss[0]
                out = sac_update(hyper, self.sac, tb, noise["eps2"][i], noise["eps_new"][i])
            aux["predicted_rewards"] = tb["rewards"]
        aux.update(alphas=out["alpha"], entropies=-out["log_probs"], Q_values=out["Q_values"])
        return aux

    def post_step(self, step, obs, actions, rewards, next_obs, terminals, timeouts,
                  next_policy_obs, n_updates):
        """transition_core, then the NEXT actions from the updated actor."""
        aux = self.transition_core(step, obs, actions, rewards, next_obs, terminals,
                                   timeouts, n_updates)
        next_actions = self.actor.sample(next_policy_obs, generator=self.gen)[0]
        return aux, next_actions

    # ------------------------------------------------------------- phases

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def evaluate(self):
        cfg = self.cfg
        n = cfg.evaluation.episodes
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 7919)
        env = make_env(cfg.env, n, absorbing=cfg.imitation.absorbing, device=self.device,
                       generator=gen)
        st = env.reset()
        done = torch.zeros(n, dtype=torch.bool, device=self.device)
        returns = torch.zeros(n, device=self.device)
        while not bool(done.all()):
            st, out = env.step(st, self.actor.greedy_action(st["obs"]))
            returns += torch.where(done, 0.0, out["reward"])
            done |= out["done"]
        return returns.tolist()

    def _normalized(self, returns):
        return ((np.asarray(returns) - self.norm_min) / (self.norm_max - self.norm_min)).tolist()

    _LOG_KEYS = ("predicted_rewards", "alphas", "entropies", "Q_values")

    def _enqueue_log(self, step: int, aux):
        self._log_queue.append((step, {k: aux[k].clone() for k in self._LOG_KEYS}))

    def _flush_logs(self):
        for step, entry in self._log_queue:
            self.metrics["update_steps"].append(step)
            self.metrics["predicted_rewards"].append(entry["predicted_rewards"].tolist())
            self.metrics["alphas"].append(float(entry["alphas"]))
            self.metrics["entropies"].append(entry["entropies"].tolist())
            self.metrics["Q_values"].append(entry["Q_values"].tolist())
        self._log_queue.clear()

    def _record_eval(self, step: int):
        self._flush_logs()
        test_returns = self.evaluate()
        normalized = self._normalized(test_returns)
        self.score.append(float(np.mean(normalized)))
        self.metrics["test_steps"].append(step)
        self.metrics["test_returns"].append(test_returns)
        self.metrics["test_returns_normalized"].append(normalized)

    def _save(self):
        pre = os.path.join(self.out_dir, self.prefix)
        tree = convert.sac_tree(self.sac)
        agent = {k: tree[k] for k in ("actor_params", "critic_params", "log_alpha")}
        with open(pre + "agent.pkl", "wb") as f:
            pickle.dump(agent, f)
        if self.algorithm == "GAIL":  # iltpu saves no GMMIL discriminator
            with open(pre + "discriminator.pkl", "wb") as f:
                pickle.dump(convert.disc_tree(self.disc_state)["params"], f)
        with open(pre + "metrics.pkl", "wb") as f:
            pickle.dump(self.metrics, f)

    # ---------------------------------------------------------------- run

    @torch.no_grad()
    def run(self) -> float:
        cfg = self.cfg
        start_time = time.time()
        self._host_loop()
        if cfg.check_time_usage:
            self.metrics["training_time"] = time.time() - start_time
            self._record_eval(self.step_done)
        return self._finish()

    def _host_loop(self):
        cfg = self.cfg
        N = cfg.num_envs
        env_state = self.env.reset()
        obs = env_state["obs"]
        train_return = torch.zeros(N, device=self.device)
        updates_done = evals_done = logs_done = 0
        step = 0
        # Steady-state window (benchmarks): from the first step >= skip,
        # with timing_marks=K giving K windows.
        timing_skip = int(cfg.training.get("timing_skip_steps", 0) or 0)
        timing_marks = int(cfg.training.get("timing_marks", 0) or 0)
        steady_t0 = steady_step0 = None
        mark_every = next_mark = 0

        actions = self.actor.sample(obs, generator=self.gen)[0]
        while step < cfg.steps:
            env_state, out = self.env.step(env_state, actions)
            train_return += out["reward"]
            new_step = step + N
            # one update per `interval` env steps, whatever num_envs is
            n_updates = 0
            if new_step >= cfg.training.start:
                target = (new_step - cfg.training.start) // cfg.training.interval + 1
                n_updates = int(target - updates_done)
                updates_done = target
            aux, actions = self.post_step(
                step, obs, actions, out["reward"], out["next_obs"], out["terminal"],
                out["timeout"], env_state["obs"], n_updates,
            )
            step = new_step
            obs = env_state["obs"]
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

            done = out["done"]
            ended = torch.nonzero(done).flatten().tolist()  # the one host read
            if ended:
                for r in train_return[ended].tolist():
                    self.metrics["train_steps"].append(step)
                    self.metrics["train_returns"].append([r])
                train_return[done] = 0.0

            if n_updates > 0 and cfg.logging.interval > 0 and step // cfg.logging.interval > logs_done:
                logs_done = step // cfg.logging.interval
                self._enqueue_log(step, aux)
            if step // cfg.evaluation.interval > evals_done and not cfg.check_time_usage:
                evals_done = step // cfg.evaluation.interval
                self._record_eval(step)

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

    def _finish(self) -> float:
        self._flush_logs()
        self._save()
        return float(np.mean(self.score)) if self.score else 0.0


def train(cfg: Dict, out_dir: str = ".", file_prefix: str = "") -> float:
    """Functional entry point: returns the mean normalized score."""
    return Trainer(cfg, out_dir, file_prefix).run()
