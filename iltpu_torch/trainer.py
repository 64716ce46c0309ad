"""Training orchestrator: the port of `iltpu/trainer.py`.

One iteration steps `num_envs` array envs on the device, appends the step to
the replay ring (absorbing wrap inline), takes ONE bulk sample of
n_updates x batch rows from the replay and from the expert buffer, then
runs n_updates per-update bodies, and samples the next actions from the
freshly updated actor. Every tensor stays on the device; the host reads
only the episode ends once per iteration.

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
- AdRIL/SQIL: the balanced (or half-batch) relabelling.
- DRIL: +-1 from the dropout ensemble's uncertainty against its threshold.
- RED: exp(-sigma_1 * the predictor's error).
- SAC and BC: the env's reward.

The SAC step is the SAC kernel (`training.sac_pallas=true`) or the autograd
`SACLearner.update`; both update the same flat state. Before the loop:
BC pretraining (and BC's early exit), DRIL's ensemble and RED's predictor
pretraining, and the `prefill_memory` transfer, as plain Python loops.

On the card the kernels of `iltpu_torch/csrc/` run; on the CPU
(platform=cpu) their plain versions. Entry points run on the card
(`platform` null or gpu) and raise when CUDA is missing. PWIL, the GAIL
input options (shaping, log-pi, state-only, Mixup with alpha != 1),
pipelined or host acting, the on-device loop, other env backends, data
parallelism, checkpointing and the profiler window raise
NotImplementedError naming the ROADMAP.md item that will bring them;
kernel flags that iltpu refuses raise iltpu's ValueError.
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
    replay_transfer,
)
from iltpu_torch.envs import make_env
from iltpu_torch.models import SoftActor, TwinCritic
from iltpu_torch.models.actor import DRIL_ENSEMBLE_SIZE
from iltpu_torch.ops.gail_update import GAILHyper, gail_update
from iltpu_torch.ops.kblock_update import kblock_update
from iltpu_torch.ops.sac_update import sac_update
from iltpu_torch.rewards import (
    GAILDiscriminator,
    GMMILDiscriminator,
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

TRAINABLE_DISCRIMINATORS = ("DRIL", "GAIL", "RED")


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
    """Raise for what the port cannot run: ValueError where iltpu refuses
    the configuration too, NotImplementedError otherwise."""
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
    checks = [
        (alg != "PWIL", f"algorithm={alg}", "Other algorithms"),
        (not t.get("pipeline") and not t.get("host_acting"),
         "training.pipeline/host_acting", "Pipelined and host acting"),
        (not t.get("on_device_loop"), "training.on_device_loop", "On-device loop"),
        (cfg.env_backend == "jax", f"env_backend={cfg.env_backend}", "Native hopper env"),
        (cfg.parallel.get("data_axis") is None, "parallel.data_axis", "Data parallel"),
        (cfg.checkpointing.interval == 0 and cfg.checkpointing.resume is None,
         "checkpointing", "Checkpoint and resume"),
        (not (cfg.get("profiling") or {}).get("trace_dir"), "profiling.trace_dir", "Tooling"),
    ]
    if alg == "GAIL":
        checks += [
            (icfg.get("loss_function") != "Mixup" or icfg.get("mixup_alpha") == 1,
             "imitation.mixup_alpha != 1", "GAIL options"),
            (not d.get("reward_shaping") and not d.get("subtract_log_policy")
             and not icfg.get("state_only"),
             "GAIL shaping/log-pi/state-only", "GAIL options"),
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
        elif alg == "AdRIL":
            self.relabel = init_relabeller(dev)

        self.metrics = dict(
            train_steps=[], train_returns=[], test_steps=[], test_returns=[],
            test_returns_normalized=[], update_steps=[], predicted_rewards=[],
            alphas=[], entropies=[], Q_values=[],
        )
        self.score = []
        self._log_queue = []
        self.step_done = self.updates_done = 0

    # ------------------------------------------------------------ updates

    def draw_noise(self, n_updates: int) -> Dict[str, torch.Tensor]:
        """Every per-update draw of one iteration, in bulk from the trainer's
        generator, each with a leading n_updates axis (the replay and expert
        sample integers are drawn by replay_sample when absent): GAIL's
        penalty interpolation `eps_gp` and Mixup draw `mix`, SAC's `eps2` and
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
            noise["mix"] = torch.rand((n_updates, B), generator=g, device=dev)  # Beta(1, 1)
        if self.algorithm == "DRIL":
            masks = self.disc.net.draw_masks((n_updates, DRIL_ENSEMBLE_SIZE, B), g)
            noise.update({f"dril_mask{k}": m for k, m in enumerate(masks) if m is not None})
        return noise

    @torch.no_grad()
    def transition_core(
        self, step: int, obs, actions, rewards, next_obs, terminals, timeouts,
        n_updates: int, noise: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Ring append, then n_updates per-update bodies on one bulk
        sample. `noise` injects the draws of `draw_noise` and the raw
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
        draws = {k: v for k, v in noise.items() if k not in ("replay", "expert")}
        K = self.update_block
        if self.algorithm == "GAIL" and self.fused_scan and K > 1 and n_updates % K == 0:
            def chunks(d):
                return {k: v.reshape((n_updates // K, K) + v.shape[1:]) for k, v in d.items()}

            pb, eb, nz = chunks(batches), chunks(expert_batches), chunks(draws)
            for c in range(n_updates // K):
                out = kblock_update(
                    self.learner.hyper, self.disc_hyper, self.sac, self.disc_state,
                    {k: v[c] for k, v in pb.items()}, {k: v[c] for k, v in eb.items()},
                    {k: v[c] for k, v in nz.items()},
                )
            return {"discriminator_loss": out["loss"][0], "predicted_rewards": out["rewards"],
                    "alphas": out["alpha"], "entropies": -out["log_probs"],
                    "Q_values": out["Q_values"]}
        for i in range(n_updates):
            aux = self.update(
                step, {k: v[i] for k, v in batches.items()},
                {k: v[i] for k, v in expert_batches.items()}, {k: v[i] for k, v in draws.items()},
            )
        return aux

    def update(self, step: int, tb, eb, nz) -> Dict[str, torch.Tensor]:
        """One update (iltpu's `update_fn`) on the policy batch `tb`, the
        expert batch `eb` and this update's draws `nz`: the reward -> mixing
        -> BC auxiliary step -> SAC step. Returns the aux."""
        alg, icfg = self.algorithm, self.cfg.imitation
        aux = {}
        if alg == "GAIL":
            if self.disc_pallas:
                d_loss, gail_rewards = gail_update(
                    self.disc_hyper, self.disc_state, eb["states"], eb["actions"], eb["weights"],
                    tb["states"], tb["actions"], tb["weights"], nz["eps_gp"], nz.get("mix"),
                )
                aux["discriminator_loss"] = d_loss[0]
            else:
                aux["discriminator_loss"] = adversarial_imitation_update(
                    self.disc, self.disc_state, tb, eb, self.adv_cfg, nz["eps_gp"], nz.get("mix"))
        if icfg.mix_expert_data == "mixed_batch" and alg != "AdRIL":
            tb = mix_expert_agent_transitions(tb, eb)
        tb = dict(tb)
        if alg == "AdRIL":
            # diagnostics of the raw policy batch, before the relabelling
            if icfg.update_freq > 0:
                stale = round_of(step, icfg.update_freq) > torch.ceil(tb["step"] / icfg.update_freq)
                aux["diag_adril_stale_frac"] = stale.float().mean()
            aux["diag_num_trajectories"] = self.replay.num_trajectories.float()
            self.relabel, tb = resample_and_relabel(
                self.relabel, tb, eb, step, self.replay.num_trajectories,
                self.expert.num_trajectories, update_freq=icfg.update_freq, balanced=icfg.balanced,
            )
            aux["diag_relabel_reward_mean"] = tb["rewards"].mean()
        elif alg == "DRIL":
            masks = [nz.get(f"dril_mask{k}") for k in range(self.disc.net.n_layers)]
            tb["rewards"] = self.disc.dril_reward(tb["states"], tb["actions"], self.dril_threshold, masks)
        elif alg == "GAIL":
            tb["rewards"] = (gail_rewards if self.disc_pallas
                             else self.disc.predict_reward(tb["states"], tb["actions"], self.disc_state))
        elif alg == "GMMIL":
            self.disc_state, tb["rewards"] = self.disc.predict_reward(
                self.disc_state, tb["states"], tb["actions"], eb["states"], eb["actions"],
                tb["weights"], eb["weights"],
            )
        elif alg == "RED":
            tb["rewards"] = self.disc.predict_reward(self.disc_state, tb["states"], tb["actions"])
        if icfg.bc_aux_loss:
            # on the SAC actor's own AdamW state, in place, before the SAC step reads it
            behavioural_cloning_update(self.actor, actor_opt_state(self.sac), eb,
                                       lr=self.learner.lr, weight_decay=self.learner.weight_decay)
        if self.sac_pallas:
            out = sac_update(self.learner.hyper, self.sac, tb, nz["eps2"], nz["eps_new"])
        else:
            out = self.learner.update(self.sac, tb, nz["eps2"], nz["eps_new"])
        aux.update(predicted_rewards=tb["rewards"], alphas=out["alpha"],
                   entropies=-out["log_probs"], Q_values=out["Q_values"])
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
        if self.algorithm in TRAINABLE_DISCRIMINATORS:  # as iltpu: not GMMIL's
            with open(pre + "discriminator.pkl", "wb") as f:
                pickle.dump(self._disc_params(), f)
        with open(pre + "metrics.pkl", "wb") as f:
            pickle.dump(self.metrics, f)

    def _disc_params(self):
        """The discriminator's parameters in iltpu's layout (numpy)."""
        if self.algorithm == "GAIL":
            return convert.disc_tree(self.disc_state)["params"]
        if self.algorithm == "DRIL":
            return convert.opt_tree(self.disc_state)["params"]
        tree = convert.red_tree(self.disc_state)
        return {"predictor": tree["params"], "target": tree["target"],
                "sigma_1": tree["sigma_1"], "sigma_set": tree["sigma_set"]}

    # ------------------------------------------------------- pretraining

    def _expert_batch(self):
        return replay_sample(self.expert, self.cfg.training.batch_size, self.gen)

    def bc_pretrain(self):
        """BC pretraining of the SAC actor with a fresh AdamW state of its
        own (the actor's SAC moments and clock stay untouched)."""
        cfg = self.cfg.bc_pretraining
        p = self.sac["a"]
        st = {"p": p, "m": [torch.zeros_like(x) for x in p], "v": [torch.zeros_like(x) for x in p],
              "t": torch.zeros(1, device=self.device)}
        for _ in range(cfg.iterations):
            behavioural_cloning_update(self.actor, st, self._expert_batch(),
                                       lr=cfg.learning_rate, weight_decay=cfg.weight_decay)

    def pretrain_discriminator(self):
        """DRIL: BC of the dropout ensemble, then its threshold over the
        whole expert buffer; RED: the predictor's regression, then sigma_1
        from the first batch-size expert rows."""
        icfg = self.cfg.imitation
        opt = dict(lr=icfg.learning_rate, weight_decay=icfg.weight_decay, generator=self.gen)
        states, actions = self.expert.rows("states"), self.expert.rows("actions")
        if self.algorithm == "DRIL":
            for _ in range(icfg.pretraining.iterations):
                behavioural_cloning_update(self.disc, self.disc_state, self._expert_batch(),
                                           train_dropout=True, **opt)
            self.dril_threshold = self.disc.uncertainty_threshold(
                states, actions, icfg.quantile_cutoff, generator=self.gen)
        else:
            for _ in range(icfg.pretraining.iterations):
                target_estimation_update(self.disc, self.disc_state, self._expert_batch(), **opt)
            B = self.cfg.training.batch_size
            self.disc.set_sigma(self.disc_state, states[:B], actions[:B])

    # ---------------------------------------------------------------- run

    @torch.no_grad()
    def run(self) -> float:
        cfg = self.cfg
        start_time = time.time()
        if cfg.bc_pretraining.iterations > 0:
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
                self._save()
                return float(np.mean(normalized))
        if self.algorithm in ("DRIL", "RED"):
            self.pretrain_discriminator()
            if cfg.check_time_usage:
                self._sync()
                self.metrics["pre_training_time"] = time.time() - start_time
                start_time = time.time()
        if cfg.imitation.mix_expert_data == "prefill_memory":
            replay_transfer(self.replay, self.expert)
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
