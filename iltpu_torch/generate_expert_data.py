"""Expert demonstration data in D4RL's transition format, the port of the
repo's `scripts/generate_expert_data.py`: `python -m
iltpu_torch.generate_expert_data`.

Trains a SAC expert through `iltpu_torch.trainer.Trainer` (iltpu's
defaults: the autograd SAC update) into `<dirname(out)>/expert_training`,
or with `--from-checkpoint` takes the actors of saved `agent/` and
`agent_best/` directories of the port's (round robin across attempts);
then rolls out greedy episodes (or `--stochastic` ones, tanh(mean + s
sigma eps)) on the host, one env, keeps those that pass the rejection
filters, and writes `{observations, actions, rewards, next_observations,
terminals, timeouts}` (float32) with `np.savez_compressed`, for
`expert_data.source=<path>.npz`. The seeds, the loop, the filters, the
printed lines and the file are iltpu's: from the same actor parameters on
the same stepper the columns are bit-equal to the script's. The one
difference: an array env (`--env-backend jax`, pointmass or pendulum),
which D4RL does not score, is normalised by its own reference returns, as
the trainer normalises it (iltpu's script raises KeyError there).

`--platform cpu|gpu` is the `platform=` override; the default is the card,
which raises without CUDA, whatever else the flags ask for.

Usage:
  python -m iltpu_torch.generate_expert_data --env hopper --steps 1000000 \\
      --episodes 25 --out data/hopper_expert.npz
  # data/README.md's hopper_expert_v2.npz recipe, from the port's snapshots:
  python -m iltpu_torch.generate_expert_data --env hopper --episodes 26 \\
      --from-checkpoint RUN_A/agent_best,RUN_B/agent_best --stochastic 0.3 \\
      --only-timeout-episodes --min-normalized 0.95 --out data/hopper_expert_v2.npz
"""

import argparse
import os

import numpy as np
import torch

COLUMNS = ("observations", "actions", "rewards", "next_observations", "terminals", "timeouts")


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--env", required=True)
    p.add_argument("--steps", type=int, default=1_000_000)
    p.add_argument("--episodes", type=int, default=25)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--env-backend", default="auto")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="platform= override (default: the card, raising without CUDA)")
    p.add_argument(
        "--from-checkpoint", default=None, metavar="AGENT_DIRS",
        help="skip training; roll out from saved agent checkpoint(s)"
        " (comma-separated `agent/`/`agent_best/` dirs a finished run of the"
        " port writes; attempts round-robin across them). iltpu's own"
        " directories pickle a JAX treedef in header.pkl and are not read",
    )
    p.add_argument(
        "--only-timeout-episodes", action="store_true",
        help="keep only episodes that survive to the time limit (D4RL"
        " expert-v2 demos are timeout-ended; terminal-ended demos poison"
        " AdRIL/SQIL via the absorbing wrap)",
    )
    p.add_argument(
        "--stochastic", type=float, default=0.0, metavar="SCALE",
        help="sample actions tanh(mean + SCALE*sigma*eps) instead of greedy"
        " (small action noise diversifies the visited states; reject"
        " sampling then keeps the survivors)",
    )
    p.add_argument(
        "--min-normalized", type=float, default=None,
        help="reject episodes below this D4RL-normalized return"
        " (e.g. 0.95: near-expert survivors only)",
    )
    p.add_argument("--max-attempts", type=int, default=None,
                   help="rollout attempts cap with rejection filters"
                   " (default: 10x episodes)")
    return p


def overrides(args):
    """The script's config overrides (`scripts/generate_expert_data.py:74-89`),
    then `platform=` where given."""
    out = [
        "algorithm=SAC",
        f"env={args.env}",
        f"env_backend={args.env_backend}",
        f"seed={args.seed}",
        f"num_envs={args.num_envs}",
        f"steps={args.steps}",
        "logging.interval=0",
        f"evaluation.interval={max(args.steps // 10, 1)}",
        "evaluation.episodes=5",
        "imitation.absorbing=false",  # raw obs; wrapping happens at load
        "expert_data.source=synthetic",
        "imitation.trajectories=1",
    ]
    return out + ([f"platform={args.platform}"] if args.platform else [])


def _make_env(cfg, num_envs: int, seed: int, device):
    """iltpu's `_make_env`: a host-API env of `cfg.env_backend`."""
    from iltpu_torch.envs.vecenv import host_env

    return host_env(cfg.env, num_envs, absorbing=cfg.imitation.absorbing, seed=seed,
                    backend=cfg.env_backend, device=device)


def normalized_score(name: str, env, ret: float) -> float:
    """D4RL's normalisation for the MuJoCo envs; an array env's own
    reference returns for the others, as the trainer's."""
    from iltpu_torch.envs.scores import SPECS, d4rl_normalized_score

    if name in SPECS:
        return d4rl_normalized_score(name, ret)
    return (ret - env.ref_min_score) / (env.ref_max_score - env.ref_min_score)


def checkpoint_actor(path: str):
    """The actor's leaves [W1, b1, W2, b2, ...] (W as (in, out)) of an
    `agent/` or `agent_best/` directory the port wrote (`convert.agent_tree`,
    plus `step` and `score` in `agent_best/`)."""
    from iltpu_torch.utils.checkpoint import load_leaves

    leaves = load_leaves(path)
    out, i = [], 0
    while f"['actor']['layers'][{i}]['w']" in leaves:
        out += [leaves[f"['actor']['layers'][{i}]['{k}']"] for k in ("w", "b")]
        i += 1
    if not out:
        raise ValueError(f"{path} holds no actor layers: {sorted(leaves)[:4]} ...")
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in out]


def main(argv=None):
    args = parser().parse_args(argv)

    from iltpu_torch.config import load_config
    from iltpu_torch.models import SoftActor
    from iltpu_torch.models.host_inference import HostActor, host_greedy_fn
    from iltpu_torch.trainer import Trainer, resolve_device

    cfg = load_config(overrides(args))
    device = resolve_device(cfg.get("platform"))  # the card unless asked for the CPU

    noise_rng = np.random.default_rng(args.seed + 99)

    def _policy_from_params(actor, params, raw_dim):
        """obs (B, raw_dim) -> actions; greedy or sigma-scaled stochastic,
        with absorbing-bit padding when the agent trained on augmented obs
        (the demo stores RAW observations: the loader re-wraps them)."""
        in_dim = int(params[0].shape[0])
        assert in_dim in (raw_dim, raw_dim + 1), (in_dim, raw_dim)
        if args.stochastic > 0:
            ha = HostActor(actor, params)
            scale = args.stochastic

            def base(obs):
                mean, log_std = ha._forward(obs)
                eps = noise_rng.standard_normal(mean.shape).astype(np.float32)
                return np.tanh(mean + scale * np.exp(log_std) * eps)
        else:
            base = host_greedy_fn(actor, params)
        if in_dim == raw_dim + 1:
            def policy(obs):
                pad = np.zeros((obs.shape[0], 1), np.float32)
                return base(np.concatenate([obs, pad], axis=1))
            return policy
        return base

    env0 = _make_env(cfg, 1, args.seed, device)
    raw_dim, act_dim = env0.obs_size, env0.action_size
    env0.close()
    if args.from_checkpoint:
        rcfg = cfg.reinforcement
        policies = []
        for path in args.from_checkpoint.split(","):
            params = checkpoint_actor(path)
            actor = SoftActor(int(params[0].shape[0]), act_dim, rcfg.actor.hidden_size,
                              rcfg.actor.depth, rcfg.actor.activation, device="cpu")
            policies.append(_policy_from_params(actor, params, raw_dim))
    else:
        out_dir = os.path.join(os.path.dirname(args.out) or ".", "expert_training")
        os.makedirs(out_dir, exist_ok=True)
        trainer = Trainer(cfg, out_dir)
        score = trainer.run()
        print(f"expert trained: mean normalized score {score:.3f}")
        # host inference from one copy of the parameters: no device call a step
        policies = [_policy_from_params(trainer.actor, trainer.sac["a"], raw_dim)]

    env = _make_env(cfg, 1, args.seed + 7_654_321, device)
    cols = {k: [] for k in COLUMNS}
    kept, attempt = 0, 0
    max_attempts = args.max_attempts or 10 * args.episodes
    while kept < args.episodes and attempt < max_attempts:
        obs = env.reset(args.seed + 1000 + attempt)
        policy = policies[attempt % len(policies)]
        attempt += 1
        done = False
        ep_ret = 0.0
        ep_cols = {k: [] for k in cols}
        while not done:
            action = policy(np.asarray(obs))
            next_obs, r, term, to, obs_after = env.step(action)
            ep_cols["observations"].append(obs[0])
            ep_cols["actions"].append(action[0])
            ep_cols["rewards"].append(float(r[0]))
            ep_cols["next_observations"].append(next_obs[0])
            ep_cols["terminals"].append(float(term[0]))
            ep_cols["timeouts"].append(float(to[0]))
            ep_ret += float(r[0])
            done = bool(term[0] or to[0])
            obs = obs_after
        timed_out = bool(ep_cols["timeouts"][-1])
        norm = normalized_score(args.env, env, ep_ret)
        why = None
        if args.only_timeout_episodes and not timed_out:
            why = "terminal"
        elif args.min_normalized is not None and norm < args.min_normalized:
            why = f"norm {norm:.2f} < {args.min_normalized}"
        if why:
            print(f"attempt {attempt} (policy {(attempt - 1) % len(policies)}):"
                  f" return {ep_ret:.1f} norm {norm:.2f}"
                  f" ({len(ep_cols['rewards'])} steps) — dropped ({why})")
            continue
        kept += 1
        for k in cols:
            cols[k].extend(ep_cols[k])
        print(f"episode {kept}/{args.episodes}: return {ep_ret:.1f}"
              f" norm {norm:.2f} ({len(ep_cols['rewards'])} steps,"
              f" {'timeout' if timed_out else 'terminal'})")
    env.close()
    if kept < args.episodes:
        print(f"WARNING: only {kept}/{args.episodes} episodes kept after"
              f" {attempt} attempts")

    arrays = {k: np.asarray(v, np.float32) for k, v in cols.items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {arrays['observations'].shape[0]} transitions, "
          f"{kept} episodes")
    return args.out


if __name__ == "__main__":
    main()
