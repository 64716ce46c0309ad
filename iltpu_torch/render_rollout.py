"""Render a greedy rollout of a saved agent as npz frames and an animated
GIF: the port of the repo's `scripts/render_rollout.py`, `python -m
iltpu_torch.render_rollout`.

Loads the actor of an `agent/` directory a finished run of the port writes
(iltpu's own directories pickle a JAX treedef in `header.pkl` and are not
read), infers the absorbing bit from its first layer's width, rolls it out
greedily on the host (`host_greedy_fn`) on the port's stepper and writes
`<out>.npz` (the frame stack) and `<out>.gif` through
`envs.host.render_rollout`: the same flags and defaults as the script.
`--platform cpu|gpu` picks the device the frames are cast on; the default
is the card, which raises without CUDA.

Usage:
  python -m iltpu_torch.render_rollout --env hopper \\
      --agent outputs/GAIL_hopper/<stamp>/agent --out rollout
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env", required=True)
    p.add_argument("--agent", required=True, help="agent checkpoint dir")
    p.add_argument("--out", default="rollout", help="output basename")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=1000)
    p.add_argument("--fps", type=int, default=40)
    p.add_argument("--hidden-size", type=int, default=256)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="where the frames are cast (default: the card, raising without CUDA)")
    args = p.parse_args(argv)

    from iltpu_torch.envs.host import SPECS, render_rollout
    from iltpu_torch.generate_expert_data import checkpoint_actor
    from iltpu_torch.models import SoftActor
    from iltpu_torch.models.host_inference import host_greedy_fn
    from iltpu_torch.trainer import resolve_device

    device = resolve_device(args.platform)
    params = checkpoint_actor(args.agent)
    in_dim = int(params[0].shape[0])
    spec = SPECS[args.env]
    absorbing = in_dim == spec.obs_size + 1
    actor = SoftActor(in_dim, spec.action_size, args.hidden_size, args.depth)
    greedy = host_greedy_fn(actor, params)
    n = render_rollout(
        args.env,
        greedy,
        args.out + ".npz",
        absorbing=absorbing,
        seed=args.seed,
        max_frames=args.max_frames,
        gif_path=args.out + ".gif",
        fps=args.fps,
        device=device,
    )
    print(f"wrote {args.out}.npz / {args.out}.gif ({n} frames)")


if __name__ == "__main__":
    main()
