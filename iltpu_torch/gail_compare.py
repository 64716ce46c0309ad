"""Hold the GAIL step of several checkouts to each other bit for bit on one
CUDA card. Run by path from a checkout's root:

    python3 iltpu_torch/gail_compare.py DIR [DIR ...]

Each DIR is a checkout of this repo, or a directory holding its
`iltpu_torch` package (say a `git archive` of the parent commit). Each runs
in a process of its own, with its own package and its own build of
`gail_update`, three chained steps of every configuration in CONFIGS at
every shape in SHAPES that its kernel takes (the tiled variants' shapes,
then the wide variant's; a checkout that refuses a shape skips it), from
seeded states and batches. Every later DIR is then compared with the first
over the outputs both made (losses, rewards, the parameters, spectral-norm
vectors, AdamW moments and step clock). One JSON line per later DIR (the
tensors compared and how many differ), then the card's name and power
limit; exits 1 if any tensor differs.
"""

import json
import os
import subprocess
import sys

# (B, D, Hd): the tiled variants' (inputs up to 32), then the wide variant's
SHAPES = ((256, 7, 64), (256, 15, 64), (256, 24, 64), (128, 24, 32), (256, 15, 128),
          (1024, 15, 64), (256, 5, 32), (512, 7, 128),
          (1024, 120, 128), (256, 120, 64), (1024, 24, 128), (1024, 15, 128), (128, 120, 32))
SPLIT = {5: (4, 1), 7: (5, 2), 15: (12, 3), 24: (18, 6), 120: (112, 8)}  # D: (S, A) of the envs
# (loss, reward function, spectral norm, gradient penalty, entropy bonus)
CONFIGS = (("BCE", "AIRL", True, 1.0, 0.0), ("Mixup", "GAIL", False, 10.0, 0.0),
           ("BCE", "FAIRL", True, 0.0, 0.01), ("Mixup", "AIRL", True, 1.0, 0.01))


def run(out):
    """In a child whose sys.path starts with the checkout: every output of
    the checkout's GAIL step, saved to `out`."""
    import torch
    from iltpu_torch.ops import gail_update as gu
    from iltpu_torch.rewards import GAILDiscriminator

    dev = torch.device("cuda")
    saved = {}
    for B, D, Hd in SHAPES:
        S, A = SPLIT[D]
        try:
            gu.smem_bytes(B, D, Hd)
        except NotImplementedError:
            continue
        for loss_fn, rf, sn, gp, ent in CONFIGS:
            g = torch.Generator(device=dev).manual_seed(B + D + Hd)
            st = GAILDiscriminator(S, A, hidden_size=Hd, spectral_norm=sn, reward_function=rf,
                                   device=dev).init(g)
            h = gu.GAILHyper(gp, 3e-4, 1e-2, rf, loss_fn, ent)
            key = f"B={B} D={D} Hd={Hd} {loss_fn} {rf} sn={sn} gp={gp} ent={ent}"
            for i in range(3):
                r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
                u = lambda n: torch.rand(n, generator=g, device=dev)
                batch = [r(B, S), torch.tanh(r(B, A)), 1 + 0.5 * u(B), r(B, S),
                         torch.tanh(r(B, A)), 1 + 0.5 * u(B), u(B)]
                mix = u(B) if loss_fn == "Mixup" else None
                loss, rewards = gu.gail_update(h, st, *batch, mix)
                saved[f"{key} step {i} loss"], saved[f"{key} step {i} rewards"] = loss, rewards
            for name in ("p", "sn", "m", "v"):
                for j, t in enumerate(st[name] or []):
                    saved[f"{key} {name}[{j}]"] = t
            saved[f"{key} t"] = st["t"]
    torch.save({k: v.cpu() for k, v in saved.items()}, out)


def main(dirs):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gail_compare: CUDA is not available; it runs the card's kernels")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    work = os.path.join(here, "iltpu_torch", "_build", "gail_compare")
    os.makedirs(work, exist_ok=True)
    outs = []
    for i, d in enumerate(dirs):
        out = os.path.join(work, f"{i}.pt")
        # this file runs the checkout's package (which may lack this file)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--run", os.path.abspath(d), out],
                       check=True)
        outs.append(torch.load(out))
    bad = False
    for d, got in zip(dirs[1:], outs[1:]):
        common = [k for k in outs[0] if k in got]
        differ = [k for k in common if not torch.equal(outs[0][k], got[k])]
        bad |= bool(differ)
        print(json.dumps({"dir": d, "against": dirs[0], "tensors": len(got), "compared": len(common),
                          "differ": len(differ), "first_differing": differ[:5]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run"]:
        sys.path[0] = sys.argv[2]  # the checkout's package, not this file's folder
        run(sys.argv[3])
    elif len(sys.argv) < 3:
        raise SystemExit(__doc__)
    else:
        main(sys.argv[1:])
