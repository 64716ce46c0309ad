"""Hold the GAIL step of several checkouts to each other on one CUDA card.
Run by path from a checkout's root:

    python3 iltpu_torch/gail_compare.py DIR [DIR ...]

Each DIR is a checkout of this repo, or a directory holding its
`iltpu_torch` package (say a `git archive` of the parent commit). Each runs
in a process of its own, with its own package and its own build of
`gail_update`, three chained steps of every configuration in CONFIGS at
every shape in SHAPES that its kernel takes (a checkout that refuses a
shape skips it), from seeded states and batches, and records the variant
its route ran at each shape. Every later DIR is then compared with the
first over the outputs both made (losses, rewards, the parameters,
spectral-norm vectors, AdamW moments and step clock): where both ran a
tiled variant every tensor must be equal bit for bit; elsewhere (a wide
variant on either side) the tensors are reported as changed, with the
largest difference and the elements past the chain tolerance (rtol 1e-4,
atol 1e-5). One JSON line per later DIR, then the card's name and power
limit; exits 1 if a tensor of a shape tiled on both sides differs.
"""

import json
import os
import subprocess
import sys

# (B, D, Hd): shapes a tiled variant took or takes (the route keeps the tiled
# variants at inputs up to 8 and batches up to 256, and at inputs up to 16,
# batches up to 128 and widths up to 64), then shapes only the wide variant
# takes
SHAPES = ((256, 7, 64), (256, 15, 64), (256, 24, 64), (128, 24, 32), (256, 15, 128),
          (1024, 15, 64), (256, 5, 32), (512, 7, 128), (128, 15, 64), (128, 15, 32),
          (256, 7, 128), (100, 15, 64),
          (1024, 120, 128), (256, 120, 64), (1024, 24, 128), (1024, 15, 128), (128, 120, 32))
TOL = (1e-4, 1e-5)  # rtol, atol: the chain tolerance of chip_smoke.py
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
    saved, variants = {}, {}
    for B, D, Hd in SHAPES:
        S, A = SPLIT[D]
        try:
            gu.smem_bytes(B, D, Hd)
        except NotImplementedError:
            continue
        variants[f"B={B} D={D} Hd={Hd}"] = gu.variant(B, D, Hd)
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
    torch.save({"tensors": {k: v.cpu() for k, v in saved.items()}, "variants": variants}, out)


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
    first = outs[0]
    shape_of = lambda k: " ".join(k.split()[:3])  # "B=.. D=.. Hd=.."
    for d, got in zip(dirs[1:], outs[1:]):
        common = [k for k in first["tensors"] if k in got["tensors"]]
        tiled = [k for k in common if first["variants"][shape_of(k)] == got["variants"][shape_of(k)]
                 == "tiled"]
        differ = [k for k in tiled if not torch.equal(first["tensors"][k], got["tensors"][k])]
        changed, worst, past = [], 0.0, 0
        for k in common:
            if k in tiled:
                continue
            a, b = got["tensors"][k], first["tensors"][k]
            if not torch.equal(a, b):
                changed.append(k)
                err = (a - b).abs()
                worst = max(worst, float(err.max()))
                past += int((err > TOL[1] + TOL[0] * b.abs()).sum())
        bad |= bool(differ)
        print(json.dumps({
            "dir": d, "against": dirs[0], "tensors": len(got["tensors"]), "compared": len(common),
            "tiled_on_both": len(tiled), "tiled_differ": len(differ), "first_differing": differ[:5],
            "wide_on_either": len(common) - len(tiled), "wide_changed": len(changed),
            "wide_max_abs_diff": worst, "wide_elements_past_chain_tol": past,
            "route_changed": sorted(k for k in got["variants"] if k in first["variants"]
                                    and got["variants"][k] != first["variants"][k])}))
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
