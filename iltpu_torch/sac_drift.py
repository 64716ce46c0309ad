"""Where the SAC kernel's float32 state drifts from a float64 run, phase by
phase, on ant's rows. Run by path from a checkout's root, on one CUDA card:

    python3 iltpu_torch/sac_drift.py

GAIL on ant's stepper rows as chip_smoke.py's phase 11 runs it (batch 16,
full widths, the SAC and GAIL kernels on the card; `check_against_cpu`'s
setup): after the first chunk of 8 updates, each SAC update of the second
chunk is computed three ways from the card's state and batch before it:
the card's kernel (its scratch buffers read back where the library says
`sac::carve` puts them, and the state it leaves), and the plain version
(`sac_update_plain`, its intermediates traced) in float32 and in float64
on the CPU. For each buffer (`sac::BUFFER_NAMES`: the products and
elementwise phases in update order) and each leaf of the critic's state
after its AdamW and Polyak step, it prints the card's and
the CPU's largest error against float64 over the chunk (buffers relative
to the buffer's largest magnitude, the state elementwise relative) and the
ratio of the two; then the card's and the CPU's whole-state distance from
the float64 run in units of the chain tolerance after each chunk
(chip_smoke's `distance_from`), and the card's name and power limit.

    python3 iltpu_torch/sac_drift.py --kblock

The K-blocked check's 5-step chains at ant's shapes (chip_smoke's
`kblock_case`, state 112, action 8, batch 256, both GAIL configurations x
min_alpha 0 and 0.05), run per update three ways: the GAIL and SAC kernels
(what the K-blocked kernel computes bit for bit), the plain GAIL step with
the SAC kernel, and both plain; each one's SAC and discriminator state's
distance from the same chain in float64 (the plain GAIL formulas and the
autograd SAC update), in units of the chain tolerance.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def layout(lib, B, S, A, H):
    """The kernel's scratch buffers at a shape, as the library carves them:
    name -> (offset, floats)."""
    names = lib.iltpu_sac_buffer_names().decode().split()
    out = (ctypes.c_longlong * (2 * len(names)))()
    lib.iltpu_sac_buffers(B, S, A, H, out)
    return {n: (out[2 * i], out[2 * i + 1]) for i, n in enumerate(names)}


def kblock_chains(cs, dev):
    """--kblock: the 5-step chains, three ways against float64."""
    import torch

    from iltpu_torch.ops import gail_update as gu
    from iltpu_torch.ops import sac_update as su

    for bce in (True, False):
        for min_alpha in (0.0, 0.05):
            sh, gh, sac_st, disc_st, batches, expert, noise = cs.kblock_case(112, 8, 5, bce,
                                                                              min_alpha, dev)
            mix = noise.get("mix")
            f64 = cs.float64_sac(cs.learner_of(sh, 112, 8, 256, dev))
            runs = {n: (cs.clone(sac_st), cs.clone(disc_st)) for n in ("kernels", "plain GAIL",
                                                                        "plain", "float64")}
            for k in range(5):
                tb = {key: v[k] for key, v in batches.items()}
                g_args = (expert["states"][k], expert["actions"][k], expert["weights"][k],
                          tb["states"], tb["actions"], tb["weights"], noise["eps_gp"][k],
                          None if mix is None else mix[k])
                for n, (s, d) in runs.items():
                    if n == "kernels":
                        r = gu.gail_update(gh, d, *g_args)[1]
                    elif n == "float64":
                        wide = {key: [t.double() for t in v] if isinstance(v, list) else v.double()
                                for key, v in d.items()}
                        r = gu.gail_update_plain(gh, wide, *[None if x is None else x.double()
                                                             for x in g_args])[1].float()
                        for (_, t), (_, w) in zip(cs.leaves(d), cs.leaves(wide)):
                            t.copy_(w)
                    else:
                        r = gu.gail_update_plain(gh, d, *g_args)[1]
                    b = dict(tb, rewards=r)
                    if n == "float64":
                        f64(s, b, noise["eps2"][k], noise["eps_new"][k])
                    elif n == "plain":
                        su.sac_update_plain(sh, s, b, noise["eps2"][k], noise["eps_new"][k])
                    else:
                        su.sac_update(sh, s, b, noise["eps2"][k], noise["eps_new"][k])
            torch.cuda.synchronize()
            ref_sac, ref_disc = (list(cs.leaves(x)) for x in runs["float64"])
            line = []
            for n in ("kernels", "plain GAIL", "plain"):
                (ds, ps), (dd, pd) = (cs.distance_from(ref, cs.leaves(x), cs.TOL_CHAIN)
                                      for ref, x in zip((ref_sac, ref_disc), runs[n]))
                line.append(f"{n}: SAC {ds:.3g} ({ps} past), GAIL {dd:.3g} ({pd})")
            print(f"{'BCE' if bce else 'Mixup'} min_alpha {min_alpha}, 5 steps, x the chain "
                  "tolerance from float64: " + "; ".join(line), flush=True)


def main():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from iltpu_torch import convert
    from iltpu_torch import trainer as trainer_mod
    from iltpu_torch.config import load_config
    from iltpu_torch.ops import build, operands
    from iltpu_torch.ops import sac_update as su
    from iltpu_torch.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("sac_drift: CUDA is not available; it measures the card's kernel")
    dev = torch.device("cuda")
    build.build_all(("sac_update", "gail_update"))
    if sys.argv[1:] == ["--kblock"]:
        kblock_chains(cs, dev)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        return
    args = [a for a in cs.TRAINER_ARGS if not a.startswith(("num_envs", "steps", "memory"))]
    args += ["num_envs=4", "steps=300", "memory.size=1000", "training.batch_size=16",
             f"output_dir={os.path.join(ROOT, 'outputs', 'sac_drift')}", *cs.native_env("ant")]
    out_dir = os.path.join(ROOT, "outputs", "sac_drift")
    gpu = Trainer(load_config(args), out_dir=out_dir)
    cpu = Trainer(load_config(args + ["platform=cpu"]), out_dir=out_dir)
    ref = Trainer(load_config(args + ["platform=cpu"]), out_dir=out_dir)
    ref.sac_pallas, ref.learner.update, ref.update_block = False, cs.float64_sac(ref.learner), 1
    for t in (cpu, ref):
        convert.load_sac_tree_(t.sac, convert.sac_tree(gpu.sac))
        cs.sync_disc(t, gpu)
    lib = su._bind(build.load("sac_update"))
    lib.iltpu_sac_buffer_names.restype = ctypes.c_char_p
    lib.iltpu_sac_buffers.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    stats = {}

    def as_(st, dtype):  # a copy
        return {k: [t.to("cpu", dtype, copy=True) for t in v] if isinstance(v, list)
                else v.to("cpu", dtype, copy=True) for k, v in st.items()}

    def measured(h, st, tb, eps2, eps_new):
        """The kernel's update, its scratch kept; the plain version's from
        the same state in float64 and in float32, its intermediates traced."""
        B, S = tb["states"].shape
        A, H = eps2.shape[1], st["a"][0].shape[1]
        before = as_(st, torch.float64)
        outs = su.outputs(B, dev)
        scratch = torch.zeros(lib.iltpu_sac_scratch_floats(B, S, A, H), device=dev)
        ptrs = su.pack(operands.Table(), st, tb, eps2, eps_new, outs)
        aux = su.launch(lib, h, ptrs, (B, S, A, H), outs, scratch, operands.stream(scratch.device))
        su.sac_update.launches += 1
        card = scratch.cpu().double()
        traced = {}
        for dtype in (torch.float64, torch.float32):
            plain, trace = as_(before, dtype), {}
            su.sac_update_plain(h, plain, {k: v.to("cpu", dtype) for k, v in tb.items()},
                                eps2.to("cpu", dtype), eps_new.to("cpu", dtype), trace)
            trace.update((path, t) for path, t in cs.leaves(plain)
                         if path.split("[")[0] in ("c", "cm", "cv", "t"))
            traced[dtype] = trace
        r64, r32 = traced[torch.float64], traced[torch.float32]
        after, buffers = dict(cs.leaves(st)), layout(lib, B, S, A, H)
        for name, want in r64.items():
            want = want.flatten()
            if name in after:  # the critic's state: elementwise relative
                got = after[name].cpu().double().flatten()
                rel = lambda x: float(((x - want).abs() / (want.abs() + 1e-30)).max())
            else:  # a buffer: relative to its largest magnitude
                off, n = buffers[name]
                got = card[off:off + n]
                scale = float(want.abs().max()) or 1.0
                rel = lambda x: float((x - want).abs().max()) / scale
            e = stats.setdefault(name, [0.0, 0.0])
            e[0], e[1] = max(e[0], rel(got)), max(e[1], rel(r32[name].double().flatten()))
        return aux

    g = torch.Generator().manual_seed(11)
    rows = cs.native_rows("ant")
    orig = trainer_mod.sac_update
    for it in range(3):
        data = rows()
        noise = cpu.draw_noise(8)
        for key in ("replay", "expert"):
            noise[key] = torch.randint(0, 2**62, (8 * 16,), generator=g)
        cpu.transition_core(it * 4, *data, 8, noise=noise)
        ref.transition_core(it * 4, *data, 8, noise=noise)
        trainer_mod.sac_update = measured if it == 1 else orig
        try:
            gpu.transition_core(it * 4, *[x.to(dev) for x in data], 8,
                                noise={k: v.to(dev) for k, v in noise.items()})
        finally:
            trainer_mod.sac_update = orig
        (card, n_card), (host, n_host) = (cs.distance_from(cs.leaves(ref.sac), cs.leaves(t.sac),
                                                           cs.TOL_CHAIN) for t in (gpu, cpu))
        print(f"chunk {it + 1}: the card {card:.3g} x the chain tolerance from float64 ({n_card} "
              f"past), the CPU {host:.3g} x ({n_host})", flush=True)
    print("chunk 2, largest error against float64 (card / CPU = ratio):")
    for name, (card, host) in stats.items():
        print(f"  {name:6s} {card:.3g} / {host:.3g} = {card / max(host, 1e-30):.2f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
