"""Time PWIL's transport kernel across checkouts, or across edited copies of
its source, on one CUDA card. Run by path from a checkout's root:

    python3 iltpu_torch/pwil_compare.py DIR [DIR ...]   # each checkout's own kernel
    python3 iltpu_torch/pwil_compare.py --variants      # variants of this tree's kernel

Checkouts: each DIR is a checkout of this repo (say a `git archive` of the
parent commit and one of this tree, given in turns: parent change change
parent). Each is timed in a process of its own, with its own package and
its own chip_smoke helpers, on chip_smoke 3f's first four cases: 512
pools of 505 atoms (d 7, T 100: pointmass-sized), 512 x 25,000 and 64 x
100,000 atoms (d 15) and the 25-segment relabelling of 25,000 rows. Device
ms a call: the median of CUDA events around each call queued behind a
sleep kernel (`chip_smoke.device_ms`). One JSON line per DIR.

Variants: copies of `csrc/pwil_transport.cu` with its constants edited
(atoms a lane per step U, features loaded at once FC, CTAs an SM asked of
the 512-thread kernel) or with work taken out to attribute a pass's time
(the atom loads, the pool loads, the merges: these compute something
else). Each is built with nvcc under `iltpu_torch/_build/variants/`,
checked against the tree's kernel (pools and rewards equal) and timed on
the same four cases. One JSON line per case, then the card's name and
power limit.
"""

import json
import os
import subprocess
import sys

CASES = (  # (name, pools, atoms, features, rows, T, segments)
    ("pointmass_sized", 512, 505, 7, 512, 100, False),
    ("pwil25_hopper", 512, 25000, 15, 512, 1000, False),
    ("pools64_100k", 64, 100000, 15, 64, 1000, False),
    ("relabel", 25, 25000, 15, 25000, 1000, True),
)
NO_ATOM_LOADS = ("__ldg(row + u * 32)", "__int_as_float(0x3f800000 + ((base + lane + u + f) & 255))")
NO_POOL_LOADS = ("next[u] = j < j1 ? pool[j] : 0.f;", "next[u] = j < j1 ? 1e-4f : 0.f;")
NO_MERGES = ("const bool take = key < cut;", "const bool take = false;")
VARIANTS = {  # name: (U, FC of the 512- and 128-thread kernels, CTAs an SM, edits)
    "base": (4, 8, 4, 1, ()),
    "u2_fc8_2cta": (2, 8, 4, 2, ()),
    "u4_fc4_2cta": (4, 4, 4, 2, ()),
    "u2_fc16": (2, 16, 8, 1, ()),
    "u1_fc16_2cta": (1, 16, 8, 2, ()),
    "no_atom_loads": (4, 8, 4, 1, (NO_ATOM_LOADS,)),
    "no_pool_loads": (4, 8, 4, 1, (NO_POOL_LOADS,)),
    "no_merges": (4, 8, 4, 1, (NO_MERGES,)),
    "no_loads_no_merges": (4, 8, 4, 1, (NO_ATOM_LOADS, NO_POOL_LOADS, NO_MERGES)),
}


def _inputs(cs, dev, case):
    name, P, N, d, R, T, segments = case
    a, pools, q, off, reset, kw = cs.pwil_case(dev, P, N, d, R, T, segments, N)
    # an env step with every row resetting its pool does the same work each call
    return a, pools, q, off, reset if segments else reset.fill_(True), kw


def one_checkout(root):
    """This process times `root`'s own kernel."""
    sys.path[0] = root
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from iltpu_torch.ops import build
    from iltpu_torch.ops.pwil_transport import pwil_transport

    build.build_all(("pwil_transport",))
    dev = torch.device("cuda")
    out = {}
    for case in CASES:
        a, pools, q, off, reset, kw = _inputs(cs, dev, case)
        out[case[0]] = cs.device_ms(lambda: pwil_transport(a, pools, q, off, reset, **kw),
                                    n=10 if case[6] else 60)
    print(json.dumps({"checkout": root, "device_ms": out}), flush=True)


def variants(root):
    sys.path[0] = root
    os.chdir(root)
    import ctypes
    import torch
    import chip_smoke as cs
    from iltpu_torch.ops import build
    from iltpu_torch.ops import pwil_transport as pt

    src = open(os.path.join(build.CSRC, "pwil_transport.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (U, fc_big, fc_small, ctas, edits) in VARIANTS.items():
        s = src
        for old, new in (("constexpr int U = 4;", f"constexpr int U = {U};"),
                         ("T == 128 ? 4 : 1", f"T == 128 ? 4 : {ctas}"),
                         ("pwil_kernel<SMALL, 4> : pwil_kernel<BIG, 8>",
                          f"pwil_kernel<SMALL, {fc_small}> : pwil_kernel<BIG, {fc_big}>"), *edits):
            if old not in s:
                raise SystemExit(f"pwil_compare: variant {name}: {old!r} is not in the source")
            s = s.replace(old, new)
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(s)
        cmd = [build._nvcc(), build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", os.path.join(out_dir, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"pwil_compare: nvcc failed on {name}:\n{log[-3000:]}")
        regs = [line.split("info    : ")[-1] for line in log.splitlines() if "Used" in line]
        lib = pt._bind(ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so")))
        lib.iltpu_pwil_active_clusters.argtypes = [ctypes.c_int]
        lib.iltpu_pwil_active_clusters.restype = ctypes.c_int
        libs[name] = lib
        print(json.dumps({"variant": name, "ptxas": regs, "clusters_at_once":
                          {c: lib.iltpu_pwil_active_clusters(c) for c in range(2, 9)}}))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for case in CASES:
        a, pools, q, off, reset, kw = _inputs(cs, dev, case)
        ref = pools.clone()
        want = pt.pwil_transport(a, ref, q, off, reset, **kw)
        row = {}
        for name, lib in libs.items():
            kp = pools.clone()
            got = pt.launch(lib, a, kp, q, off, reset, **kw, stream=stream)
            ms = cs.device_ms(lambda: pt.launch(lib, a, kp, q, off, reset, **kw, stream=stream),
                              n=10 if case[6] else 60)
            row[name] = {"ms": ms, "cluster": lib.iltpu_pwil_cluster_size(case[1], case[2]),
                         "equal": torch.equal(kp, ref) and torch.equal(got, want)}
        print(json.dumps({"case": case[0], "variants": row}), flush=True)


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = sys.argv[1:]
    if not args:
        raise SystemExit(__doc__)
    if args[0] == "--one":
        one_checkout(os.path.abspath(args[1]))
        return
    if args == ["--variants"]:
        variants(here)
    else:
        for root in args:
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", os.path.abspath(root)],
                           check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
