"""Build the CUDA sources under `iltpu_torch/csrc/` with nvcc and load them.

Each source `csrc/<name>.cu` is compiled on its own into a shared library
with a plain C interface (`nvcc -shared`, no PyTorch headers, so a build
takes seconds), for the H100 (`sm_90a`), at first use. The library lands
in `iltpu_torch/_build/<name>-<hash>/`, keyed by a hash of the sources, so an
edit rebuilds and an unchanged tree reuses the build. `build_all` starts one
nvcc per source, all at once. Nothing here runs at import time.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NAMES = ("sac_update", "gail_update", "kblock_update", "gaussian_rowsum")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if not found and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if not found:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def _sources(name: str) -> List[str]:
    return [os.path.join(CSRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path(name: str) -> str:
    h = hashlib.sha256(ARCH.encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}")
    return os.path.join(out_dir, f"lib{name}.so")


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for one source unless its library exists; None if built."""
    lib = library_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, f"{name}.cu"),
    ]
    log = open(os.path.join(os.path.dirname(lib), "build.log"), "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc.tmp, proc.lib, proc.log = tmp, lib, log
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc.log.close()
    if rc != 0 or not os.path.exists(proc.tmp):
        with open(proc.log.name) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"nvcc failed to build {name} (rc {rc}):\n{tail}")
    os.replace(proc.tmp, proc.lib)


def build_all(names=NAMES) -> float:
    """Build every missing library, one nvcc per source in parallel;
    returns the wall seconds taken."""
    t0 = time.time()
    procs = {n: _start(n) for n in names}
    for n, p in procs.items():
        _finish(n, p)
    return time.time() - t0


def build_log(name: str) -> str:
    path = os.path.join(os.path.dirname(library_path(name)), "build.log")
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed."""
    if name not in _loaded:
        _finish(name, _start(name))
        _loaded[name] = ctypes.CDLL(library_path(name))
    return _loaded[name]
