"""Animated GIF89a without PIL: the port's `save_frames_gif`.

`save_frames_gif(frames, path, fps)` writes what iltpu's PIL call
(`iltpu/envs/host.py` `save_frames_gif`: `save_all`, `duration=max(1000 //
fps, 10)`, `loop=0`) writes: one image per frame, each with a graphics
control block holding the delay (in hundredths of a second, `duration //
10`, as PIL stores it) and a NETSCAPE2.0 application block looping
forever. Each frame gets its own 256-colour palette, chosen in numpy by
`quantize` (median cut over the frame's colours, the box with the largest
squared error split at the weighted median of its widest channel, each
colour the count-weighted mean of its box), as PIL's RGB -> P conversion
chooses an adaptive palette per frame. The LZW compression runs in C++
(`iltpu_torch/native/gif_lzw.cc`), built with g++ at first use into
`iltpu_torch/_build/gif_lzw-<hash>/`.
"""

import ctypes
import hashlib
import heapq
import os
import struct
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "native", "gif_lzw.cc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"gif_lzw-{digest}", "libgiflzw.so")


def ensure_built() -> str:
    """Compile the LZW coder unless built; return its path. It lands by
    rename, so processes building at once never load a partial file."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", SRC, "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed to build the GIF coder (rc {r.returncode}):\n"
                           f"{r.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


_lib = None


def load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.gif_lzw_encode.restype = ctypes.c_int64
        lib.gif_lzw_encode.argtypes = [u8, ctypes.c_int64, ctypes.c_int, u8, ctypes.c_int64]
        _lib = lib
    return _lib


def lzw(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """An image's table-based data: the LZW minimum code size, the
    compressed indices in sub-blocks, the terminator."""
    idx = np.ascontiguousarray(indices, np.uint8).ravel()
    cap = 2 * idx.size + 1024
    out = np.empty(cap, np.uint8)
    n = load().gif_lzw_encode(idx, idx.size, min_code_size, out, cap)
    if n < 0:
        raise RuntimeError("the GIF coder's output outgrew its buffer")
    return out[:n].tobytes()


def _split(colors, weights, members):
    """Split one box at the weighted median of its widest (largest
    variance) channel: the two member sets and the squared error of each
    (from prefix sums over the sorted members)."""
    c = colors[members]
    w = weights[members]
    mean = (c * w[:, None]).sum(0) / w.sum()
    order = np.argsort(c[:, int(np.argmax((w[:, None] * (c - mean) ** 2).sum(0)))], kind="stable")
    c, w = c[order], w[order]
    cw = np.cumsum(w)
    cut = int(np.searchsorted(cw, cw[-1] / 2.0, side="right"))
    cut = min(max(cut, 1), len(order) - 1)
    s1 = np.cumsum(c * w[:, None], 0)
    s2 = np.cumsum(c * c * w[:, None], 0)
    lo = float((s2[cut - 1] - s1[cut - 1] ** 2 / cw[cut - 1]).sum())
    hi_w, hi_s1, hi_s2 = cw[-1] - cw[cut - 1], s1[-1] - s1[cut - 1], s2[-1] - s2[cut - 1]
    hi = float((hi_s2 - hi_s1 ** 2 / hi_w).sum())
    return members[order[:cut]], members[order[cut:]], max(lo, 0.0), max(hi, 0.0)


def quantize(frame: np.ndarray, colors: int = 256):
    """A (colors, 3) uint8 palette and the (H, W) uint8 indices of an
    (H, W, 3) uint8 frame. A frame of at most `colors` colours keeps them
    exactly; else median cut."""
    px = frame.reshape(-1, 3)
    key = (px[:, 0].astype(np.int32) << 16) | (px[:, 1].astype(np.int32) << 8) | px[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    cols = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1).astype(np.float64)
    palette = np.zeros((colors, 3), np.uint8)
    if len(uniq) <= colors:
        palette[:len(uniq)] = cols.astype(np.uint8)
        return palette, inv.astype(np.uint8).reshape(frame.shape[:2])
    w = counts.astype(np.float64)
    boxes = [np.arange(len(uniq))]
    heap = [(-np.inf, 0)]  # (-squared error, box); the first box is split first
    while len(boxes) < colors and heap:
        neg, b = heapq.heappop(heap)
        if neg == 0:
            break
        lo, hi, sse_lo, sse_hi = _split(cols, w, boxes[b])
        boxes[b] = lo
        boxes.append(hi)
        for k, sse in ((b, sse_lo), (len(boxes) - 1, sse_hi)):
            if len(boxes[k]) > 1:
                heapq.heappush(heap, (-sse, k))
    lut = np.zeros(len(uniq), np.uint8)
    for k, members in enumerate(boxes):
        lut[members] = k
        mean = (cols[members] * w[members, None]).sum(0) / w[members].sum()
        palette[k] = np.clip(np.round(mean), 0, 255).astype(np.uint8)
    return palette, lut[inv].reshape(frame.shape[:2])


def encode(frames: np.ndarray, fps: int = 30) -> bytes:
    """The GIF89a bytes of an (N, H, W, 3) uint8 frame stack."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8 or not len(frames):
        raise ValueError(f"want (N, H, W, 3) uint8 frames, got {frames.shape} {frames.dtype}")
    n, h, w, _ = frames.shape
    delay = max(1000 // fps, 10) // 10  # PIL's duration in hundredths of a second
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),  # no global colour table
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]  # loop forever
    for frame in frames:
        palette, idx = quantize(frame)
        out.append(b"\x21\xf9\x04" + struct.pack("<BHB", 0x00, delay, 0) + b"\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87))  # local table of 256
        out.append(palette.tobytes())
        out.append(lzw(idx))
    out.append(b"\x3b")
    return b"".join(out)


def save_frames_gif(frames: np.ndarray, gif_path: str, fps: int = 30) -> None:
    """Write an (N, H, W, 3) uint8 frame stack as an animated GIF (iltpu's
    `save_frames_gif`, without PIL)."""
    data = encode(frames, fps)
    with open(gif_path, "wb") as f:
        f.write(data)
