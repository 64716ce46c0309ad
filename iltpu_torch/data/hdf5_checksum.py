"""Jenkins' lookup3 hash as HDF5 uses it (the file format specification's
"checksum" of every version-2 structure: the superblock v2/v3, `OHDR` and
`OCHK` blocks, fractal heaps, v2 B-trees, fixed and extensible arrays),
and the ValueError every module of the reader raises for what it does not
read. Standard library only.
"""

import struct

ITEM = "HDF5 newer formats"
M = 0xFFFFFFFF


def refuse(what: str) -> ValueError:
    """The error for a structure outside the reader: it names ROADMAP.md's item."""
    return ValueError(f"{what} is not read by the port's HDF5 reader: ROADMAP.md, '{ITEM}'")


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & M


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' `hashlittle` over `data` (little-endian 32-bit words, the
    last block zero-padded), 32 bits."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & M
    if n == 0:
        return c
    tail = n - ((n - 1) // 12) * 12  # the last block holds 1 to 12 bytes
    words = struct.unpack(f"<{(n - tail) // 4}I", data[:n - tail])
    for i in range(0, len(words), 3):
        a = (a + words[i]) & M
        b = (b + words[i + 1]) & M
        c = (c + words[i + 2]) & M
        a = (a - c) & M; a ^= _rot(c, 4); c = (c + b) & M  # noqa: E702
        b = (b - a) & M; b ^= _rot(a, 6); a = (a + c) & M  # noqa: E702
        c = (c - b) & M; c ^= _rot(b, 8); b = (b + a) & M  # noqa: E702
        a = (a - c) & M; a ^= _rot(c, 16); c = (c + b) & M  # noqa: E702
        b = (b - a) & M; b ^= _rot(a, 19); a = (a + c) & M  # noqa: E702
        c = (c - b) & M; c ^= _rot(b, 4); b = (b + a) & M  # noqa: E702
    a2, b2, c2 = struct.unpack("<3I", data[n - tail:].ljust(12, b"\0"))
    a, b, c = (a + a2) & M, (b + b2) & M, (c + c2) & M
    c ^= b; c = (c - _rot(b, 14)) & M  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & M  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & M  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & M  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & M  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & M  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & M  # noqa: E702
    return c


def verify(mm, start: int, end: int, what: str) -> None:
    """Raise unless the 4 bytes at `end` are lookup3 of `mm[start:end]`."""
    stored = int.from_bytes(mm[end:end + 4], "little")
    if lookup3(bytes(mm[start:end])) != stored:
        raise ValueError(f"HDF5 {what} at {start} fails its checksum")
