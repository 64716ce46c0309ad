"""A reader of the HDF5 files that D4RL ships, in numpy and the standard
library (`struct`, `zlib`, `mmap`): no h5py, which the card's machine lacks.

    read_datasets(path, names) -> {name: np.ndarray}

returns the root group's datasets among `names`, in the root's order, each
with the dtype and shape h5py gives (`np.asarray(f[name])`). It reads the
subset of the format that h5py writes under its default
`libver=('earliest', ...)`, which is the one D4RL's files use:

- superblock version 0 or 1, at offset 0, 512, 1024, 2048, ... (after a
  user block); every address is relative to its base address;
- version-1 object headers (messages 8-byte aligned, continuation blocks
  followed);
- groups as symbol tables: a v1 B-tree of `SNOD` nodes, names in a local
  `HEAP`;
- datatypes: fixed-point (1-8 bytes, either byte order, signed or not),
  IEEE floating point (2, 4, 8 bytes, either byte order), enums (h5py's
  bool, an enum FALSE=0 / TRUE=1, reads as `bool`; any other as its base
  integer type);
- dataspaces of version 1 and 2, simple or scalar;
- layout version 3: compact, contiguous (an undefined address reads as the
  fill value) and chunked under a v1 B-tree of any depth (a chunk never
  written reads as the fill value);
- the filters deflate, shuffle and fletcher32 (a chunk skips those its
  filter mask names).

Anything else (superblock v2/v3, `OHDR` headers, link messages and
fractal heaps, layout v4 chunk indexes, other filters) raises ValueError
naming the structure and ROADMAP.md's 'HDF5 newer formats': h5py writes
those under `libver='latest'`.
"""

import mmap
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
ITEM = "HDF5 newer formats"

# object header message types
DATASPACE, DATATYPE, FILL, LAYOUT, FILTERS = 0x1, 0x3, 0x5, 0x8, 0xB
CONTINUATION, SYMBOL_TABLE = 0x10, 0x11
NEW_STYLE_GROUP = {0x2: "link info message", 0x6: "link message", 0xA: "group info message"}
DEFLATE, SHUFFLE, FLETCHER32 = 1, 2, 3


def _refuse(what: str) -> ValueError:
    return ValueError(f"{what} is not read by the port's HDF5 reader: ROADMAP.md, '{ITEM}'")


def _fletcher32(data: bytes) -> Tuple[int, int]:
    """HDF5's Fletcher-32 sums (H5_checksum_fletcher32: big-endian 16-bit
    words, an odd last byte as the high byte of a word), each mod 65535."""
    if len(data) % 2:
        data += b"\0"
    w = np.frombuffer(data, ">u2").astype(np.uint64)
    n = len(w)
    s1 = int(w.sum()) % 65535
    # sum2 = sum_i (n - i) w_i; the weights reduced mod 65535 keep it in uint64
    s2 = int((w * (np.arange(n, 0, -1, dtype=np.uint64) % 65535)).sum()) % 65535
    return s1, s2


def _check_fletcher32(raw: bytes) -> bytes:
    data, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
    s1, s2 = _fletcher32(data)
    # the library also accepts the byte-swapped halves an old version wrote
    swapped = ((stored & 0x00FF00FF) << 8) | ((stored >> 8) & 0x00FF00FF)
    for v in (stored, swapped):
        if (v & 0xFFFF) % 65535 == s1 and (v >> 16) % 65535 == s2:
            return data
    raise ValueError("HDF5 chunk fails its fletcher32 checksum")


def _unshuffle(raw: bytes, size: int) -> bytes:
    n = len(raw) // size
    if size == 1 or n == 0:
        return raw
    planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
    return planes.T.tobytes() + raw[n * size:]


class _File:
    """The superblock's sizes and base address over a read-only map."""

    def __init__(self, mm):
        self.mm = mm
        p = 0
        while mm[p:p + 8] != SIGNATURE:
            p = 512 if p == 0 else 2 * p
            if p + 8 > len(mm):
                raise ValueError("not an HDF5 file: no superblock signature")
        version = mm[p + 8]
        if version not in (0, 1):
            raise _refuse(f"superblock version {version}")
        self.so, self.sl = mm[p + 13], mm[p + 14]
        q = p + 24 + (4 if version == 1 else 0)
        self.base = self.addr(q)
        root = q + 4 * self.so  # after the superblock's four addresses, base address first
        self.root = self.addr(root + self.so)  # the root entry's object header

    def uint(self, off: int, n: int) -> int:
        return int.from_bytes(self.mm[off:off + n], "little")

    def addr(self, off: int):
        """An address field; None where undefined (all bytes 0xFF)."""
        v = self.uint(off, self.so)
        return None if v == (1 << (8 * self.so)) - 1 else v

    def at(self, addr: int) -> int:
        return self.base + addr

    def messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """(type, data offset, size) of a version-1 object header's
        messages, continuation blocks followed."""
        p = self.at(addr)
        if self.mm[p:p + 4] == b"OHDR":
            raise _refuse("object header version 2 (OHDR)")
        if self.mm[p] != 1:
            raise _refuse(f"object header version {self.mm[p]}")
        blocks, out = [(p + 16, self.uint(p + 8, 4))], []
        while blocks:
            q, length = blocks.pop(0)
            end = q + length
            while q + 8 <= end:
                kind, size, flags = self.uint(q, 2), self.uint(q + 2, 2), self.mm[q + 4]
                data = q + 8
                if flags & 0x2:
                    raise _refuse(f"shared message of type {kind:#x}")
                if kind == CONTINUATION:
                    blocks.append((self.at(self.addr(data)), self.uint(data + self.so, self.sl)))
                elif kind:
                    out.append((kind, data, size))
                q = data + ((size + 7) & ~7)  # aligned relative to the block's start
        return out

    def btree_leaves(self, addr: int, node_type: int, key: int) -> Iterable[Tuple[int, int]]:
        """(key offset, child address) of every entry of a v1 B-tree's
        level-0 nodes, in key order, every level walked; `key` is the key's
        size in bytes."""
        stack = [addr]
        while stack:
            p = self.at(stack.pop())
            if self.mm[p:p + 4] != b"TREE" or self.mm[p + 4] != node_type:
                raise ValueError(f"HDF5 B-tree node of type {node_type} expected at {p}")
            level, used = self.mm[p + 5], self.uint(p + 6, 2)
            q = p + 8 + 2 * self.so
            entries = []
            for _ in range(used):
                entries.append((q, self.addr(q + key)))
                q += key + self.so
            if level:
                stack.extend(child for _, child in reversed(entries))
            else:
                yield from entries

    # ------------------------------------------------------------- groups

    def group(self, addr: int) -> Dict[str, int]:
        """A symbol-table group's {name: object header address}, in name order."""
        msgs = self.messages(addr)
        for kind, _, _ in msgs:
            if kind in NEW_STYLE_GROUP:
                raise _refuse(f"a group stored by {NEW_STYLE_GROUP[kind]}s and a fractal heap")
        table = [d for kind, d, _ in msgs if kind == SYMBOL_TABLE]
        if not table:
            raise ValueError("HDF5 object is not a group")
        btree, heap = self.addr(table[0]), self.addr(table[0] + self.so)
        h = self.at(heap)
        if self.mm[h:h + 4] != b"HEAP":
            raise ValueError("HDF5 local heap expected")
        names = self.at(self.addr(h + 8 + 2 * self.sl))
        out = {}
        for _, snod in self.btree_leaves(btree, 0, self.sl):
            s = self.at(snod)
            if self.mm[s:s + 4] != b"SNOD":
                raise ValueError("HDF5 symbol node expected")
            entry = 2 * self.so + 24
            for i in range(self.uint(s + 6, 2)):
                e = s + 8 + i * entry
                start = names + self.uint(e, self.so)
                name = self.mm[start:self.mm.find(b"\0", start)].decode()
                out[name] = self.addr(e + self.so)
        return out

    # ----------------------------------------------------------- datasets

    def dtype(self, p: int) -> Tuple[np.dtype, int]:
        """A datatype message's numpy dtype and its length in bytes."""
        cls, version = self.mm[p] & 0xF, self.mm[p] >> 4
        bits, size = self.uint(p + 1, 3), self.uint(p + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}"), 12
        if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            return np.dtype(f"{order}f{size}"), 20
        if cls == 8:
            base, n = self.dtype(p + 8)
            q, members = p + 8 + n, []
            for _ in range(bits & 0xFFFF):
                end = self.mm.find(b"\0", q)
                members.append(self.mm[q:end].decode())
                q = end + 1 if version >= 3 else q + ((end - q) // 8 + 1) * 8
            values = np.frombuffer(self.mm[q:q + len(members) * base.itemsize], base).tolist()
            q += len(members) * base.itemsize
            if base.kind in "iu" and dict(zip(members, values)) == {"FALSE": 0, "TRUE": 1}:
                return np.dtype(bool), q - p  # h5py's bool
            return base, q - p
        raise _refuse(f"datatype class {cls} of {size} bytes")

    def shape(self, p: int) -> Tuple[int, ...]:
        version, rank = self.mm[p], self.mm[p + 1]
        if version == 1:
            dims = p + 8
        elif version == 2:
            if self.mm[p + 3] == 2:
                raise _refuse("null dataspace")
            dims = p + 4
        else:
            raise _refuse(f"dataspace version {version}")
        return tuple(self.uint(dims + i * self.sl, self.sl) for i in range(rank))

    def filters(self, p: int) -> List[Tuple[int, Tuple[int, ...]]]:
        version, n = self.mm[p], self.mm[p + 1]
        if version not in (1, 2):
            raise _refuse(f"filter pipeline version {version}")
        q, out = p + (8 if version == 1 else 2), []
        for _ in range(n):
            fid = self.uint(q, 2)
            if version == 1 or fid >= 256:
                name_len, q = self.uint(q + 2, 2), q + 4
            else:
                name_len, q = 0, q + 2
            ncd = self.uint(q + 2, 2)
            q += 4 + name_len
            client = tuple(self.uint(q + 4 * i, 4) for i in range(ncd))
            q += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
            if fid not in (DEFLATE, SHUFFLE, FLETCHER32):
                raise _refuse(f"filter id {fid}")
            out.append((fid, client))
        return out

    def fill(self, msgs, dtype: np.dtype) -> Optional[bytes]:
        """The fill value's bytes (the fill-value message's, version 1 or 2),
        or None for the default (zeros)."""
        for kind, p, _ in msgs:
            if kind == FILL:
                version, defined, size = self.mm[p], self.mm[p + 3], self.uint(p + 4, 4)
                if version not in (1, 2):
                    raise _refuse(f"fill value message version {version}")
                if (version == 2 and not defined) or size != dtype.itemsize:
                    return None
                return self.mm[p + 8:p + 8 + size]
        return None

    def dataset(self, addr: int) -> np.ndarray:
        msgs = self.messages(addr)
        found = {kind: p for kind, p, _ in msgs}
        if SYMBOL_TABLE in found or any(k in NEW_STYLE_GROUP for k in found):
            raise ValueError("HDF5 object is a group, not a dataset")
        for kind in (DATASPACE, DATATYPE, LAYOUT):
            if kind not in found:
                raise ValueError(f"HDF5 dataset without a message of type {kind:#x}")
        dtype, _ = self.dtype(found[DATATYPE])
        shape = self.shape(found[DATASPACE])
        fill = self.fill(msgs, dtype)
        out = np.zeros(shape, dtype)
        if fill is not None:
            out.fill(np.frombuffer(fill, dtype)[0])
        count = out.size
        p = found[LAYOUT]
        if self.mm[p] != 3:
            raise _refuse(f"layout version {self.mm[p]}")
        cls = self.mm[p + 1]
        if cls == 0:  # compact: the data in the message
            out[...] = np.frombuffer(self.mm[p + 4:p + 4 + count * dtype.itemsize], dtype).reshape(shape)
        elif cls == 1:  # contiguous
            data = self.addr(p + 2)
            if data is not None:
                start = self.at(data)
                out[...] = np.frombuffer(self.mm[start:start + count * dtype.itemsize],
                                         dtype).reshape(shape)
        elif cls == 2:
            filters = self.filters(found[FILTERS]) if FILTERS in found else []
            self._chunks(p, out, filters)
        else:
            raise _refuse(f"layout class {cls}")
        return out

    def _chunks(self, p: int, out: np.ndarray, filters) -> None:
        """Every written chunk of a chunked layout into `out`, each cropped to
        the dataset's bounds in every dimension by one slice assignment."""
        ndims = self.mm[p + 2]
        btree = self.addr(p + 3)
        dims = [self.uint(p + 3 + self.so + 4 * i, 4) for i in range(ndims)]
        chunk, itemsize, count = tuple(dims[:-1]), dims[-1], int(np.prod(dims[:-1]))
        if btree is None:
            return
        for key, child in self.btree_leaves(btree, 1, 8 + 8 * ndims):
            size, mask = self.uint(key, 4), self.uint(key + 4, 4)
            offsets = [self.uint(key + 8 + 8 * i, 8) for i in range(ndims - 1)]
            start = self.at(child)
            raw = self.mm[start:start + size]
            for i in reversed(range(len(filters))):
                if mask & (1 << i):
                    continue
                fid, client = filters[i]
                if fid == DEFLATE:
                    raw = zlib.decompress(raw)
                elif fid == SHUFFLE:
                    raw = _unshuffle(raw, client[0] if client else itemsize)
                else:
                    raw = _check_fletcher32(raw)
            if len(raw) < count * out.dtype.itemsize:
                raise ValueError(f"HDF5 chunk at {offsets} holds {len(raw)} bytes, not "
                                 f"{count * out.dtype.itemsize}")
            data = np.frombuffer(raw, out.dtype, count).reshape(chunk)
            part = tuple(min(c, s - o) for c, s, o in zip(chunk, out.shape, offsets))
            out[tuple(slice(o, o + k) for o, k in zip(offsets, part))] = \
                data[tuple(slice(0, k) for k in part)]


def read_datasets(path: str, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """The root group's datasets among `names` (in the root's order), as
    h5py reads them. A missing file raises FileNotFoundError; a structure
    outside the reader's subset raises ValueError naming ROADMAP.md's 'HDF5
    newer formats'."""
    wanted = set(names)
    with open(path, "rb") as f:
        if not f.seek(0, 2):
            raise ValueError(f"not an HDF5 file: {path} is empty")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            h5 = _File(mm)
            return {name: h5.dataset(addr) for name, addr in h5.group(h5.root).items()
                    if name in wanted}
