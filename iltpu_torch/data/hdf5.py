"""A reader of HDF5 files in numpy and the standard library (`struct`,
`zlib`, `mmap`): no h5py, which the card's machine lacks.

    read_datasets(path, names) -> {name: np.ndarray}

returns the root group's datasets among `names`, in the order h5py's
`f.keys()` gives (name order, or creation order where the group tracks
it), each with the dtype, shape and values h5py gives (`np.asarray(f[name])`).
It reads what h5py writes under every `libver`, from the file format
specification (version 3.0):

- superblock versions 0-3, after a user block; every address is relative
  to the base address; v2/v3's checksum is verified;
- object headers of version 1 and 2 (`OHDR`, its flags, continuation
  blocks `OCHK`, each v2 block's checksum verified); messages that do not
  bear on the data (attributes, times, ...) are skipped; a shared message
  is read from the object header it names (a committed datatype) or from
  the shared-message table's fractal heap (`SMTB`, in the superblock
  extension);
- groups as symbol tables (a v1 B-tree of `SNOD` nodes, names in a local
  `HEAP`) and as links: compact (link messages in the header) or dense (a
  fractal heap of link messages under a v2 B-tree name index,
  `hdf5_fractal_heap.py`, `hdf5_btree2.py`); hard links are followed, soft
  links resolved inside the file;
- datatypes and variable-length data: `hdf5_types.py`;
- dataspaces of version 1 and 2, simple or scalar;
- layouts of version 3 and 4: compact, contiguous (an undefined address
  reads as the fill value) and chunked under every chunk index
  (`hdf5_chunk_index.py`; a chunk never written reads as the fill value);
- the filters of `hdf5_filters.py`; a chunk skips those its mask names.

Anything else raises ValueError naming the structure and ROADMAP.md's
'HDF5 newer formats': the virtual layout, raw data in external files,
external and user-defined links, filtered fractal heaps, null dataspaces,
and the datatype classes `hdf5_types.py` names.
"""

import mmap
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from iltpu_torch.data import hdf5_chunk_index, hdf5_types
from iltpu_torch.data.hdf5_btree2 import BTree2
from iltpu_torch.data.hdf5_checksum import refuse, verify
from iltpu_torch.data.hdf5_filters import fletcher32 as _fletcher32  # noqa: F401
from iltpu_torch.data.hdf5_filters import decode, pipeline
from iltpu_torch.data.hdf5_fractal_heap import FractalHeap

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
DATASPACE, LINK_INFO, DATATYPE, FILL, LINK, EXTERNAL, LAYOUT = 0x1, 0x2, 0x3, 0x5, 0x6, 0x7, 0x8
FILTERS, SHARED_TABLE, CONTINUATION, SYMBOL_TABLE = 0xB, 0xF, 0x10, 0x11
GROUP_MESSAGES = (LINK_INFO, LINK, SYMBOL_TABLE)
HARD, SOFT = 0, 1


class _File:
    """The superblock's sizes and base address over a read-only map, and
    the object headers, groups and datasets under it."""

    def __init__(self, mm):
        self.mm = mm
        p = 0
        while mm[p:p + 8] != SIGNATURE:
            p = 512 if p == 0 else 2 * p
            if p + 8 > len(mm):
                raise ValueError("not an HDF5 file: no superblock signature")
        version = mm[p + 8]
        self.extension = None
        if version in (0, 1):
            self.so, self.sl = mm[p + 13], mm[p + 14]
            q = p + 24 + (4 if version == 1 else 0)
            self.base = self.addr(q)
            root = q + 4 * self.so  # after the superblock's four addresses, base address first
            self.root = self.addr(root + self.so)  # the root entry's object header
        elif version in (2, 3):
            self.so, self.sl = mm[p + 9], mm[p + 10]
            q = p + 12
            verify(mm, p, q + 4 * self.so, f"superblock version {version}")
            self.base = self.addr(q)
            self.extension = self.addr(q + self.so)  # an object header: the shared-message table's
            self.root = self.addr(q + 3 * self.so)  # after the end-of-file address
        else:
            raise refuse(f"superblock version {version}")
        self.global_heap = hdf5_types.GlobalHeap(self)
        self.groups = {}
        self.heaps = None  # the shared-message table's (message type flags, heap)

    def uint(self, off: int, n: int) -> int:
        return int.from_bytes(self.mm[off:off + n], "little")

    def addr(self, off: int):
        """An address field; None where undefined (all bytes 0xFF)."""
        v = self.uint(off, self.so)
        return None if v == (1 << (8 * self.so)) - 1 else v

    def at(self, addr: int) -> int:
        return self.base + addr

    # ---------------------------------------------------- object headers

    def messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """(type, data offset, size) of an object header's messages, version
        1 or 2, continuation blocks followed and shared messages read from
        the header they name."""
        p, mm = self.at(addr), self.mm
        if mm[p:p + 4] == b"OHDR":
            if mm[p + 4] != 2:
                raise refuse(f"object header version {mm[p + 4]} (OHDR)")
            flags = mm[p + 5]
            q = p + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x3)
            start = q + width
            end = start + self.uint(q, width)
            verify(mm, p, end, "object header")
            # a message's header: type (1 byte), size (2), flags (1), creation order (2)
            blocks, v2, head = [(start, end)], True, 6 if flags & 0x4 else 4
        elif mm[p] == 1:
            blocks, v2, head = [(p + 16, p + 16 + self.uint(p + 8, 4))], False, 8
        else:
            raise refuse(f"object header version {mm[p]}")
        out = []
        while blocks:
            q, end = blocks.pop(0)
            while q + head <= end:  # what is left short of a message's header is a gap
                if v2:
                    kind, size, flags = mm[q], self.uint(q + 1, 2), mm[q + 3]
                    data = q + head
                    q = data + size
                else:
                    kind, size, flags = self.uint(q, 2), self.uint(q + 2, 2), mm[q + 4]
                    data = q + 8
                    q = data + ((size + 7) & ~7)  # aligned relative to the block's start
                if kind == CONTINUATION:
                    block, length = self.at(self.addr(data)), self.uint(data + self.so, self.sl)
                    if v2:
                        if mm[block:block + 4] != b"OCHK":
                            raise ValueError(f"HDF5 object header continuation expected at {block}")
                        verify(mm, block, block + length - 4, "object header continuation")
                        blocks.append((block + 4, block + length - 4))
                    else:
                        blocks.append((block, block + length))
                elif flags & 0x2:
                    out.append(self.shared(kind, data))
                elif kind:
                    out.append((kind, data, size))
        return out

    def shared(self, kind: int, p: int) -> Tuple[int, int, int]:
        """A shared message (version 1-3) read from the object header it
        names (a committed datatype's) or from the shared-message table's
        heap."""
        version, where = self.mm[p], self.mm[p + 1]
        if version == 1:
            target = self.addr(p + 8)
        elif version == 2 or (version == 3 and where == 2):
            target = self.addr(p + 2)
        elif version == 3 and where == 1:  # in the heap of the table's index for its type
            start, size = self.shared_heap(kind).locate(p + 2)
            return kind, start, size
        else:
            raise ValueError(f"HDF5 shared message version {version}, type {where}")
        for found in self.messages(target):
            if found[0] == kind:
                return found
        raise ValueError(f"HDF5 shared message of type {kind:#x}: not in its object header")

    def shared_heap(self, kind: int) -> FractalHeap:
        """The fractal heap of the shared-message table's index that holds
        messages of type `kind`: the table (`SMTB`) is named by a message
        (0xF) in the superblock extension's header; each index lists the
        message types it takes (bit `kind` of its flags) and its heap."""
        if self.extension is None:
            raise ValueError("HDF5 shared message in a file without a shared-message table")
        if self.heaps is None:
            found = {k: p for k, p, _ in self.messages(self.extension)}
            if SHARED_TABLE not in found:
                raise ValueError("HDF5 shared message in a file without a shared-message table")
            q = found[SHARED_TABLE]
            table, n = self.at(self.addr(q + 1)), self.mm[q + 1 + self.so]
            if self.mm[table:table + 4] != b"SMTB":
                raise ValueError(f"HDF5 shared-message table expected at {table}")
            entry = 14 + 2 * self.so
            verify(self.mm, table, table + 4 + n * entry, "shared-message table")
            self.heaps = [(self.uint(e + 2, 2), FractalHeap(self, self.addr(e + 14 + self.so)))
                          for e in range(table + 4, table + 4 + n * entry, entry)]
        for flags, heap in self.heaps:
            if flags & (1 << kind):
                return heap
        raise ValueError(f"HDF5 shared-message table has no index for messages of type {kind:#x}")

    def btree_leaves(self, addr: int, node_type: int, key: int):
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

    def group(self, addr: int) -> Dict[str, Tuple[int, object]]:
        """A group's {name: (link type, target)} in h5py's order: a hard
        link's target is an object header address, a soft link's a path
        (each group read once)."""
        if addr not in self.groups:
            self.groups[addr] = self._group(addr)
        return self.groups[addr]

    def _group(self, addr: int) -> Dict[str, Tuple[int, object]]:
        msgs = self.messages(addr)
        found = {kind: p for kind, p, _ in msgs}
        if SYMBOL_TABLE in found:
            return self._symbol_table(found[SYMBOL_TABLE])
        if LINK_INFO not in found and LINK not in found:
            raise ValueError("HDF5 object is not a group")
        tracked = LINK_INFO in found and bool(self.mm[found[LINK_INFO] + 1] & 0x1)
        links = [self._link(p) for kind, p, _ in msgs if kind == LINK]
        if LINK_INFO in found:
            links += self._dense_links(found[LINK_INFO])
        links.sort(key=lambda link: (link[0], link[1]) if tracked else link[1])
        return {name: target for _, name, target in links}

    def _symbol_table(self, table: int) -> Dict[str, Tuple[int, object]]:
        btree, heap = self.addr(table), self.addr(table + self.so)
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
                name = self._string(names + self.uint(e, self.so))
                if self.uint(e + 2 * self.so, 4) == 2:  # cached as a soft link: its path's offset
                    out[name] = (SOFT, self._string(names + self.uint(e + 2 * self.so + 8, 4)))
                else:
                    out[name] = (HARD, self.addr(e + self.so))
        return out

    def _string(self, start: int) -> str:
        return self.mm[start:self.mm.find(b"\0", start)].decode()

    def _link(self, p: int):
        """A link message's (creation order, name, (link type, target))."""
        flags, q = self.mm[p + 1], p + 2
        kind = order = 0
        if flags & 0x8:
            kind, q = self.mm[q], q + 1
        if flags & 0x4:
            order, q = self.uint(q, 8), q + 8
        if flags & 0x10:
            q += 1  # the name's character set
        width = 1 << (flags & 0x3)
        n, q = self.uint(q, width), q + width
        name, q = self.mm[q:q + n].decode(), q + n
        if kind == HARD:
            return order, name, (kind, self.uint(q, self.so))
        target = self.mm[q + 2:q + 2 + self.uint(q, 2)]
        return order, name, (kind, target.decode() if kind == SOFT else target)

    def _dense_links(self, p: int):
        """The links of a group's fractal heap, by its v2 B-tree name index."""
        q = p + 2 + (8 if self.mm[p + 1] & 0x1 else 0)
        heap_addr, names = self.addr(q), self.addr(q + self.so)
        if heap_addr is None:
            return []
        heap = FractalHeap(self, heap_addr)
        tree = BTree2(self, names)
        if tree.kind != 5:
            raise ValueError(f"HDF5 group name index: v2 B-tree of record type {tree.kind}")
        # each record: the name's hash (4 bytes), then the link's heap ID
        return [self._link(heap.locate(r + 4)[0]) for r in tree.records()]

    def resolve(self, group: int, link: Tuple[int, object], hops: int = 16) -> int:
        """The object header address a link reaches: a hard link's target, a
        soft link's path walked from the root or from `group`."""
        kind, target = link
        if kind == HARD:
            return target
        if kind != SOFT:
            raise refuse("external link" if kind == 64 else f"link of type {kind}")
        if not hops:
            raise ValueError("HDF5 soft links nest too deep")
        here = self.root if target.startswith("/") else group
        for part in (s for s in target.split("/") if s and s != "."):
            links = self.group(here)
            if part not in links:
                raise KeyError(f"HDF5 soft link to {target!r}: no {part!r}")
            here = self.resolve(here, links[part], hops - 1)
        return here

    # ----------------------------------------------------------- datasets

    def shape(self, p: int) -> Tuple[Tuple[int, ...], Tuple[Optional[int], ...]]:
        """A dataspace's dimensions and maximum dimensions (None: unlimited)."""
        version, rank, flags = self.mm[p], self.mm[p + 1], self.mm[p + 2]
        if version == 1:
            dims = p + 8
        elif version == 2:
            if self.mm[p + 3] == 2:
                raise refuse("null dataspace")
            dims = p + 4
        else:
            raise refuse(f"dataspace version {version}")
        shape = tuple(self.uint(dims + i * self.sl, self.sl) for i in range(rank))
        if not flags & 0x1:
            return shape, shape
        top = (1 << (8 * self.sl)) - 1
        maxshape = tuple(self.uint(dims + (rank + i) * self.sl, self.sl) for i in range(rank))
        return shape, tuple(None if m == top else m for m in maxshape)

    def fill(self, msgs, size: int) -> Optional[bytes]:
        """The fill value's bytes (the fill-value message's, version 1-3), or
        None for the default (zeros)."""
        for kind, p, _ in msgs:
            if kind == FILL:
                version = self.mm[p]
                if version == 3:
                    if not self.mm[p + 1] & 0x20:  # no fill value defined
                        return None
                    n, value = self.uint(p + 2, 4), p + 6
                elif version in (1, 2):
                    if version == 2 and not self.mm[p + 3]:
                        return None
                    n, value = self.uint(p + 4, 4), p + 8
                else:
                    raise refuse(f"fill value message version {version}")
                return self.mm[value:value + size] if n == size else None
        return None

    def dataset(self, addr: int) -> np.ndarray:
        msgs = self.messages(addr)
        found = {kind: p for kind, p, _ in msgs}
        if any(k in GROUP_MESSAGES for k in found):
            raise ValueError("HDF5 object is a group, not a dataset")
        for kind in (DATASPACE, DATATYPE, LAYOUT):
            if kind not in found:
                raise ValueError(f"HDF5 dataset without a message of type {kind:#x}")
        if EXTERNAL in found:
            raise refuse("raw data in external files (message 0x7)")
        dtype, _ = hdf5_types.parse(self, found[DATATYPE])
        shape, maxshape = self.shape(found[DATASPACE])
        size = dtype.storage.itemsize
        raw = np.zeros(shape, f"V{size}")  # the elements' bytes, as stored
        fill = self.fill(msgs, size)
        if fill is not None:
            raw.fill(np.frombuffer(fill, f"V{size}")[0])
        nbytes = raw.size * size
        p = found[LAYOUT]
        version, cls = self.mm[p], self.mm[p + 1]
        if version not in (3, 4):
            raise refuse(f"layout version {version}")
        if cls == 0:  # compact: the data in the message
            raw[...] = np.frombuffer(self.mm[p + 4:p + 4 + nbytes], raw.dtype).reshape(shape)
        elif cls == 1:  # contiguous
            data = self.addr(p + 2)
            if data is not None:
                start = self.at(data)
                raw[...] = np.frombuffer(self.mm[start:start + nbytes], raw.dtype).reshape(shape)
        elif cls == 2:
            filters = pipeline(self, found[FILTERS]) if FILTERS in found else []
            self._chunks(p, raw, shape, maxshape, filters)
        elif cls == 3:
            raise refuse("virtual dataset layout")
        else:
            raise refuse(f"layout class {cls}")
        return dtype.read(raw.view(dtype.storage) if dtype.storage.shape == () else
                          np.ndarray(shape, dtype.storage, raw))

    def _chunks(self, p: int, out: np.ndarray, shape, maxshape, filters) -> None:
        """Every written chunk of a chunked layout into `out`, each cropped to
        the dataset's bounds in every dimension by one slice assignment."""
        chunk, itemsize, chunks = hdf5_chunk_index.layout(self, p, shape, maxshape, bool(filters))
        count = int(np.prod(chunk))
        nbytes = count * out.dtype.itemsize
        for offsets, start, size, mask in chunks:
            if any(o >= s for o, s in zip(offsets, shape)):
                continue  # past the current extent (a dataset made smaller)
            raw = decode(self.mm[start:start + size], filters, mask, itemsize, nbytes)
            if len(raw) < nbytes:
                raise ValueError(f"HDF5 chunk at {offsets} holds {len(raw)} bytes, not {nbytes}")
            data = np.frombuffer(raw, out.dtype, count).reshape(chunk)
            part = tuple(min(c, s - o) for c, s, o in zip(chunk, shape, offsets))
            out[tuple(slice(o, o + k) for o, k in zip(offsets, part))] = \
                data[tuple(slice(0, k) for k in part)]


def read_datasets(path: str, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """The root group's datasets among `names` (in h5py's order of the root),
    as h5py reads them. A missing file raises FileNotFoundError; a structure
    outside the reader raises ValueError naming ROADMAP.md's 'HDF5 newer
    formats'."""
    wanted = set(names)
    with open(path, "rb") as f:
        if not f.seek(0, 2):
            raise ValueError(f"not an HDF5 file: {path} is empty")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            h5 = _File(mm)
            return {name: h5.dataset(h5.resolve(h5.root, link))
                    for name, link in h5.group(h5.root).items() if name in wanted}
