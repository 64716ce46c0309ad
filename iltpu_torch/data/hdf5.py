"""A reader of HDF5 files in numpy and the standard library (`struct`,
`zlib`, `mmap`): no h5py, which the card's machine lacks.

    read_datasets(path, names) -> {name: np.ndarray}

returns the root group's datasets among `names`, in the order h5py's
`f.keys()` gives (name order, or creation order where the group tracks
it), each with the dtype, shape and values h5py gives (`np.asarray(f[name])`).
It reads what h5py reads, from the file format specification (version
3.0):

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
  fractal heap of link messages, filtered or not, under a v2 B-tree name
  index, `hdf5_fractal_heap.py`, `hdf5_btree2.py`); hard links are
  followed, soft links resolved, external links followed into the file
  they name (`Files`), at most 16 soft and external links deep;
- datatypes and variable-length data: `hdf5_types.py` (floats of any
  layout through `hdf5_convert.py`);
- dataspaces of version 1 and 2, simple or scalar;
- layouts of version 3 and 4: compact, contiguous (an undefined address
  reads as the fill value; raw data in external files, the external data
  files message), chunked under every chunk index (`hdf5_chunk_index.py`;
  a chunk never written reads as the fill value) and virtual
  (`hdf5_virtual.py`);
- the filters of `hdf5_filters.py`; a chunk skips those its mask names.

A file an external link, external raw data or a virtual mapping names is
found as HDF5 1.14.6 finds it (`Files`). What iltpu's loader refuses
raises ValueError naming the structure and ROADMAP.md's 'HDF5 newer
formats' (its "By design" entry): null dataspaces, user-defined links,
the time and reference datatype classes, floats normalised with their
most significant bit set (where their exponent is not zero), VAX-ordered
floats in a datatype message of version 3, point selections in a virtual
mapping, and fractal heap huge objects whose IDs hold their address
(HDF5 1.14.6 writes none of the last three).
"""

import mmap
import os
from contextlib import ExitStack
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from iltpu_torch.data import hdf5_chunk_index, hdf5_types, hdf5_virtual
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
HARD, SOFT, EXTERNAL_LINK = 0, 1, 64
UNLIMITED = (1 << 64) - 1  # an external file's size that runs to its end


class _File:
    """The superblock's sizes and base address over a read-only map, and
    the object headers, groups and datasets under it. `path` is the name the
    file was opened by, and `files` the `Files` that opened it (the files its
    external links, external raw data and virtual sources name)."""

    def __init__(self, mm, path: str = "", files: Optional["Files"] = None):
        self.mm, self.path, self.files = mm, path, files
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

    def _local_heap(self, addr: int) -> int:
        """The file offset of a local heap's (`HEAP`) data segment."""
        h = self.at(addr)
        if self.mm[h:h + 4] != b"HEAP":
            raise ValueError("HDF5 local heap expected")
        return self.at(self.addr(h + 8 + 2 * self.sl))

    def _symbol_table(self, table: int) -> Dict[str, Tuple[int, object]]:
        btree, names = self.addr(table), self._local_heap(self.addr(table + self.so))
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

    def _link(self, p: int, buf=None):
        """A link message's (creation order, name, (link type, target)), at
        `p` in the file or in `buf` (an object of a filtered heap)."""
        buf = self.mm if buf is None else buf

        def uint(off: int, n: int) -> int:
            return int.from_bytes(buf[off:off + n], "little")
        flags, q = buf[p + 1], p + 2
        kind = order = 0
        if flags & 0x8:
            kind, q = buf[q], q + 1
        if flags & 0x4:
            order, q = uint(q, 8), q + 8
        if flags & 0x10:
            q += 1  # the name's character set
        width = 1 << (flags & 0x3)
        n, q = uint(q, width), q + width
        name, q = bytes(buf[q:q + n]).decode(), q + n
        if kind == HARD:
            return order, name, (kind, uint(q, self.so))
        target = bytes(buf[q + 2:q + 2 + uint(q, 2)])
        if kind == SOFT:
            return order, name, (kind, target.decode())
        if kind == EXTERNAL_LINK:  # version and flags (a byte), the file's name, the object's path
            if target[0] >> 4:
                raise ValueError(f"HDF5 external link version {target[0] >> 4}")
            file_name, path = target[1:].split(b"\0")[:2]
            return order, name, (kind, (file_name.decode(), path.decode()))
        return order, name, (kind, target)

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
        return [self._link(0, heap.object(r + 4)) for r in tree.records()]

    def follow(self, group: int, link: Tuple[int, object], hops: int = 16) -> Tuple["_File", int]:
        """The file and object header address a link reaches: a hard link's
        target; a soft link's path walked from the root or from `group`; an
        external link's path walked from the root of the file it names, found
        as HDF5 finds it (`Files.link_target`). Soft and external links
        together nest at most `hops` deep, HDF5's default."""
        kind, target = link
        if kind == HARD:
            return self, target
        if kind not in (SOFT, EXTERNAL_LINK):
            raise refuse(f"user-defined link of type {kind}")
        if not hops:
            raise ValueError("HDF5 soft and external links nest too deep")
        if kind == EXTERNAL_LINK:
            file_name, path = target
            return self.files.link_target(self, file_name).walk(path, hops - 1)
        return self.walk(target, hops - 1, group)

    def walk(self, path: str, hops: int, group: Optional[int] = None) -> Tuple["_File", int]:
        """The file and object header address at `path`, from the root (an
        absolute path, or where `group` is None) or from `group`."""
        h5, here = self, self.root if group is None or path.startswith("/") else group
        for part in (s for s in path.split("/") if s and s != "."):
            links = h5.group(here)
            if part not in links:
                raise KeyError(f"HDF5 path {path!r}: no {part!r}")
            h5, here = h5.follow(here, links[part], hops)
        return h5, here

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

    def extent(self, addr: int) -> Tuple[Tuple[int, ...], Tuple[Optional[int], ...]]:
        """The dimensions and maximum dimensions of the dataset at `addr`."""
        for kind, p, _ in self.messages(addr):
            if kind == DATASPACE:
                return self.shape(p)
        raise ValueError(f"HDF5 dataset without a message of type {DATASPACE:#x}")

    def read(self, addr: int, box: Optional[Tuple[Tuple[int, int], ...]] = None) -> np.ndarray:
        """The dataset at `addr` as h5py reads it, or its part in `box`
        ((start, stop) in each dimension: a chunked dataset decodes only the
        chunks that meet it)."""
        msgs = self.messages(addr)
        found = {kind: p for kind, p, _ in msgs}
        if any(k in GROUP_MESSAGES for k in found):
            raise ValueError("HDF5 object is a group, not a dataset")
        for kind in (DATASPACE, DATATYPE, LAYOUT):
            if kind not in found:
                raise ValueError(f"HDF5 dataset without a message of type {kind:#x}")
        dtype, _ = hdf5_types.parse(self, found[DATATYPE])
        shape, maxshape = self.shape(found[DATASPACE])
        size = dtype.storage.itemsize
        fill = self.fill(msgs, size)
        p = found[LAYOUT]
        version, cls = self.mm[p], self.mm[p + 1]
        if version not in (3, 4):
            raise refuse(f"layout version {version}")
        if cls == 3:
            whole = hdf5_virtual.read(self, p, dtype, shape, maxshape, fill)
            return whole if box is None else whole[tuple(slice(a, b) for a, b in box)]
        box = box or tuple((0, n) for n in shape)
        where = tuple(slice(a, b) for a, b in box)
        part = tuple(b - a for a, b in box)
        raw = np.zeros(part, f"V{size}")  # the elements' bytes, as stored
        if fill is not None:
            raw.fill(np.frombuffer(fill, f"V{size}")[0])
        nbytes = int(np.prod(shape)) * size
        if EXTERNAL in found:  # the layout is contiguous, its data in other files
            data = self._external(found[EXTERNAL], nbytes)
            raw[...] = np.frombuffer(data, raw.dtype).reshape(shape)[where]
        elif cls == 0:  # compact: the data in the message
            raw[...] = np.frombuffer(self.mm[p + 4:p + 4 + nbytes], raw.dtype).reshape(shape)[where]
        elif cls == 1:  # contiguous
            data = self.addr(p + 2)
            if data is not None:
                start = self.at(data)
                raw[...] = np.frombuffer(self.mm[start:start + nbytes], raw.dtype).reshape(shape)[where]
        elif cls == 2:
            filters = pipeline(self, found[FILTERS]) if FILTERS in found else []
            self._chunks(p, raw, shape, maxshape, filters, box)
        else:
            raise refuse(f"layout class {cls}")
        return dtype.read(raw.view(dtype.storage) if dtype.storage.shape == () else
                          np.ndarray(part, dtype.storage, raw))

    def _external(self, p: int, nbytes: int) -> bytes:
        """A dataset's `nbytes` of raw data in external files (the external
        data files message, version 1): its slots (a name in a local heap, a
        file offset, a size) one after another, each file found as HDF5 finds
        it (`Files.external_data`). A file shorter than its slot reads as
        zeros past its end, as HDF5 reads it; a file not found, or data past
        the last slot, raise ValueError."""
        if self.mm[p] != 1:
            raise refuse(f"external data files message version {self.mm[p]}")
        used, names = self.uint(p + 6, 2), self._local_heap(self.addr(p + 8))
        q, out, want = p + 8 + self.so, [], nbytes
        for _ in range(used):
            if not want:
                break
            name, offset, size = (self.uint(q + i * self.sl, self.sl) for i in range(3))
            q += 3 * self.sl
            n = want if size == UNLIMITED else min(size, want)
            path = self.files.external_data(self, self._string(names + name))
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    data = f.read(n)
            except OSError as e:
                raise ValueError(f"HDF5 raw data in external files: cannot open {path!r} ({e})") from e
            out.append(data.ljust(n, b"\0"))
            want -= n
        if want:
            raise ValueError(f"HDF5 raw data in external files: {want} bytes past the last slot")
        return b"".join(out)

    def _chunks(self, p: int, out: np.ndarray, shape, maxshape, filters, box) -> None:
        """Every written chunk of a chunked layout that meets `box` into `out`
        (the box's part of the dataset), each cropped to the box in every
        dimension by one slice assignment."""
        chunk, itemsize, chunks = hdf5_chunk_index.layout(self, p, shape, maxshape, bool(filters))
        count = int(np.prod(chunk))
        nbytes = count * out.dtype.itemsize
        for offsets, start, size, mask in chunks:
            # the chunk's part inside the box (and the current extent: a dataset made smaller)
            lo = [max(o, a) for o, (a, _) in zip(offsets, box)]
            hi = [min(o + c, b) for o, c, (_, b) in zip(offsets, chunk, box)]
            if any(h <= a for a, h in zip(lo, hi)):
                continue
            raw = decode(self.mm[start:start + size], filters, mask, itemsize, nbytes)
            if len(raw) < nbytes:
                raise ValueError(f"HDF5 chunk at {offsets} holds {len(raw)} bytes, not {nbytes}")
            data = np.frombuffer(raw, out.dtype, count).reshape(chunk)
            out[tuple(slice(a - b0, h - b0) for a, h, (b0, _) in zip(lo, hi, box))] = \
                data[tuple(slice(a - o, h - o) for a, h, o in zip(lo, hi, offsets))]


class Files:
    """The files one read opens, each mapped once (by device and inode) and
    all closed together: the first, and the files its external links,
    external raw data and virtual datasets name, each found as HDF5 1.14.6
    finds it. The environment variables HDF5 reads (`HDF5_EXT_PREFIX`,
    `HDF5_EXTFILE_PREFIX`, `HDF5_VDS_PREFIX`) are read at each search."""

    def __init__(self):
        self.stack = ExitStack()
        self.mapped = {}

    def __enter__(self) -> "Files":
        return self

    def __exit__(self, *exc) -> None:
        self.stack.close()

    def open(self, path: str) -> _File:
        """The file at `path`: FileNotFoundError where it is missing,
        ValueError where it is empty or not HDF5."""
        st = os.stat(path)
        key = (st.st_dev, st.st_ino)
        if key not in self.mapped:
            if not st.st_size:
                raise ValueError(f"not an HDF5 file: {path} is empty")
            with open(path, "rb") as f:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self.stack.callback(mm.close)
            self.mapped[key] = _File(mm, path, self)
        return self.mapped[key]

    def _first(self, paths) -> Optional[_File]:
        for path in paths:
            try:
                return self.open(path)
            except (OSError, ValueError):  # HDF5 goes on to the next name
                continue
        return None

    def link_target(self, h5: _File, name: str) -> _File:
        """The file an external link in `h5` names (HDF5's
        `H5F_prefix_open_file`): raises ValueError where none is found, as
        h5py raises KeyError."""
        found = self._first(_search(h5, name, "HDF5_EXT_PREFIX", None))
        if found is None:
            raise ValueError(f"HDF5 external link to {name!r}: no such file found")
        return found

    def virtual_source(self, h5: _File, name: str) -> Optional[_File]:
        """The file a virtual dataset's mapping names: `h5` itself for ".",
        else the first found (HDF5_VDS_PREFIX's paths, then the prefix it
        gives with ${ORIGIN} as `h5`'s directory, ...); None where none is
        found (the mapping reads as the fill value)."""
        if name == ".":
            return h5
        return self._first(_search(h5, name, "HDF5_VDS_PREFIX", _prefix(h5, "HDF5_VDS_PREFIX")))

    def external_data(self, h5: _File, name: str) -> str:
        """The path of a file of external raw data: the name as given, under
        HDF5_EXTFILE_PREFIX where that is set and the name is relative."""
        prefix = _prefix(h5, "HDF5_EXTFILE_PREFIX")
        if prefix is None or name.startswith("/"):
            return name
        return _join(prefix, name)


def _join(prefix: str, name: str) -> str:
    return prefix + name if prefix.endswith("/") else f"{prefix}/{name}"


def _extpath(h5: _File) -> str:
    """The directory of the name `h5` was opened by, as HDF5 keeps it."""
    return os.path.dirname(os.path.abspath(h5.path)) + "/"


def _prefix(h5: _File, env: str) -> Optional[str]:
    """HDF5's prefix for a dataset's external files or virtual sources (its
    `H5D__build_file_prefix`): the variable's value, ${ORIGIN} at its start
    standing for `h5`'s directory; None where unset, empty or "."."""
    prefix = os.environ.get(env, "")
    if prefix in ("", "."):
        return None
    if prefix.startswith("${ORIGIN}"):
        return _extpath(h5) + prefix[len("${ORIGIN}"):]
    return prefix


def _search(h5: _File, name: str, env: str, prefix: Optional[str]):
    """The paths HDF5 tries, in order, for a file an external link or a
    virtual mapping in `h5` names (`H5F_prefix_open_file`): an absolute
    name as given (then only its last component); each of `env`'s
    colon-separated paths; `prefix`; `h5`'s directory; the name as given
    (from the working directory); the directory of `h5`'s real path."""
    if name.startswith("/"):
        yield name
        name = name[name.rindex("/") + 1:]
    for path in os.environ.get(env, "").split(":"):
        if path:
            yield _join(path, name)
    if prefix is not None:
        yield _join(prefix, name)
    yield _join(_extpath(h5), name)
    yield name
    yield _join(os.path.dirname(os.path.realpath(h5.path)), name)


def read_datasets(path: str, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """The root group's datasets among `names` (in h5py's order of the root),
    as h5py reads them. A missing file raises FileNotFoundError; a structure
    outside the reader raises ValueError naming ROADMAP.md's 'HDF5 newer
    formats'."""
    wanted = set(names)
    with Files() as files:
        h5 = files.open(path)
        out = {}
        for name, link in h5.group(h5.root).items():
            if name in wanted:
                where, addr = h5.follow(h5.root, link)
                out[name] = where.read(addr)
        return out
