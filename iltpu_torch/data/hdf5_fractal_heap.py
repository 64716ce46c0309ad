"""HDF5's fractal heap (`FRHP`): where a dense group keeps its link
messages, and a shared-message table its messages. Managed objects live in
direct blocks (`FHDB`) under a doubling table of indirect blocks (`FHIB`)
of any depth; tiny objects live in their heap ID; huge ones (past the
heap's largest managed object, 4 KB or so in a group's heap: a long link
name) outside the table, found by the v2 B-tree of huge objects. A heap
may have an I/O filter pipeline (a group's creation list's filters, on the
group's link heap): then each direct block is stored filtered (the root's
size and filter mask in the header, the others' in their indirect block's
entries), and each huge object too (records of type 2: address, filtered
size, filter mask, size, ID). Huge objects whose heap IDs hold their
address (records of types 3 and 4) need IDs longer than HDF5 1.14.6 gives
a group's or a shared-message table's heap, and raise ValueError.
"""

from typing import Tuple

from iltpu_torch.data.hdf5_btree2 import BTree2
from iltpu_torch.data.hdf5_checksum import lookup3, refuse, verify
from iltpu_torch.data.hdf5_filters import decode, pipeline


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"HDF5 fractal heap: {n} is not a power of two")
    return n.bit_length() - 1


class FractalHeap:
    """The heap whose header is at `addr`; `locate(p)` finds an object by
    its heap ID at file offset `p`."""

    def __init__(self, h5, addr: int):
        self.h5 = h5
        p, so, sl = h5.at(addr), h5.so, h5.sl
        if h5.mm[p:p + 4] != b"FRHP" or h5.mm[p + 4] != 0:
            raise ValueError(f"HDF5 fractal heap header expected at {p}")
        self.id_len, filters_len, flags = h5.uint(p + 5, 2), h5.uint(p + 7, 2), h5.mm[p + 9]
        self.max_managed = h5.uint(p + 10, 4)
        self.huge_tree, self.huge = h5.addr(p + 14 + sl), None  # huge objects: a v2 B-tree
        q = p + 14 + sl + so + sl + so + 8 * sl  # past the free-space and object counts
        self.width, self.start = h5.uint(q, 2), h5.uint(q + 2, sl)
        self.max_direct = h5.uint(q + 2 + sl, sl)
        self.max_heap_bits = h5.uint(q + 2 + 2 * sl, 2)
        self.root = h5.addr(q + 6 + 2 * sl)
        self.root_rows = h5.uint(q + 6 + 2 * sl + so, 2)
        end = q + 8 + 2 * sl + so
        self.filters, self.root_filtered = [], (None, 0)
        if filters_len:  # the root direct block's filtered size and mask, then the pipeline
            self.root_filtered = (h5.uint(end, sl), h5.uint(end + sl, 4))
            self.filters = pipeline(h5, end + sl + 4)
            end += sl + 4 + filters_len
        verify(h5.mm, p, end, "fractal heap header")
        self.checksummed = bool(flags & 0x2)
        self.offset_bytes = (self.max_heap_bits + 7) // 8
        self.length_bytes = (min(self.max_direct, self.max_managed).bit_length() + 7) // 8
        self.direct_rows = _log2(self.max_direct) - _log2(self.start) + 2
        self.log_width = _log2(self.width)
        self.verified = set()  # the blocks whose checksum was verified
        self.decoded = {}  # a filtered direct block's bytes, by its address

    def block_size(self, row: int) -> int:
        return self.start * (1 << max(row - 1, 0))

    def locate(self, p: int) -> Tuple[int, int]:
        """(file offset, length) of the object whose heap ID is at file
        offset `p`, in a heap without filters."""
        buf, start, n = self._find(p)
        if buf is not self.h5.mm:
            raise ValueError("HDF5 fractal heap: a filtered object has no file offset")
        return start, n

    def object(self, p: int) -> bytes:
        """The bytes of the object whose heap ID is at file offset `p`."""
        buf, start, n = self._find(p)
        return bytes(buf[start:start + n])

    def _find(self, p: int):
        """(buffer, offset, length) of the object whose heap ID is at `p`:
        the file's map, or a filtered block's or huge object's bytes."""
        mm, h5 = self.h5.mm, self.h5
        kind = (mm[p] >> 4) & 0x3
        if mm[p] >> 6:
            raise ValueError(f"HDF5 fractal heap ID version {mm[p] >> 6}")
        if kind == 2:  # tiny: the object is in the ID
            if self.id_len <= 18:
                return mm, p + 1, (mm[p] & 0xF) + 1
            return mm, p + 2, ((mm[p] & 0xF) << 8 | mm[p + 1]) + 1
        if kind == 1:
            return self._huge(p)
        offset = h5.uint(p + 1, self.offset_bytes)
        n = h5.uint(p + 1 + self.offset_bytes, self.length_bytes)
        buf, block, base = self._direct_block(offset)
        return buf, block + offset - base, n

    def _huge(self, p: int):
        """A huge object, by the ID in its heap ID, under the heap's v2
        B-tree of huge objects (record type 1: address, length, ID; type 2,
        filtered: address, filtered length, filter mask, length, ID)."""
        h5 = self.h5
        so, sl = h5.so, h5.sl
        if self.huge is None:
            tree = BTree2(h5, self.huge_tree)
            if tree.kind == 1:
                self.huge = {h5.uint(r + so + sl, sl): (h5.addr(r), h5.uint(r + so, sl), None, 0)
                             for r in tree.records()}
            elif tree.kind == 2:
                self.huge = {h5.uint(r + so + 2 * sl + 4, sl):
                             (h5.addr(r), h5.uint(r + so, sl), h5.uint(r + so + sl + 4, sl),
                              h5.uint(r + so + sl, 4)) for r in tree.records()}
            else:
                raise refuse(f"huge fractal heap objects under v2 B-tree records of type {tree.kind}")
        key = h5.uint(p + 1, min(self.id_len - 1, sl))
        if key not in self.huge:
            raise ValueError(f"HDF5 fractal heap has no huge object {key}")
        addr, stored, size, mask = self.huge[key]
        start = h5.at(addr)
        if size is None:
            return h5.mm, start, stored
        return decode(h5.mm[start:start + stored], self.filters, mask, 1, size), 0, size

    def _direct_block(self, offset: int):
        """(buffer, offset in it, heap offset) of the direct block that
        holds heap offset `offset`, walked down from the root."""
        h5, addr, rows, base = self.h5, self.root, self.root_rows, 0
        if not rows:  # the root is a direct block
            return (*self._direct(addr, self.start, *self.root_filtered), 0)
        filtered = bool(self.filters)
        entry = h5.so + (h5.sl + 4 if filtered else 0)  # a direct block's entry
        while True:  # an indirect block of `rows` rows at heap offset `base`
            rel = offset - base
            row = 0 if rel < self.width * self.start else \
                (rel // (self.width * self.start)).bit_length()
            row_start = 0 if row == 0 else self.width * self.start << (row - 1)
            col = (rel - row_start) // self.block_size(row)
            direct = min(rows, self.direct_rows) * self.width
            indirect = max(rows - self.direct_rows, 0) * self.width
            head = self.h5.so + self.offset_bytes + 5
            p = self._checked(addr, b"FHIB", head + direct * entry + indirect * h5.so)
            base += row_start + col * self.block_size(row)
            if row < self.direct_rows:
                q = p + head + (row * self.width + col) * entry
                stored = (h5.uint(q + h5.so, h5.sl), h5.uint(q + h5.so + h5.sl, 4)) if filtered \
                    else (None, 0)
                return (*self._direct(h5.addr(q), self.block_size(row), *stored), base)
            addr = h5.addr(p + head + direct * entry + ((row - self.direct_rows) * self.width + col) * h5.so)
            rows = row - self.log_width

    def _direct(self, addr, size: int, stored, mask: int):
        """(buffer, offset) of the direct block at `addr`: the file's map, or
        for a filtered block (`stored` bytes in the file) its bytes decoded
        once, each checked as `_checked` checks the file's."""
        if stored is None:
            return self.h5.mm, self._checked(addr, b"FHDB", size)
        if addr not in self.decoded:
            if addr is None:
                raise ValueError("HDF5 fractal heap: no FHDB block where one belongs")
            p = self.h5.at(addr)
            raw = decode(self.h5.mm[p:p + stored], self.filters, mask, 1, size)
            self._verify(raw, 0, size, p)
            self.decoded[addr] = raw
        return self.decoded[addr], 0

    def _checked(self, addr, signature: bytes, size: int) -> int:
        """The file offset of the block at `addr`, its signature and (once)
        its checksum verified: an indirect block's over the `size` bytes
        before it, a direct block's over the whole block with the checksum
        field zeroed (where the heap's flags say direct blocks have one)."""
        h5 = self.h5
        if addr is None:
            raise ValueError(f"HDF5 fractal heap: no {signature.decode()} block where one belongs")
        p = h5.at(addr)
        if p in self.verified:
            return p
        if signature == b"FHIB":
            if h5.mm[p:p + 4] != signature:
                raise ValueError(f"HDF5 fractal heap block FHIB expected at {p}")
            verify(h5.mm, p, p + size, "fractal heap indirect block")
        else:
            self._verify(h5.mm, p, size, p)
        self.verified.add(p)
        return p

    def _verify(self, buf, p: int, size: int, where: int) -> None:
        """A direct block's signature, and its checksum where the heap's flags
        say it has one, over the block with the checksum field zeroed."""
        if buf[p:p + 4] != b"FHDB":
            raise ValueError(f"HDF5 fractal heap block FHDB expected at {where}")
        if self.checksummed:
            at = 5 + self.h5.so + self.offset_bytes
            block = bytearray(buf[p:p + size])
            stored = int.from_bytes(block[at:at + 4], "little")
            block[at:at + 4] = b"\0\0\0\0"
            if lookup3(bytes(block)) != stored:
                raise ValueError(f"HDF5 fractal heap direct block at {where} fails its checksum")
