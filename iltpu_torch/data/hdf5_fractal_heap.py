"""HDF5's fractal heap (`FRHP`): where a dense group keeps its link
messages, and a shared-message table its messages. Managed objects live in
direct blocks (`FHDB`) under a doubling table of indirect blocks (`FHIB`)
of any depth; tiny objects live in their heap ID; huge ones (past the
heap's largest managed object, 4 KB or so in a group's heap: a long link
name) outside the table, found by the v2 B-tree of huge objects. Heaps
whose blocks or huge objects are filtered (h5py makes neither) raise
ValueError naming them.
"""

from typing import Tuple

from iltpu_torch.data.hdf5_btree2 import BTree2
from iltpu_torch.data.hdf5_checksum import lookup3, refuse, verify


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
        if filters_len:
            raise refuse("fractal heap with filtered blocks")
        verify(h5.mm, p, end, "fractal heap header")
        self.checksummed = bool(flags & 0x2)
        self.offset_bytes = (self.max_heap_bits + 7) // 8
        self.length_bytes = (min(self.max_direct, self.max_managed).bit_length() + 7) // 8
        self.direct_rows = _log2(self.max_direct) - _log2(self.start) + 2
        self.log_width = _log2(self.width)
        self.verified = set()  # the blocks whose checksum was verified

    def block_size(self, row: int) -> int:
        return self.start * (1 << max(row - 1, 0))

    def locate(self, p: int) -> Tuple[int, int]:
        """(file offset, length) of the object whose heap ID is at file
        offset `p`."""
        mm, h5 = self.h5.mm, self.h5
        kind = (mm[p] >> 4) & 0x3
        if mm[p] >> 6:
            raise ValueError(f"HDF5 fractal heap ID version {mm[p] >> 6}")
        if kind == 2:  # tiny: the object is in the ID
            if self.id_len <= 18:
                return p + 1, (mm[p] & 0xF) + 1
            return p + 2, ((mm[p] & 0xF) << 8 | mm[p + 1]) + 1
        if kind == 1:
            return self._huge(p)
        offset = h5.uint(p + 1, self.offset_bytes)
        n = h5.uint(p + 1 + self.offset_bytes, self.length_bytes)
        block, base = self._direct_block(offset)
        return block + offset - base, n

    def _huge(self, p: int) -> Tuple[int, int]:
        """A huge object, by the ID in its heap ID, under the heap's v2
        B-tree of huge objects (record type 1: address, length, ID; the
        other types, of filtered objects or of IDs that hold the address,
        raise ValueError)."""
        h5 = self.h5
        if self.huge is None:
            tree = BTree2(h5, self.huge_tree)
            if tree.kind != 1:
                raise refuse(f"huge fractal heap objects under v2 B-tree records of type {tree.kind}")
            self.huge = {h5.uint(r + h5.so + h5.sl, h5.sl): (h5.addr(r), h5.uint(r + h5.so, h5.sl))
                         for r in tree.records()}
        key = h5.uint(p + 1, min(self.id_len - 1, h5.sl))
        if key not in self.huge:
            raise ValueError(f"HDF5 fractal heap has no huge object {key}")
        addr, n = self.huge[key]
        return h5.at(addr), n

    def _direct_block(self, offset: int):
        """(file offset, heap offset) of the direct block that holds heap
        offset `offset`, walked down from the root."""
        h5, addr, rows, base = self.h5, self.root, self.root_rows, 0
        if not rows:  # the root is a direct block
            return self._checked(addr, b"FHDB", self.start), 0
        while True:  # an indirect block of `rows` rows at heap offset `base`
            rel = offset - base
            row = 0 if rel < self.width * self.start else \
                (rel // (self.width * self.start)).bit_length()
            row_start = 0 if row == 0 else self.width * self.start << (row - 1)
            col = (rel - row_start) // self.block_size(row)
            direct = min(rows, self.direct_rows) * self.width
            indirect = max(rows - self.direct_rows, 0) * self.width
            entries = self.h5.so + self.offset_bytes + 5
            p = self._checked(addr, b"FHIB", entries + (direct + indirect) * h5.so)
            base += row_start + col * self.block_size(row)
            if row < self.direct_rows:
                addr = h5.addr(p + entries + (row * self.width + col) * h5.so)
                return self._checked(addr, b"FHDB", self.block_size(row)), base
            addr = h5.addr(p + entries + (direct + (row - self.direct_rows) * self.width + col) * h5.so)
            rows = row - self.log_width

    def _checked(self, addr, signature: bytes, size: int) -> int:
        """The file offset of the block at `addr`, its signature and (once)
        its checksum verified: an indirect block's over the `size` bytes
        before it, a direct block's over the whole block with the checksum
        field zeroed (where the heap's flags say direct blocks have one)."""
        h5 = self.h5
        if addr is None:
            raise ValueError(f"HDF5 fractal heap: no {signature.decode()} block where one belongs")
        p = h5.at(addr)
        if h5.mm[p:p + 4] != signature:
            raise ValueError(f"HDF5 fractal heap block {signature.decode()} expected at {p}")
        if p in self.verified:
            return p
        if signature == b"FHIB":
            verify(h5.mm, p, p + size, "fractal heap indirect block")
        elif self.checksummed:
            at = 5 + h5.so + self.offset_bytes
            block = bytearray(h5.mm[p:p + size])
            stored = int.from_bytes(block[at:at + 4], "little")
            block[at:at + 4] = b"\0\0\0\0"
            if lookup3(bytes(block)) != stored:
                raise ValueError(f"HDF5 fractal heap direct block at {p} fails its checksum")
        self.verified.add(p)
        return p
