"""HDF5's version-2 B-trees (`BTHD` header, `BTIN` internal and `BTLF`
leaf nodes) of any depth: the name index (record type 5) and creation-order
index (6) of a dense group's links, and the chunk index (10, 11) of a
dataset with more than one unlimited dimension. Every node's checksum is
verified.
"""

from typing import Iterator

from iltpu_torch.data.hdf5_checksum import verify


def _bytes_for(n: int) -> int:
    """The fewest bytes that encode `n` (at least 1)."""
    return max(1, (n.bit_length() + 7) // 8)


class BTree2:
    """The tree whose header is at `addr`: `kind` its record type,
    `record_size`, and `records()` the file offset of each record in key
    order."""

    def __init__(self, h5, addr: int):
        self.h5 = h5
        p = h5.at(addr)
        if h5.mm[p:p + 4] != b"BTHD" or h5.mm[p + 4] != 0:
            raise ValueError(f"HDF5 v2 B-tree header expected at {p}")
        self.kind, node_size = h5.mm[p + 5], h5.uint(p + 6, 4)
        self.record_size, self.depth = h5.uint(p + 10, 2), h5.uint(p + 12, 2)
        self.root, self.root_records = h5.addr(p + 16), h5.uint(p + 16 + h5.so, 2)
        verify(h5.mm, p, p + 18 + h5.so + h5.sl, "v2 B-tree header")
        # the size of each level's child pointers: the most records a leaf,
        # and under an internal node of each depth, can hold
        leaf = (node_size - 10) // self.record_size
        self.nrec_bytes, cumulative, self.total_bytes = _bytes_for(leaf), leaf, [0]
        for depth in range(1, self.depth + 1):
            pointer = h5.so + self.nrec_bytes + self.total_bytes[depth - 1]
            most = (node_size - 10 - pointer) // (self.record_size + pointer)
            cumulative = (most + 1) * cumulative + most
            self.total_bytes.append(_bytes_for(cumulative))

    def records(self) -> Iterator[int]:
        if self.root is not None and self.root_records:
            yield from self._node(self.root, self.root_records, self.depth)

    def _node(self, addr: int, n: int, depth: int) -> Iterator[int]:
        h5, rs = self.h5, self.record_size
        p = h5.at(addr)
        want = b"BTIN" if depth else b"BTLF"
        if h5.mm[p:p + 4] != want or h5.mm[p + 5] != self.kind:
            raise ValueError(f"HDF5 v2 B-tree node {want.decode()} expected at {p}")
        records = p + 6
        if not depth:
            verify(h5.mm, p, records + n * rs, "v2 B-tree leaf")
            yield from range(records, records + n * rs, rs)
            return
        pointer = h5.so + self.nrec_bytes + (self.total_bytes[depth - 1] if depth > 1 else 0)
        children = records + n * rs
        verify(h5.mm, p, children + (n + 1) * pointer, "v2 B-tree internal node")
        for i in range(n + 1):
            q = children + i * pointer
            yield from self._node(h5.addr(q), h5.uint(q + h5.so, self.nrec_bytes), depth - 1)
            if i < n:
                yield records + i * rs
