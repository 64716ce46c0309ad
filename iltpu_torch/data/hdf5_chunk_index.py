"""Where a chunked dataset's chunks are: the layout message's chunk index.

    layout(h5, p, shape, maxshape, filtered) -> (chunk shape, element size, chunks)

`chunks` yields (element offsets, file offset, stored size, filter mask)
for every chunk that was written. A chunk never written is not yielded (it
reads as the fill value). The indexes:

- layout version 3: a v1 B-tree (`TREE`, node type 1) of any depth;
- layout version 4 (its chunk sizes in 1-8 bytes each, its flag that
  partial edge chunks skip the filters), by index type:
  1 single chunk, filtered or not; 2 implicit (the chunks one after
  another, unfiltered); 3 fixed array (`FAHD`, `FADB`, paged past
  2^page_bits entries); 4 extensible array (`EAHD`, `EAIB`, `EASB`,
  `EADB`, paged data blocks); 5 v2 B-tree (records 10 and 11).

The fixed array, the implicit index and the extensible array number the
chunks in row-major order over the grid of the maximum dimensions (the
extensible array with its unlimited dimension moved first). Every v2
structure's checksum is verified.
"""

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from iltpu_torch.data.hdf5_btree2 import BTree2
from iltpu_torch.data.hdf5_checksum import refuse, verify

Chunk = Tuple[Tuple[int, ...], int, int, int]  # offsets, file offset, size, filter mask
SINGLE, IMPLICIT, FIXED_ARRAY, EXTENSIBLE_ARRAY, BTREE2 = 1, 2, 3, 4, 5


def layout(h5, p: int, shape: Sequence[int], maxshape: Sequence[Optional[int]],
           filtered: bool) -> Tuple[Tuple[int, ...], int, Iterator[Chunk]]:
    """The chunked layout message at `p` (class 2): chunk shape, element
    size, and its written chunks."""
    version = h5.mm[p]
    if version == 3:
        ndims = h5.mm[p + 2]
        dims = [h5.uint(p + 3 + h5.so + 4 * i, 4) for i in range(ndims)]
        chunk = tuple(dims[:-1])
        return chunk, dims[-1], _btree1(h5, h5.addr(p + 3), ndims)
    if version != 4:
        raise refuse(f"layout version {version}")
    flags, ndims, width = h5.mm[p + 2], h5.mm[p + 3], h5.mm[p + 4]
    dims = [h5.uint(p + 5 + width * i, width) for i in range(ndims)]
    chunk, itemsize = tuple(dims[:-1]), dims[-1]
    q = p + 5 + width * ndims
    kind, q = h5.mm[q], q + 1
    nbytes = itemsize * int(np.prod(chunk))
    grid = [-(-(m if m is not None else s) // c) for m, s, c in zip(maxshape, shape, chunk)]
    if kind == SINGLE:
        size, mask = nbytes, 0
        if flags & 0x2:
            size, mask, q = h5.uint(q, h5.sl), h5.uint(q + h5.sl, 4), q + h5.sl + 4
        chunks = _single(h5, h5.addr(q), size, mask, len(chunk))
    elif kind == IMPLICIT:
        chunks = _implicit(h5, h5.addr(q), chunk, grid, nbytes)
    elif kind == FIXED_ARRAY:
        chunks = _fixed_array(h5, h5.addr(q + 1), chunk, grid, nbytes)
    elif kind == EXTENSIBLE_ARRAY:
        unlimited = [i for i, m in enumerate(maxshape) if m is None]
        chunks = _extensible_array(h5, h5.addr(q + 5), chunk, grid, unlimited[0], nbytes)
    elif kind == BTREE2:
        chunks = _btree2(h5, h5.addr(q + 6), chunk, nbytes)
    else:
        raise refuse(f"chunk index type {kind}")
    if flags & 0x1 and filtered:
        chunks = _edge_chunks_raw(chunks, chunk, shape)
    return chunk, itemsize, chunks


def _edge_chunks_raw(chunks: Iterator[Chunk], chunk, shape) -> Iterator[Chunk]:
    """The layout's "don't filter partial edge chunks": a chunk that crosses
    the dataset's edge is stored as it is."""
    for offsets, pos, size, mask in chunks:
        partial = any(o + c > s for o, c, s in zip(offsets, chunk, shape))
        yield offsets, pos, size, (0xFFFFFFFF if partial else mask)


def _btree1(h5, addr, ndims: int) -> Iterator[Chunk]:
    if addr is None:
        return
    for key, child in h5.btree_leaves(addr, 1, 8 + 8 * ndims):
        offsets = tuple(h5.uint(key + 8 + 8 * i, 8) for i in range(ndims - 1))
        yield offsets, h5.at(child), h5.uint(key, 4), h5.uint(key + 4, 4)


def _single(h5, addr, size: int, mask: int, rank: int) -> Iterator[Chunk]:
    if addr is not None:
        yield (0,) * rank, h5.at(addr), size, mask


def _coords(index: int, chunk, grid: List[int], order: List[int]) -> Tuple[int, ...]:
    """The element offsets of the chunk at linear `index` in row-major order
    over `grid` with its dimensions taken in `order`."""
    offsets = [0] * len(chunk)
    for d in reversed(order):
        index, offsets[d] = divmod(index, grid[d])
        offsets[d] *= chunk[d]
    offsets[order[0]] += index * grid[order[0]] * chunk[order[0]]  # the first may grow
    return tuple(offsets)


def _implicit(h5, addr, chunk, grid, nbytes: int) -> Iterator[Chunk]:
    if addr is None:
        return
    order = list(range(len(chunk)))
    for i in range(int(np.prod(grid))):
        yield _coords(i, chunk, grid, order), h5.at(addr) + i * nbytes, nbytes, 0


def _entry(h5, q: int, esize: int, nbytes: int):
    """A fixed or extensible array's element: the chunk's address, then (for
    filtered chunks) its size and filter mask; None where never written."""
    addr = h5.addr(q)
    if addr is None:
        return None
    if esize == h5.so:
        return h5.at(addr), nbytes, 0
    return h5.at(addr), h5.uint(q + h5.so, esize - h5.so - 4), h5.uint(q + esize - 4, 4)


def _bit(bitmap: bytes, i: int) -> bool:
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _pages(h5, start: int, n: int, esize: int, page: int, bitmap, first: int = 0):
    """(index, file offset) of each element of `n` stored in pages of
    `page` elements from `start` (each page followed by its checksum),
    pages whose bit in `bitmap` (from bit `first`) is clear skipped."""
    for k in range(-(-n // page)):
        count = min(page, n - k * page)
        if _bit(bitmap, first + k):
            verify(h5.mm, start, start + count * esize, "array data block page")
            for j in range(count):
                yield k * page + j, start + j * esize
        start += count * esize + 4


def _fixed_array(h5, addr, chunk, grid, nbytes: int) -> Iterator[Chunk]:
    if addr is None:
        return
    p = h5.at(addr)
    if h5.mm[p:p + 4] != b"FAHD":
        raise ValueError(f"HDF5 fixed array header expected at {p}")
    esize, page_bits, n = h5.mm[p + 6], h5.mm[p + 7], h5.uint(p + 8, h5.sl)
    block = h5.addr(p + 8 + h5.sl)
    verify(h5.mm, p, p + 8 + h5.sl + h5.so, "fixed array header")
    if block is None:
        return
    b = h5.at(block)
    if h5.mm[b:b + 4] != b"FADB":
        raise ValueError(f"HDF5 fixed array data block expected at {b}")
    q, page = b + 6 + h5.so, 1 << page_bits
    if n > page:  # paged: a bitmap of the pages written, then the pages
        npages = -(-n // page)
        bitmap = h5.mm[q:q + (npages + 7) // 8]
        q += len(bitmap)
        verify(h5.mm, b, q, "fixed array data block")
        elements = _pages(h5, q + 4, n, esize, page, bitmap)
    else:
        verify(h5.mm, b, q + n * esize, "fixed array data block")
        elements = ((i, q + i * esize) for i in range(n))
    order = list(range(len(chunk)))
    for i, e in elements:
        entry = _entry(h5, e, esize, nbytes)
        if entry is not None:
            yield (_coords(i, chunk, grid, order), *entry)


def _extensible_array(h5, addr, chunk, grid, unlimited: int, nbytes: int) -> Iterator[Chunk]:
    if addr is None:
        return
    so, sl, mm = h5.so, h5.sl, h5.mm
    p = h5.at(addr)
    if mm[p:p + 4] != b"EAHD":
        raise ValueError(f"HDF5 extensible array header expected at {p}")
    esize, max_bits, index_elements = mm[p + 6], mm[p + 7], mm[p + 8]
    min_elements, min_pointers, page_bits = mm[p + 9], mm[p + 10], mm[p + 11]
    used = h5.uint(p + 12 + 4 * sl, sl)  # the max index set: the elements in use
    index_block = h5.addr(p + 12 + 6 * sl)
    verify(mm, p, p + 12 + 6 * sl + so, "extensible array header")
    if index_block is None:
        return
    order = [unlimited] + [d for d in range(len(chunk)) if d != unlimited]
    offset_bytes = (max_bits + 7) // 8
    page = 1 << page_bits
    # super block u holds 2^(u // 2) data blocks of 2^((u + 1) // 2) * min_elements
    # elements; the index block points at the data blocks of the first ones itself
    nsuper = 1 + max_bits - (min_elements.bit_length() - 1)
    direct_supers = 2 * (min_pointers.bit_length() - 1)
    ndirect = 2 * (min_pointers - 1)
    b = h5.at(index_block)
    if mm[b:b + 4] != b"EAIB":
        raise ValueError(f"HDF5 extensible array index block expected at {b}")
    q = b + 6 + so
    dblocks = q + index_elements * esize
    sblocks = dblocks + ndirect * so
    verify(mm, b, sblocks + (nsuper - direct_supers) * so, "extensible array index block")

    def elements():
        for i in range(min(index_elements, used)):
            yield i, q + i * esize
        start, direct = index_elements, 0
        for u in range(nsuper):
            count, size = 1 << (u // 2), (1 << ((u + 1) // 2)) * min_elements
            if start >= used:
                return
            paged = size > page
            if u < direct_supers:
                addrs = [h5.addr(dblocks + (direct + k) * so) for k in range(count)]
                direct += count
                bitmap = None
            else:
                s = h5.addr(sblocks + (u - direct_supers) * so)
                addrs, bitmap = ([None] * count, None) if s is None else \
                    _super_block(h5, s, count, -(-size // page) if paged else 0, offset_bytes)
            for k, d in enumerate(addrs):
                if d is not None:
                    yield from _data_block(h5, d, start, size, esize, page if paged else 0,
                                           bitmap, k * -(-size // page), offset_bytes)
                start += size

    for i, e in elements():
        if i >= used:
            continue
        entry = _entry(h5, e, esize, nbytes)
        if entry is not None:
            yield (_coords(i, chunk, grid, order), *entry)


def _super_block(h5, addr, count: int, pages: int, offset_bytes: int):
    """A super block's data block addresses and its bitmap of the pages
    written (`pages` a data block; 0: its data blocks are not paged)."""
    p = h5.at(addr)
    if h5.mm[p:p + 4] != b"EASB":
        raise ValueError(f"HDF5 extensible array super block expected at {p}")
    q = p + 6 + h5.so + offset_bytes
    # the bitmap's bits run on from one data block to the next; each takes whole bytes
    bitmap = h5.mm[q:q + count * ((pages + 7) // 8)] if pages else None
    q += len(bitmap) if pages else 0
    verify(h5.mm, p, q + count * h5.so, "extensible array super block")
    return [h5.addr(q + k * h5.so) for k in range(count)], bitmap


def _data_block(h5, addr, start: int, size: int, esize: int, page: int, bitmap, first: int,
                offset_bytes: int):
    p = h5.at(addr)
    if h5.mm[p:p + 4] != b"EADB":
        raise ValueError(f"HDF5 extensible array data block expected at {p}")
    q = p + 6 + h5.so + offset_bytes
    if page:
        if bitmap is None:
            raise refuse("paged extensible array data block under the index block")
        verify(h5.mm, p, q, "extensible array data block")
        for i, e in _pages(h5, q + 4, size, esize, page, bitmap, first):
            yield start + i, e
        return
    verify(h5.mm, p, q + size * esize, "extensible array data block")
    for i in range(size):
        yield start + i, q + i * esize


def _btree2(h5, addr, chunk, nbytes: int) -> Iterator[Chunk]:
    if addr is None:
        return
    tree = BTree2(h5, addr)
    rank, so = len(chunk), h5.so
    if tree.kind not in (10, 11):
        raise ValueError(f"HDF5 chunk index: v2 B-tree of record type {tree.kind}")
    size_bytes = tree.record_size - so - 4 - 8 * rank
    for r in tree.records():
        q = r + so
        size, mask = nbytes, 0
        if tree.kind == 11:
            size, mask = h5.uint(q, size_bytes), h5.uint(q + size_bytes, 4)
            q += size_bytes + 4
        offsets = tuple(h5.uint(q + 8 * i, 8) * chunk[i] for i in range(rank))
        yield offsets, h5.at(h5.addr(r)), size, mask
