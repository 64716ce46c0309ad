"""HDF5's virtual dataset layout (layout class 3), read as h5py reads it
under its default view (`H5D_VDS_LAST_AVAILABLE`, no gap between printf
sources). Numpy and the standard library only.

The layout message names a global heap object: the mapping block's version
(0), its entry count, then per entry the source file's and dataset's names
and two serialized selections, the source's and the virtual dataset's, and
a lookup3 checksum. A selection (`selection`) is all, none or a
hyperslab (versions 1-3, regular or a list of blocks, in 2-, 4- or 8-byte
fields; a regular one's count or block may be unlimited); HDF5 1.14.6
refuses to map point selections, and so does the reader. A mapping copies
the source selection's elements, in row-major order, onto the virtual
selection's.
Elements no mapping reaches, and those of a source whose file or dataset is
missing, read as the virtual dataset's fill value. A source of another
numeric type is converted as HDF5 converts it (`hdf5_convert.numeric`).

Unlimited mappings: where the source selection is unlimited too, as many
slices of the virtual selection as the source's extent holds are mapped;
where only the virtual one is, its `%b` names source block `b` (`%%` is a
`%`), for b = 0, 1, ... while that source exists. The extent in an
unlimited dimension is then the largest such mapping's, and at least what
the fixed mappings reach.
"""

from itertools import count
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from iltpu_torch.data import hdf5_convert
from iltpu_torch.data.hdf5_checksum import refuse, verify

NONE, POINTS, HYPERSLAB, ALL = 0, 1, 2, 3


class Selection(NamedTuple):
    kind: int
    version: int
    size: int  # bytes a field
    rank: int
    regular: Optional[Tuple[Tuple[Optional[int], ...], ...]] = None  # per dim: start, stride, count, block
    blocks: Optional[np.ndarray] = None  # (n, 2, rank): each block's start and end, inclusive


class Mapping(NamedTuple):
    file: str
    dataset: str
    source: Selection
    virtual: Selection


def selection(h5, q: int) -> Tuple[Selection, int]:
    """The serialized selection at `q` and the offset past it."""
    kind, version = h5.uint(q, 4), h5.uint(q + 4, 4)
    if kind in (ALL, NONE) and version == 1:
        return Selection(kind, version, 4, 0), q + 16
    if kind == POINTS:  # HDF5 1.14.6 refuses to map point selections
        raise refuse("point selection in a virtual dataset's mapping")
    if kind == HYPERSLAB and version in (1, 2, 3):
        flags = 0
        if version == 1:
            size, rank, q = 4, h5.uint(q + 16, 4), q + 20
        elif version == 2:
            flags, size, rank, q = h5.mm[q + 8], 8, h5.uint(q + 13, 4), q + 17
        else:
            flags, size, rank, q = h5.mm[q + 8], h5.mm[q + 9], h5.uint(q + 10, 4), q + 14
        if flags & 0x1:  # regular: start, stride, count and block in each dimension
            top = (1 << (8 * size)) - 1
            values = np.frombuffer(h5.mm[q:q + 4 * rank * size], f"<u{size}").reshape(rank, 4).tolist()
            regular = tuple((s, t, None if c == top else c, None if b == top else b)
                            for s, t, c, b in values)
            return Selection(kind, version, size, rank, regular=regular), q + 4 * rank * size
        n, q = h5.uint(q, size if version > 1 else 4), q + (size if version > 1 else 4)
        blocks = _ints(h5, q, 2 * n * rank, size).reshape(n, 2, rank)
        return Selection(kind, version, size, rank, blocks=blocks), q + 2 * n * rank * size
    raise refuse(f"dataspace selection of type {kind}, version {version}")


def _ints(h5, q: int, n: int, size: int) -> np.ndarray:
    return np.frombuffer(h5.mm[q:q + n * size], f"<u{size}").astype(np.int64)


def mappings(h5, p: int) -> List[Mapping]:
    """The mapping block the virtual layout message at `p` names."""
    start, size = h5.global_heap.locate(h5.addr(p + 2), h5.uint(p + 2 + h5.so, 4))
    if h5.mm[start] != 0:
        raise refuse(f"virtual dataset mapping block version {h5.mm[start]}")
    verify(h5.mm, start, start + size - 4, "virtual dataset mapping block")
    q, out = start + 1 + h5.sl, []
    for _ in range(h5.uint(start + 1, h5.sl)):
        names = []
        for _ in range(2):
            end = h5.mm.find(b"\0", q)
            names.append(h5.mm[q:end].decode())
            q = end + 1
        source, q = selection(h5, q)
        virtual, q = selection(h5, q)
        out.append(Mapping(names[0], names[1], source, virtual))
    return out


def _unlimited(sel: Selection) -> int:
    """The dimension in which a regular hyperslab is unlimited, or -1."""
    if sel.regular is not None:
        for d, (_, _, c, b) in enumerate(sel.regular):
            if c is None or b is None:
                return d
    return -1


def _indices(start: int, stride: int, n: Optional[int], block: Optional[int], limit: int) -> np.ndarray:
    """One dimension of a regular hyperslab: its indices below `limit`,
    ascending (an unlimited count or block runs to `limit`)."""
    if block is None:
        return np.arange(start, max(start, limit))
    if n is None:
        n = max(0, -(-(limit - start) // stride))
    idx = (start + stride * np.arange(n)[:, None] + np.arange(block)[None, :]).reshape(-1)
    return np.unique(idx[idx < limit])


def elements(sel: Selection, shape, limit: Optional[int] = None) -> Tuple[np.ndarray, ...]:
    """The selection's coordinates in its order (one index array a
    dimension) in a dataspace of `shape`; an unlimited dimension's indices
    stop at its extent, or at the first `limit` of them."""
    rank = len(shape)
    if sel.kind == NONE:
        return tuple(np.zeros(0, np.int64) for _ in range(rank))
    if sel.kind == ALL:
        return tuple(g.reshape(-1) for g in np.indices(shape))
    if sel.regular is not None:
        per_dim = [_indices(s, t, c, b, shape[d]) for d, (s, t, c, b) in enumerate(sel.regular)]
        d = _unlimited(sel)
        if d >= 0 and limit is not None:
            per_dim[d] = per_dim[d][:limit]
        return tuple(g.reshape(-1) for g in np.meshgrid(*per_dim, indexing="ij"))
    lo, hi = sel.blocks[:, 0].min(axis=0), sel.blocks[:, 1].max(axis=0)
    mask = np.zeros(tuple(hi - lo + 1), bool)
    for start, end in sel.blocks:
        mask[tuple(slice(a - o, b - o + 1) for a, b, o in zip(start, end, lo))] = True
    return tuple(i + o for i, o in zip(np.nonzero(mask), lo))


def _slices(sel: Selection, limit: int) -> int:
    """How many indices a regular hyperslab has in its unlimited dimension
    below `limit`."""
    d = _unlimited(sel)
    s, t, c, b = sel.regular[d]
    return len(_indices(s, t, c, b, limit))


def _clip_extent(sel: Selection, slices: int) -> int:
    """The extent in its unlimited dimension that holds `slices` of a
    regular hyperslab's indices there, ending with the last (HDF5's
    `H5S__hyper_get_clip_extent_real`, trailing space excluded)."""
    s, t, c, b = sel.regular[_unlimited(sel)]
    if not slices:
        return 0
    if b is None or b == t:
        return s + slices
    n, rest = divmod(slices, b)
    return s + n * t + rest if rest else s + (n - 1) * t + b


def _block(sel: Selection, i: int) -> Selection:
    """Block `i` of a regular hyperslab unlimited in its count."""
    d = _unlimited(sel)
    regular = list(sel.regular)
    s, t, _, b = regular[d]
    regular[d] = (s + i * t, 1, 1, b)
    return sel._replace(regular=tuple(regular))


def _printf(name: str, i: int) -> str:
    """A printf-style source name with `%b` as block `i` and `%%` as `%`."""
    out, k = [], 0
    while k < len(name):
        if name[k] == "%":
            nxt = name[k + 1:k + 2]
            if nxt not in ("b", "%"):
                raise ValueError(f"HDF5 virtual source name {name!r}: bad format specifier")
            out.append(str(i) if nxt == "b" else "%")
            k += 2
        else:
            out.append(name[k])
            k += 1
    return "".join(out)


def _source(h5, file: str, dataset: str):
    """(file, object header address) of a mapping's source dataset, or None
    where its file or the dataset is missing."""
    src = h5.files.virtual_source(h5, file)
    if src is None:
        return None
    try:
        return src.walk(dataset, 16)
    except (KeyError, ValueError):
        return None


def read(h5, p: int, dtype, shape, maxshape, fill: Optional[bytes]) -> np.ndarray:
    """The virtual dataset whose layout message is at `p` (its datatype, the
    stored extent and maximum, the fill value's bytes or None)."""
    maps = mappings(h5, p)
    extent = list(shape)
    found, floor, grown = [], [0] * len(shape), {}
    for m in maps:
        d = _unlimited(m.virtual)
        for k, end in enumerate(_bounds(m.virtual, shape)):
            if k != d:
                floor[k] = max(floor[k], end)
        if d < 0:
            found.append((m, [(_source(h5, m.file, m.dataset), m.virtual, None)]))
        elif _unlimited(m.source) >= 0:  # the source grows: as many slices as it holds
            src = _source(h5, m.file, m.dataset)
            n = 0
            if src is not None:
                n = _slices(m.source, src[0].extent(src[1])[0][_unlimited(m.source)])
            grown[d] = max(grown.get(d, 0), _clip_extent(m.virtual, n))
            found.append((m, [(src, m.virtual, n)] if n else []))
        else:  # printf-style: block b from the source its names give for b
            if "%b" not in m.file and "%b" not in m.dataset:  # HDF5 writes no such mapping
                raise refuse("unlimited virtual mapping of a fixed source without %b")
            parts = []
            for b in count():
                src = _source(h5, _printf(m.file, b), _printf(m.dataset, b))
                if src is None:
                    break
                parts.append((src, _block(m.virtual, b), None))
            grown[d] = max(grown.get(d, 0), _clip_extent(m.virtual, len(parts) * m.virtual.regular[d][3]))
            found.append((m, parts))
    for d, n in grown.items():
        extent[d] = max(n, floor[d])
    out = np.zeros(extent, dtype.dtype)
    if fill is not None:
        out[...] = dtype.read(np.frombuffer(fill, dtype.storage) if dtype.storage.shape == () else
                              np.ndarray((), dtype.storage, fill))
    for m, parts in found:
        for src, virtual, slices in parts:
            if src is None:
                continue
            where, addr = src
            idx = elements(m.source, where.extent(addr)[0])
            at = elements(virtual, extent, slices)
            if not idx:  # a scalar source
                values = where.read(addr).reshape(1)
            elif len(idx[0]):
                box = tuple((int(i.min()), int(i.max()) + 1) for i in idx)
                values = where.read(addr, box)[tuple(i - a for i, (a, _) in zip(idx, box))]
            else:
                continue
            if len(at[0]) != len(values):
                raise ValueError(f"HDF5 virtual mapping of {m.dataset!r}: {len(values)} source "
                                 f"elements for {len(at[0])} virtual ones")
            if values.dtype != dtype.dtype:
                values = hdf5_convert.numeric(values, dtype.dtype)
            out[at] = values
    return out


def _bounds(sel: Selection, shape) -> List[int]:
    """One past a selection's largest index in each dimension (an unlimited
    dimension's taken as 0)."""
    if sel.kind == NONE:
        return [0] * len(shape)
    if sel.kind == ALL:
        return list(shape)
    if sel.blocks is not None:
        return (sel.blocks[:, 1].max(axis=0) + 1).tolist()
    return [0 if c is None or b is None else s + (c - 1) * t + b for s, t, c, b in sel.regular]
