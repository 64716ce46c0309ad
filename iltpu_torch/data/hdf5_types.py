"""HDF5 datatype messages as the numpy dtypes h5py gives
(`np.asarray(f[k])`), and the global heap (`GCOL`) that variable-length
data lives in. Numpy and the standard library only.

Each datatype becomes a `Type`: `storage`, the numpy dtype of one element's
bytes in the file; `dtype`, the one h5py gives; and `read(a)`, which turns
an array of `storage` into one of `dtype`. The classes:

- fixed-point (0, 1-8 bytes, either order, signed or not; a precision or
  bit offset short of the whole element is shifted and sign-extended);
- floating point (1: IEEE half, single and double, either order);
- fixed-length strings (3) as `S<n>`, their bytes as stored;
- bitfields (4) as the unsigned integer of their size, opaque (5) as `V<n>`;
- compounds (6, versions 1-3) as structured dtypes with the file's names,
  offsets and size, packed where a member's numpy size is not its size in
  the file (a variable-length member is an 8-byte object);
- enums (8): h5py's bool (FALSE = 0, TRUE = 1) as `bool`, any other as its
  base integer type;
- variable-length strings and sequences (9) as object arrays of `bytes`
  and of numpy arrays, read from the global heap;
- arrays (10, versions 2 and 3) as numpy subarrays (a dataset of them reads
  with the array's dimensions last).

Time (2) and reference (7) datatypes raise ValueError naming the class.
"""

from typing import Callable, Optional, Tuple

import numpy as np

from iltpu_torch.data import hdf5_convert
from iltpu_torch.data.hdf5_checksum import refuse

IEEE = {2: (10, 5, 0, 10, 15), 4: (23, 8, 0, 23, 127), 8: (52, 11, 0, 52, 1023)}


class Type:
    """One datatype: its bytes in the file (`storage`), the dtype h5py gives
    (`dtype`), and the conversion between them (None: the same bytes)."""

    def __init__(self, storage: np.dtype, dtype: Optional[np.dtype] = None,
                 convert: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.storage = np.dtype(storage)
        self.dtype = self.storage if dtype is None else np.dtype(dtype)
        self.convert = convert

    def read(self, a: np.ndarray) -> np.ndarray:
        """An array of `storage` as an array of `dtype`."""
        return a if self.convert is None else self.convert(a)


def _name(h5, q: int, padded: bool) -> Tuple[str, int]:
    """A null-terminated name at `q` and the offset past it (past its padding
    to a multiple of 8 bytes where `padded`)."""
    end = h5.mm.find(b"\0", q)
    name = h5.mm[q:end].decode()
    return name, (q + ((end - q) // 8 + 1) * 8 if padded else end + 1)


def parse(h5, p: int) -> Tuple[Type, int]:
    """The datatype message at `p`: its Type and its length in bytes."""
    mm = h5.mm
    cls, version = mm[p] & 0xF, mm[p] >> 4
    bits, size = h5.uint(p + 1, 3), h5.uint(p + 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0 and size in (1, 2, 4, 8):
        return _fixed(h5, p, order, bits & 0x8, size), 12
    if cls == 1:
        return _float(h5, p, version, bits, size), 20
    if cls == 3:
        return Type(f"S{size}"), 8
    if cls == 4 and size in (1, 2, 4, 8):
        return Type(f"{order}u{size}"), 12
    if cls == 5:
        return Type(f"V{size}"), 8 + (bits & 0xFF)
    if cls == 6:
        return _compound(h5, p, version, bits & 0xFFFF, size)
    if cls == 8:
        return _enum(h5, p, version, bits & 0xFFFF)
    if cls == 9:
        base, n = parse(h5, p + 8)
        return _vlen(h5, base, bits & 0xF == 1), 8 + n
    if cls == 10:
        rank = mm[p + 8]
        q = p + 9 if version >= 3 else p + 12
        dims = tuple(h5.uint(q + 4 * i, 4) for i in range(rank))
        q += 4 * rank * (1 if version >= 3 else 2)  # version 2: a permutation after the sizes
        base, n = parse(h5, q)
        return Type((base.storage, dims), (base.dtype, dims), base.convert), q + n - p
    raise refuse(f"datatype class {cls} of {size} bytes")


def _float(h5, p: int, version: int, bits: int, size: int) -> Type:
    """A floating-point type: numpy's own where it is IEEE's layout in
    either byte order, else the IEEE dtype h5py picks for it, converted as
    HDF5 converts it (`hdf5_convert.floats`). Bit 6 of the order makes it
    VAX only in a message of version 3 or later, as HDF5 decodes it: an
    earlier message (the one HDF5 1.14.6 writes) reads as big-endian, and a
    later one raises ValueError, as h5py has no dtype for that order."""
    mm = h5.mm
    if version >= 3 and bits & 0x40:
        raise refuse("VAX-ordered float in a datatype message of version 3")
    order = bits & 1
    offset, precision = h5.uint(p + 8, 2), h5.uint(p + 10, 2)
    epos, esize, mpos, msize, bias = mm[p + 12], mm[p + 13], mm[p + 14], mm[p + 15], h5.uint(p + 16, 4)
    norm, sign = (bits >> 4) & 0x3, (bits >> 8) & 0xFF
    src = hdf5_convert.Float(size, order, offset, precision, sign, epos, esize, mpos, msize, bias,
                             norm, (bits >> 1) & 1, (bits >> 2) & 1)
    char = "<>"[order]
    if (size in IEEE and (offset, precision) == (0, 8 * size)
            and (epos, esize, mpos, msize, bias) == IEEE[size] and norm == hdf5_convert.NORM_IMPLIED
            and sign == 8 * size - 1):
        return Type(f"{char}f{size}")
    # h5py's choice (its TypeFloatID.py_dtype): the narrowest IEEE float whose
    # mantissa and exponent range hold the type's
    top, bottom = 2 ** esize - 2 - bias, 1 - bias
    for width, (m, e) in ((2, (10, 15)), (4, (23, 127)), (8, (52, 1023)), (16, (112, 16383))):
        if msize <= m and top <= e and bottom >= 1 - e:
            break
    else:
        raise refuse(f"float of a {msize}-bit mantissa and {esize}-bit exponent")
    dtype = np.dtype(f"{char}f{width}")
    dst = hdf5_convert.ieee(dtype)
    return Type(f"V{size}", dtype, lambda a: hdf5_convert.floats(a, src, dst).view(dtype))


def _fixed(h5, p: int, order: str, signed: int, size: int) -> Type:
    kind = f"{order}{'i' if signed else 'u'}{size}"
    offset, precision = h5.uint(p + 8, 2), h5.uint(p + 10, 2)
    if (offset, precision) == (0, 8 * size):
        return Type(kind)

    def convert(a):  # the `precision` bits at `offset`, sign-extended where signed
        v = a.astype(f"=u{size}").astype(np.uint64) >> np.uint64(offset)
        v &= np.uint64((1 << precision) - 1)
        if signed:
            top = np.uint64(1 << (precision - 1))
            v = (v ^ top) - top  # wraps to the two's complement in uint64
        return v.astype(f"=u{size}").view(f"=i{size}" if signed else f"=u{size}").astype(kind)
    return Type(kind, kind, convert)


def _enum(h5, p: int, version: int, n: int) -> Tuple[Type, int]:
    base, length = parse(h5, p + 8)
    q, members = p + 8 + length, []
    for _ in range(n):
        name, q = _name(h5, q, version < 3)
        members.append(name)
    values = np.frombuffer(h5.mm[q:q + n * base.storage.itemsize], base.storage).tolist()
    q += n * base.storage.itemsize
    if base.dtype.kind in "iu" and dict(zip(members, values)) == {"FALSE": 0, "TRUE": 1}:
        if base.storage.itemsize == 1:
            return Type(bool), q - p  # h5py's bool: the bytes are 0 or 1
        return Type(base.storage, bool, lambda a: base.read(a) != 0), q - p
    return base, q - p


def _compound(h5, p: int, version: int, n: int, size: int) -> Tuple[Type, int]:
    q, names, members, offsets = p + 8, [], [], []
    offset_bytes = max(1, (size.bit_length() + 7) // 8)
    for _ in range(n):
        name, q = _name(h5, q, version < 3)
        if version >= 3:
            offset, q = h5.uint(q, offset_bytes), q + offset_bytes
        else:
            offset, q = h5.uint(q, 4), q + 4
        dims = ()
        if version == 1:  # a rank (up to 4) and sizes, before the member's type
            dims = tuple(h5.uint(q + 12 + 4 * i, 4) for i in range(h5.mm[q]))
            q += 28
        member, length = parse(h5, q)
        q += length
        if dims:
            member = Type((member.storage, dims), (member.dtype, dims), member.convert)
        names.append(name)
        members.append(member)
        offsets.append(offset)
    storage = np.dtype({"names": names, "formats": [m.storage for m in members],
                        "offsets": offsets, "itemsize": size})
    if all(m.convert is None for m in members):
        return Type(storage), q - p
    if all(m.dtype.itemsize == m.storage.itemsize for m in members):
        dtype = np.dtype({"names": names, "formats": [m.dtype for m in members],
                          "offsets": offsets, "itemsize": size})
    else:  # h5py packs the members where one changes size (a variable-length one)
        dtype = np.dtype([(name, m.dtype) for name, m in zip(names, members)])

    def convert(a):
        out = np.empty(a.shape, dtype)
        for name, m in zip(names, members):
            out[name] = m.read(a[name])
        return out
    return Type(storage, dtype, convert), q - p


def _vlen(h5, base: Type, string: bool) -> Type:
    """A variable-length element: its length (4 bytes), then the global heap
    ID of its data: the collection's address and the object's index (4)."""
    so = h5.so
    storage = np.dtype({"names": ["n", "heap", "index"], "formats": ["<u4", f"<u{so}", "<u4"],
                        "offsets": [0, 4, 4 + so], "itemsize": 8 + so})

    def element(n, heap, index):
        data = h5.global_heap(heap, index)
        if string:
            return data[:n]
        return base.read(np.frombuffer(data, base.storage, n).copy())

    def convert(a):
        out = np.empty(a.shape, object)
        flat = out.reshape(-1)
        for i, (n, heap, index) in enumerate(a.reshape(-1).tolist()):
            if n == 0:
                flat[i] = b"" if string else np.zeros(0, base.dtype)
            else:
                flat[i] = element(n, int(heap), index)
        return out
    return Type(storage, object, convert)


class GlobalHeap:
    """The objects of `GCOL` collections, each collection parsed once."""

    def __init__(self, h5):
        self.h5 = h5
        self.collections = {}

    def __call__(self, addr: int, index: int) -> bytes:
        start, size = self.locate(addr, index)
        return self.h5.mm[start:start + size]

    def locate(self, addr: int, index: int) -> Tuple[int, int]:
        """(file offset, size) of object `index` of the collection at `addr`."""
        if addr not in self.collections:
            self.collections[addr] = self._collection(addr)
        if index not in self.collections[addr]:
            raise ValueError(f"HDF5 global heap {addr} has no object {index}")
        return self.collections[addr][index]

    def _collection(self, addr: int):
        h5, p = self.h5, self.h5.at(addr)
        if h5.mm[p:p + 4] != b"GCOL":
            raise ValueError(f"HDF5 global heap collection expected at {p}")
        end, q, objects = p + h5.uint(p + 8, h5.sl), p + 8 + h5.sl, {}
        while q + 8 + h5.sl <= end:
            index, size = h5.uint(q, 2), h5.uint(q + 8, h5.sl)
            if index == 0:  # free space: the rest of the collection
                break
            objects[index] = (q + 8 + h5.sl, size)
            q += 8 + h5.sl + ((size + 7) & ~7)
        return objects
