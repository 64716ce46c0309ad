"""HDF5 1.14.6's conversions between numeric types, as h5py gets them:
where it reads a float of a layout numpy lacks (any sign, exponent and
mantissa position and size, bias, normalisation, padding) into the IEEE
dtype it picks, and where a virtual dataset reads a source of
another type. Numpy and the standard library only.

- `Float`: a floating-point type's fields, as the datatype message holds
  them (`hdf5_types.parse`), and `ieee(dtype)` for numpy's;
- `floats(raw, src, dst)`: HDF5's soft conversion between two float
  layouts (its `H5T__conv_f_f`), element by element: the cut-off bits
  round half away from zero, except where that would carry into infinity
  or the value is (or becomes) denormal; an exponent past the
  destination's range gives infinity, one below it zero; NaNs keep their
  sign with every mantissa bit set;
- `numeric(a, dst)`: an array of a numpy numeric dtype (a source's type as
  stored) as `dst`, as HDF5 converts it: between native little-endian
  floats a C cast, a value past the destination's range becoming infinity
  (its hard conversions); between any other float types `floats`;
  integers saturate; floats to integers truncate and saturate, NaN
  becoming 0; integers to floats round to nearest. Mixed float and
  integer conversions of other than native types raise ValueError.

A float whose mantissa normalisation is "most significant bit set" raises
ValueError where its exponent is not zero, as HDF5 does.
"""

from typing import NamedTuple

import numpy as np

from iltpu_torch.data.hdf5_checksum import refuse

LE, BE = 0, 1
NORM_NONE, NORM_IMPLIED = 0, 2  # mantissa normalisations (1: most significant bit set)


class Float(NamedTuple):
    size: int  # bytes
    order: int  # LE or BE
    offset: int  # the first significant bit
    precision: int  # significant bits
    sign: int  # the sign bit's position
    epos: int
    esize: int
    mpos: int
    msize: int
    bias: int
    norm: int
    lsb_pad: int  # padding below `offset` and above `offset + precision`: 0 or 1
    msb_pad: int


def ieee(dtype) -> Float:
    """The Float of a numpy IEEE float dtype (x86's 80-bit long double for
    `f16`, as HDF5 describes it: no implied mantissa bit)."""
    dtype = np.dtype(dtype)
    order = BE if dtype.byteorder == ">" or (dtype.byteorder == "=" and not np.little_endian) else LE
    fields = {2: (16, 15, 10, 5, 10, 15, NORM_IMPLIED), 4: (32, 31, 23, 8, 23, 127, NORM_IMPLIED),
              8: (64, 63, 52, 11, 52, 1023, NORM_IMPLIED), 16: (80, 79, 64, 15, 64, 16383, NORM_NONE)}
    prec, sign, epos, esize, msize, bias, norm = fields[dtype.itemsize]
    return Float(dtype.itemsize, order, 0, prec, sign, epos, esize, 0, msize, bias, norm, 0, 0)


def _get(v: int, off: int, n: int) -> int:
    return (v >> off) & ((1 << n) - 1)


def _set(v: int, off: int, n: int, value: bool) -> int:
    mask = ((1 << n) - 1) << off
    return v | mask if value else v & ~mask


def _set_d(v: int, off: int, n: int, value: int) -> int:
    mask = ((1 << n) - 1) << off
    return (v & ~mask) | ((value << off) & mask)


def _find(v: int, off: int, n: int, msb: bool, value: bool) -> int:
    """The position, from `off`, of the first bit equal to `value` in the
    `n` bits at `off`, searched from the most or least significant end; -1
    where there is none (HDF5's `H5T__bit_find`)."""
    field = _get(v, off, n)
    if not value:
        field ^= (1 << n) - 1
    if not field:
        return -1
    return field.bit_length() - 1 if msb else (field & -field).bit_length() - 1




def floats(raw: np.ndarray, src: Float, dst: Float) -> np.ndarray:
    """Elements of layout `src` (an array of `V<size>`) as bytes of layout
    `dst` (an array of `V<size>` of the same shape), each as HDF5's
    `H5T__conv_f_f` converts it."""
    out = bytearray()
    msize = 0  # HDF5 keeps it from one element to the next
    for b in _elements(raw, src.size):
        d, msize = _one(int.from_bytes(b, "little" if src.order == LE else "big"), src, dst, msize)
        out += d.to_bytes(dst.size, "little" if dst.order == LE else "big")
    return np.frombuffer(bytes(out), f"V{dst.size}").reshape(raw.shape)


def _elements(raw: np.ndarray, size: int):
    data = raw.reshape(-1).tobytes()
    return (data[i:i + size] for i in range(0, len(data), size))


def _one(s: int, S: Float, D: Float, msize: int):
    """One element, `s` the little-endian integer of its bytes, from layout
    S to layout D; and the mantissa width HDF5 carries to the next one."""
    expo_max = (1 << D.esize) - 1
    d = _set_d(0, D.sign, 1, _get(s, S.sign, 1))
    mant_zero = _find(s, S.mpos, S.msize, False, True) < 0
    exp_ones = _find(s, S.epos, S.esize, False, False) < 0
    if mant_zero and _find(s, S.epos, S.esize, False, True) < 0:  # +0 or -0
        return _pad(d, D), msize
    if (mant_zero and exp_ones) or (S.norm == NORM_NONE and exp_ones and
                                    _find(s, S.mpos, S.msize - 1, False, True) < 0):  # +-inf
        d = _set(d, D.epos, D.esize, True)
        if D.norm == NORM_NONE:
            d = _set(d, D.mpos + D.msize - 1, 1, True)
        return _pad(d, D), msize
    if exp_ones and not mant_zero:  # NaN: every mantissa bit set
        d = _set(_set(d, D.epos, D.esize, True), D.mpos, D.msize, True)
        return _pad(d, D), msize
    expo = _get(s, S.epos, S.esize)
    denormalized = expo == 0
    implied, mpos, mrsh, bitno = 1, S.mpos, 0, 0
    if expo == 0 or S.norm == NORM_NONE:
        bitno = _find(s, S.mpos, S.msize, True, True)
        if bitno > 0:
            msize = bitno
        elif bitno == 0:
            msize = 1
            s = _set(s, S.mpos, 1, False)
        expo -= (S.bias - 1) + (S.msize - bitno)
    elif S.norm == NORM_IMPLIED:
        msize = S.msize
        expo -= S.bias
    else:  # as HDF5, which converts such a type's zeros and denormals only
        raise refuse("float of normalisation 'most significant bit set' with an exponent")
    if D.norm == NORM_NONE:
        mrsh += 1
    expo += D.bias
    if expo < -D.msize:  # too small: zero
        expo, msize = 0, 0
    elif expo <= 0:  # denormal in the destination
        mrsh += 1 - expo
        expo, denormalized = 0, True
    elif expo >= expo_max:  # too large: infinity
        expo, msize = expo_max, 0
    carry = False
    if msize > 0 and mrsh <= D.msize and mrsh + msize > D.msize:
        bitno = mrsh + msize - D.msize
        if _get(s, mpos + bitno - 1, 1):
            if denormalized:
                s = _set_d(s, mpos + bitno - 1, 1 + msize - bitno, _get(s, mpos + bitno - 1, 1 + msize - bitno) + 1)
            elif (_find(s, mpos + bitno, msize - bitno, False, False) >= 0 or expo < expo_max - 1):
                field = _get(s, mpos + bitno - 1, 1 + msize - bitno) + 1
                carry = bool(field >> (1 + msize - bitno))
                s = _set_d(s, mpos + bitno - 1, 1 + msize - bitno, field)
                if carry:
                    implied = 2
    if mrsh > D.msize + 1:
        pass  # the mantissa stays zero
    elif mrsh == D.msize + 1:
        d = _set(d, D.mpos, 1, True)
    elif mrsh == D.msize:
        d = _set_d(d, D.mpos, min(2, D.msize), implied)
    else:
        if mrsh > 0:
            d = _set_d(d, D.mpos + D.msize - mrsh, 2, implied)
        if mrsh + msize >= D.msize:
            d = _set_d(d, D.mpos, D.msize - mrsh, _get(s, mpos + msize + mrsh - D.msize, D.msize - mrsh))
        else:
            d = _set_d(d, D.mpos + D.msize - (mrsh + msize), msize, _get(s, mpos, msize))
    if carry:
        expo += 1
        if expo >= expo_max:
            expo = expo_max
            d = _set(d, D.mpos, D.msize, False)
    return _pad(_set_d(d, D.epos, D.esize, expo), D), msize


def _pad(d: int, D: Float) -> int:
    if D.offset > 0:
        d = _set(d, 0, D.offset, bool(D.lsb_pad))
    top = D.offset + D.precision
    if top != 8 * D.size:
        d = _set(d, top, 8 * D.size - top, bool(D.msb_pad))
    return d


def _native(dtype: np.dtype) -> bool:
    return dtype.isnative and (dtype.kind in "iu" or dtype.kind == "f" and dtype.itemsize in (4, 8))


def numeric(a: np.ndarray, dst) -> np.ndarray:
    """`a` (a numpy integer or float array, as stored) as `dst`, as HDF5
    converts it."""
    src, dst = a.dtype, np.dtype(dst)
    if src == dst:
        return a
    if src.kind not in "iuf" or dst.kind not in "iuf":
        raise refuse(f"conversion of a virtual dataset's source from {src} to {dst}")
    if src.kind == dst.kind == "f":
        if src.itemsize == dst.itemsize or _native(src) and _native(dst):
            with np.errstate(over="ignore"):
                out = a.astype(dst)
            if dst.itemsize < src.itemsize:  # past the range: infinity, not the largest float
                top = np.finfo(dst).max
                out[a > top] = np.inf
                out[a < -top] = -np.inf
            return out
        raw = floats(np.ascontiguousarray(a).view(f"V{src.itemsize}"), ieee(src), ieee(dst))
        return raw.view(dst)
    if src.kind in "iu" and dst.kind in "iu":
        lo, hi = max(np.iinfo(src).min, np.iinfo(dst).min), min(np.iinfo(src).max, np.iinfo(dst).max)
        return np.clip(a, np.array(lo, src), np.array(hi, src)).astype(dst)
    if not (_native(src) and _native(dst)):
        raise refuse(f"conversion of a virtual dataset's source from {src} to {dst}")
    if dst.kind == "f":
        return a.astype(dst)
    info = np.iinfo(dst)
    wide = a.astype(np.float64) if src.itemsize < 8 else a
    out = np.zeros(a.shape, dst)
    ok = np.isfinite(wide) & (wide > info.min - 1.0) & (wide < info.max + 1.0)
    out[ok] = a[ok].astype(dst)
    out[~np.isnan(wide) & (wide >= info.max + 1.0)] = info.max
    out[~np.isnan(wide) & (wide <= info.min - 1.0)] = info.min
    return out
