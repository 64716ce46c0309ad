"""HDF5's filters, in one place: the filter pipeline message and the
reverse of each filter the reader knows, numpy and the standard library
only.

- deflate (1, zlib), shuffle (2), fletcher32 (3);
- lzf (32000, h5py's own filter: LZF's literal runs and back references);
- nbit (5), scale-offset (6) on integers and on floats (its decimal
  scale);
- szip (4: CCSDS 121.0's adaptive Rice coder, as libaec's szip interface
  writes it), sample by sample in Python loops.

A filter id outside these raises ValueError naming the id (h5py raises
too: "required filter not available").
"""

import bisect
import math
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from iltpu_torch.data.hdf5_checksum import refuse

DEFLATE, SHUFFLE, FLETCHER32, SZIP, NBIT, SCALEOFFSET, LZF = 1, 2, 3, 4, 5, 6, 32000
Filter = Tuple[int, Tuple[int, ...]]


def pipeline(h5, p: int) -> List[Filter]:
    """The (id, client data) of a filter pipeline message, version 1 or 2,
    in the order the writer applied them."""
    version, n = h5.mm[p], h5.mm[p + 1]
    if version not in (1, 2):
        raise refuse(f"filter pipeline version {version}")
    q, out = p + (8 if version == 1 else 2), []
    for _ in range(n):
        fid = h5.uint(q, 2)
        if version == 1 or fid >= 256:  # version 2 names only the ids past the library's
            name_len, q = h5.uint(q + 2, 2), q + 4
        else:
            name_len, q = 0, q + 2
        ncd = h5.uint(q + 2, 2)
        q += 4 + name_len
        client = tuple(h5.uint(q + 4 * i, 4) for i in range(ncd))
        q += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
        if fid not in (DEFLATE, SHUFFLE, FLETCHER32, SZIP, LZF, NBIT, SCALEOFFSET):
            raise refuse(f"filter id {fid}")
        out.append((fid, client))
    return out


def fletcher32(data: bytes) -> Tuple[int, int]:
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


def check_fletcher32(raw: bytes) -> bytes:
    data, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
    s1, s2 = fletcher32(data)
    # the library also accepts the byte-swapped halves an old version wrote
    swapped = ((stored & 0x00FF00FF) << 8) | ((stored >> 8) & 0x00FF00FF)
    for v in (stored, swapped):
        if (v & 0xFFFF) % 65535 == s1 and (v >> 16) % 65535 == s2:
            return data
    raise ValueError("HDF5 chunk fails its fletcher32 checksum")


def unshuffle(raw: bytes, size: int) -> bytes:
    n = len(raw) // size
    if size == 1 or n == 0:
        return raw
    planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
    return planes.T.tobytes() + raw[n * size:]


def lzf(src: bytes, size: int) -> bytes:
    """LZF's decompression: a control byte below 32 starts a literal run of
    ctrl + 1 bytes; above, its top 3 bits (7: plus the next byte) + 2 is the
    length of a copy from (its low 5 bits, the next byte) + 1 bytes back."""
    out, i, n = bytearray(), 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            out += src[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += src[i]
            i += 1
        back = ((ctrl & 0x1F) << 8) + src[i] + 1
        i += 1
        length += 2
        ref = len(out) - back
        if ref < 0:
            raise ValueError("HDF5 lzf chunk refers before its start")
        if back >= length:
            out += out[ref:ref + length]
        else:  # the copy overlaps what it writes: the last `back` bytes repeat
            out += (out[ref:] * (length // back + 1))[:length]
    if size and len(out) != size:
        raise ValueError(f"HDF5 lzf chunk decompresses to {len(out)} bytes, not {size}")
    return bytes(out)


def _values(bits: np.ndarray) -> np.ndarray:
    """Each row of bits (most significant first) as an unsigned integer."""
    weights = np.uint64(1) << np.arange(bits.shape[1] - 1, -1, -1, dtype=np.uint64)
    return (bits.astype(np.uint64) * weights).sum(axis=1, dtype=np.uint64)


def _bits(raw: bytes, width: int, count: int, start: int = 0) -> np.ndarray:
    """`count` unsigned values of `width` bits each packed most significant
    bit first from byte `start` of `raw` (scale-offset's packing)."""
    need = (width * count + 7) // 8
    bits = np.unpackbits(np.frombuffer(raw, np.uint8, need, start))[:width * count]
    return _values(bits.reshape(count, width))


def _nbit_fields(client: Sequence[int], i: int, at: int):
    """The nbit parameters of the type at client[i], flattened: a list of
    (byte offset in the element, size, byte order, precision, bit offset)
    for each atomic value (None for the byte order of bytes stored whole),
    and the index past them. Class 1 atomic (size, order, precision,
    offset), 2 array (size, then its base type), 3 compound (size, member
    count, then each member's offset and type), 4 stored whole (size)."""
    cls, size = client[i], client[i + 1]
    if cls == 1:
        order, precision, offset = client[i + 2:i + 5]
        return [(at, size, order, precision, offset)], i + 5
    if cls == 4:
        return [(at, size, None, 8 * size, 0)], i + 2
    if cls == 2:
        base, end = _nbit_fields(client, i + 2, 0)
        step = client[i + 3]  # the base type's size
        return [(at + k * step + f[0], *f[1:]) for k in range(size // step) for f in base], end
    if cls == 3:
        fields, j = [], i + 3
        for _ in range(client[i + 2]):
            member, j = _nbit_fields(client, j + 1, at + client[j])
            fields += member
        return fields, j
    raise ValueError(f"HDF5 nbit parameters: type class {cls}")


def nbit(raw: bytes, client: Sequence[int], nbytes: int) -> bytes:
    """The nbit filter's reverse. Client data: the parameter count, a
    "stored as is" flag, the element count, then the type (`_nbit_fields`).
    Each element's values follow one another, most significant bit first,
    each its `precision` bits (a value stored whole: all its bytes); they
    go back to their bit offset in their bytes, the other bits zero."""
    if client[1]:
        return raw
    count = client[2]
    fields, _ = _nbit_fields(client, 3, 0)
    width = sum(f[3] for f in fields)
    size = nbytes // count
    bits = np.unpackbits(np.frombuffer(raw, np.uint8, (width * count + 7) // 8))
    bits = bits[:width * count].reshape(count, width)
    out = np.zeros((count, size), np.uint8)
    pos = 0
    for at, n, order, precision, offset in fields:
        part = bits[:, pos:pos + precision]
        pos += precision
        if order is None:
            out[:, at:at + n] = np.packbits(part, axis=1)
            continue
        values = _values(part) << np.uint64(offset)
        out[:, at:at + n] = values.astype(f"{'>' if order else '<'}u{n}").view(np.uint8).reshape(count, n)
    return out.tobytes()


def scaleoffset(raw: bytes, client: Sequence[int], nbytes: int) -> bytes:
    """The scale-offset filter's reverse. Client data: scale type (0 a
    float's decimal scale, 2 an integer's bits), scale factor, element
    count, class (0 integer, 1 float), size, sign, byte order, fill value
    defined, the fill value. The chunk: minbits (4 bytes, little-endian),
    the size of the minimum (1 byte), the minimum (little-endian), then
    minbits bits a value, most significant first, from byte 21. A value is
    the minimum plus its bits (a float: plus its bits, a signed integer,
    over 10^scale factor, rounded to the float's type first); all ones is
    the fill value where one is defined."""
    scale_type, factor, count, cls, size, signed, order, fill_defined = client[:8]
    if (cls, scale_type) not in ((0, 2), (1, 0)):
        raise refuse(f"scale-offset filter of scale type {scale_type} on class {cls}")
    minbits = int.from_bytes(raw[:4], "little")
    dtype = np.dtype(f"{'>' if order else '<'}{'f' if cls else 'iu'[not signed]}{size}")
    if minbits == 8 * size:  # stored as is after the header
        return bytes(raw[21:21 + nbytes])
    values = _bits(raw, minbits, count, 21)
    if cls:  # the float's minimum, and its bits as a signed integer of its size
        minimum = np.frombuffer(raw[5:5 + size], dtype.newbyteorder("<"))[0]
        scaled = values.astype(f"=u{size}").view(f"=i{size}") / np.float64(10.0) ** factor
        out = scaled.astype(dtype.newbyteorder("=")) + minimum.astype(dtype.newbyteorder("="))
    else:
        mask = (1 << 8 * size) - 1
        minimum = int.from_bytes(raw[5:5 + raw[4]], "little") & mask
        out = ((values + np.uint64(minimum)) & np.uint64(mask)).astype(f"=u{size}")
        out = out.view(dtype.newbyteorder("="))
    if fill_defined and minbits:
        fill = np.array(client[8:8 + (size + 3) // 4], "<u4").tobytes()[:size]
        out[values == np.uint64((1 << minbits) - 1)] = np.frombuffer(fill, dtype.newbyteorder("<"))[0]
    return out.astype(dtype).tobytes()


class _Bits:
    """A most-significant-bit-first reader of a byte string."""

    def __init__(self, data: bytes):
        self.data, self.pos = bytes(data) + bytes(16), 0
        # where each fundamental sequence code can end: the stream's one bits
        self.ones = np.flatnonzero(np.unpackbits(np.frombuffer(data, np.uint8))).tolist()

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        start, end = self.pos >> 3, (self.pos + n + 7) >> 3
        word = int.from_bytes(self.data[start:end], "big")
        self.pos += n
        return (word >> (8 * end - self.pos)) & ((1 << n) - 1)

    def fs(self) -> int:
        """A fundamental sequence code: the zeros before the next one bit."""
        i = bisect.bisect_left(self.ones, self.pos)
        if i == len(self.ones):
            raise ValueError("HDF5 szip chunk ends inside a code")
        m, self.pos = self.ones[i] - self.pos, self.ones[i] + 1
        return m


def _rice(bits: _Bits, n: int, block: int, rsi: int, count: int, preprocess: bool) -> np.ndarray:
    """`count` samples of `n` bits under CCSDS 121.0's adaptive Rice coder,
    in blocks of `block` samples and reference sample intervals of `rsi`
    blocks. Each block opens with an option ID of 3, 4 or 5 bits: 0 then a
    0 bit, a run of zero blocks (its length a fundamental sequence code; 4
    means to the end of the 64-block segment or of the interval); 0 then a
    1 bit, the second extension (pairs, each a code of (a+b)(a+b+1)/2 + b);
    all ones, the samples as they are; else k + 1, each sample's code of
    its value >> k, then its k low bits. With the preprocessor, each
    interval's first block carries the reference sample (n bits) after its
    ID (and the low-entropy bit), and the other samples are mapped
    prediction errors."""
    id_len = 5 if n > 16 else 4 if n > 8 else 3
    out = np.zeros(count + 65 * block, np.int64)  # a run of zero blocks may pass the end
    done = 0
    while done < count:  # a reference sample interval
        start, b = done, 0
        while b < rsi and done < count:
            option = bits.read(id_len)
            low = bits.read(1) if option == 0 else None  # after the ID: which low-entropy option
            i = done
            if preprocess and b == 0:
                out[i] = bits.read(n)
                i += 1
            blocks = 1
            if low:  # the second extension
                while i < done + block:
                    m = bits.fs()
                    diag = (math.isqrt(8 * m + 1) - 1) // 2
                    second = m - diag * (diag + 1) // 2
                    if (i - done) % 2 == 0:
                        out[i] = diag - second
                        i += 1
                    out[i] = second
                    i += 1
            elif low == 0:  # zero blocks: `out` holds zeros already
                blocks = bits.fs() + 1
                if blocks == 5:
                    blocks = min(rsi - b, 64 - b % 64)
                elif blocks > 5:
                    blocks -= 1
            elif option == (1 << id_len) - 1:
                for j in range(i, done + block):
                    out[j] = bits.read(n)
            else:
                k = option - 1
                for j in range(i, done + block):
                    out[j] = bits.fs() << k
                for j in range(i, done + block):
                    out[j] |= bits.read(k)
            done += blocks * block
            b += blocks
        if preprocess:
            _unpredict(out, start, min(done, count), n)
    return out[:count]


def _unpredict(x: np.ndarray, start: int, end: int, n: int) -> None:
    """The preprocessor's reverse over x[start:end] in place: x[start] is
    the reference sample; each next is the previous sample plus the error
    its mapped value d encodes (d <= 2 theta: +d/2 for d even, -(d+1)/2
    odd; past it, the value is d from the nearer bound), theta the previous
    sample's distance to the nearer of 0 and 2^n - 1."""
    top = (1 << n) - 1
    prev = int(x[start])
    values = x[start + 1:end].tolist()
    for i, d in enumerate(values):
        theta = min(prev, top - prev)
        if d <= 2 * theta:
            prev += -((d + 1) >> 1) if d & 1 else d >> 1
        else:
            prev = d if prev <= top - prev else top - d
        values[i] = prev
    x[start + 1:end] = values


def szip(raw: bytes, client: Sequence[int], nbytes: int) -> bytes:
    """HDF5's szip filter reversed: the chunk's size (4 bytes, little-endian),
    then a CCSDS 121.0 stream. Client data: the options (16 most significant
    byte first, 32 the preprocessor), pixels a block, bits a pixel, pixels a
    scanline (the reference sample interval, in blocks rounded up; a short
    scanline's last block padded). Pixels of 32 and 64 bits are coded as
    bytes, each byte of a pixel in its own plane."""
    options, block, bits_per_pixel, scanline = client[:4]
    if int.from_bytes(raw[:4], "little") != nbytes:
        raise ValueError(f"HDF5 szip chunk of {int.from_bytes(raw[:4], 'little')} bytes, not {nbytes}")
    planes = bits_per_pixel in (32, 64)
    n = 8 if planes else bits_per_pixel
    size = 1 if n <= 8 else 2 if n <= 16 else 4
    count = nbytes // size
    rsi = -(-scanline // block)
    padded = count
    if scanline % block:
        padded = -(-count // scanline) * rsi * block
    samples = _rice(_Bits(raw[4:]), n, block, rsi, padded, bool(options & 32))
    if scanline % block:
        samples = samples.reshape(-1, rsi * block)[:, :scanline].reshape(-1)[:count]
    out = samples.astype(f"{'>' if options & 16 else '<'}u{size}").tobytes()
    return unshuffle(out, bits_per_pixel // 8) if planes else out


def decode(raw: bytes, filters: Sequence[Filter], mask: int, itemsize: int, nbytes: int) -> bytes:
    """A chunk's bytes through the pipeline's reverse: the last filter
    first, each one the mask names skipped; `nbytes` is the chunk's size
    unfiltered."""
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, client = filters[i]
        if fid == DEFLATE:
            raw = zlib.decompress(raw)
        elif fid == SHUFFLE:
            raw = unshuffle(raw, client[0] if client else itemsize)
        elif fid == FLETCHER32:
            raw = check_fletcher32(raw)
        elif fid == LZF:
            raw = lzf(raw, client[2] if len(client) > 2 else 0)
        elif fid == NBIT:
            raw = nbit(raw, client, nbytes)
        elif fid == SZIP:
            raw = szip(raw, client, nbytes)
        else:
            raw = scaleoffset(raw, client, nbytes)
    return raw
