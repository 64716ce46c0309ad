"""The HDF5 fixtures' paths, decoded from their committed text forms, and
the seeded arrays `formats_latest.hdf5` holds.

    from fixture import unpack, formats_arrays, same   # data/d4rl on sys.path
    path = unpack()                                 # hopper_expert.hdf5
    path = unpack("hopper_expert_latest.hdf5")
    want = formats_arrays()                         # {name: array as h5py reads it}

`<name>.b64` (base64 of the file `make_fixture.py` writes) is what the
repo holds: a checkout made from a text diff drops binary files.
`unpack(name)` writes `<name>` beside it (gitignored) by an atomic rename
where it is missing or differs, and raises unless the bytes have the
sha256 below. `formats_arrays(seed)` rebuilds, with numpy alone, every
root dataset of `formats_latest.hdf5` as `np.asarray(f[name])` gives it (a
dataset of an array datatype with the array's dimensions last), in the
root's order; `same(got, want)` holds two such dicts equal: keys in order,
dtype, shape and bytes (an object array element by element). Standard
library and numpy only.
"""

import base64
import hashlib
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SHA256 = {
    "hopper_expert.hdf5": "3fb83e93f06dd632ef560f42bbc26649833f3e290f3ccea77d41528aaf5e30ae",
    "hopper_expert_latest.hdf5": "eab8ff7d4b62ea89ca9b579c569f8af70305e0b330fa85e563a022ca836489d7",
    "formats_latest.hdf5": "7c0389611bbaca191b9717ace25705a6ee8a70949c9f574d81d8ba618d5bb5e5",
}


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def unpack(name: str = "hopper_expert.hdf5") -> str:
    """The decoded fixture's path."""
    path, want = os.path.join(HERE, name), SHA256[name]
    if os.path.exists(path) and _sha256(path) == want:
        return path
    with open(path + ".b64", "rb") as f:
        raw = base64.decodebytes(f.read())
    got = hashlib.sha256(raw).hexdigest()
    if got != want:
        raise RuntimeError(f"{path}.b64 decodes to sha256 {got}, not {want}")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)
    return path


# formats_latest.hdf5's dense group: link names in an order that is not the name order
DENSE = [f"link_{(i * 37) % 200:03d}_{'abcdefghij' * (i % 4)}" for i in range(200)]
COMPOUND = np.dtype([("id", "<i4"), ("pos", "<f8", (3,)), ("ok", "?"), ("tag", "S4")])
ALIGNED = np.dtype({"names": ["a", "b", "c"], "formats": ["u1", ">f8", "S3"],
                    "offsets": [0, 8, 16], "itemsize": 24})
NAMED = np.dtype([("x", "<i2"), ("y", "<f4")])
SOFT = (0, 1, 150)
WORDS = [b"", b"SAC", b"expert", "höpper".encode(), b"x" * 40, b"with space "]


def formats_arrays(seed: int = 0) -> dict:
    """Every root dataset of formats_latest.hdf5, as h5py reads it, in the
    root's (creation) order."""
    rng = np.random.default_rng(seed)

    def normal(*shape, dtype="<f4"):
        return rng.standard_normal(shape).astype(dtype)

    out = {}
    # the chunk indexes (make_fixture.py names each one's index)
    fixed = np.full(4200, -3, "<i2")  # 2,100 chunks of 2: a paged fixed array, page 1 unwritten
    fixed[:500] = rng.integers(-1000, 1000, 500)
    fixed[4000:] = rng.integers(-1000, 1000, 200)
    out["fixed_array_paged"] = fixed
    out["fixed_array_gzip"] = normal(300, 7)
    out["extensible_array"] = rng.integers(-2**31, 2**31, 3000).astype("<i4")
    out["extensible_array_lzf"] = np.repeat(normal(40, 6, dtype="<f8"), 5, axis=1)
    out["btree2"] = rng.integers(0, 2**16, (60, 50)).astype("<u2")
    out["btree2_gzip_fletcher32"] = rng.integers(-128, 128, (50, 40)).astype("i1")
    out["single_chunk"] = normal(20, 11)
    out["single_chunk_gzip"] = normal(20, 11, dtype=">f8")
    out["implicit"] = normal(12, 9, dtype="<f8")
    out["contiguous"] = normal(30, 3)
    out["compact"] = rng.integers(0, 255, (4, 5)).astype("u1")
    # the datatypes
    out["strings"] = np.array([w[:8] for w in WORDS], "S8")
    out["strings_utf8"] = np.array(WORDS, "S12")
    vlen = np.empty(len(WORDS), object)
    vlen[:] = WORDS
    out["vlen_strings"] = vlen
    seqs = np.empty(5, object)
    seqs[:] = [rng.integers(-50, 50, n).astype("<i4") for n in (3, 0, 7, 1, 12)]
    out["vlen_ints"] = seqs
    compound = np.zeros(6, COMPOUND)
    compound["id"] = np.arange(6)
    compound["pos"] = normal(6, 3, dtype="<f8")
    compound["ok"] = rng.random(6) < 0.5
    compound["tag"] = [b"a", b"bb", b"ccc", b"dddd", b"", b"e"]
    out["compound"] = compound
    aligned = np.zeros(3, ALIGNED)
    aligned["a"], aligned["b"], aligned["c"] = [1, 2, 3], normal(3, dtype=">f8"), [b"x", b"yy", b"z"]
    out["compound_aligned"] = aligned
    packed = np.zeros(4, [("n", "<i8"), ("name", "O")])
    packed["n"] = [10, 20, 30, 40]
    packed["name"] = [b"alpha", b"", b"gamma", "délta".encode()]
    out["compound_vlen"] = packed
    out["array"] = normal(5, 2, 3)  # a (2, 3) float32 array type: its dimensions last
    out["enum"] = rng.integers(0, 3, 50).astype("<i2")
    out["committed"] = np.zeros(4, NAMED)
    out["committed"]["x"], out["committed"]["y"] = [1, -2, 3, -4], normal(4)
    out["bitfield"] = rng.integers(0, 2**16, 9).astype("<u2")
    out["flags"] = rng.random(100) < 0.3
    out["scalar_string"] = np.array(b"SAC", object)
    out["scalar"] = np.array(3.25)
    # the filters
    out["lzf"] = np.repeat(normal(500, 2), 3, axis=1)
    out["lzf_random"] = rng.integers(0, 2**32, (64, 16), dtype=np.uint64).astype("<u4")
    out["shuffle_gzip_fletcher32"] = normal(400, 11)
    out["scaleoffset_int"] = rng.integers(-5000, 5000, 1000).astype(">i4")
    # quarters: scale-offset's decimal scale (3) gives them back exactly
    out["scaleoffset_float"] = rng.integers(-40000, 40000, 1000) / 4.0
    out["nbit"] = rng.integers(-2**20, 2**20, 300).astype("<i4")
    out["szip"] = (np.cumsum(rng.integers(-3, 4, 2000)) + 500).astype("<i2")
    # soft links into the dense group (it does not track creation order)
    for i in SOFT:
        out[f"soft_{i}"] = np.arange(i, i + 4, dtype="<i8")
    # 40 links at least in the root, tracked in creation order
    for i in range(8):
        out[f"z_small_{7 - i}"] = rng.integers(0, 100, i + 1).astype(">u8")
    return out


def same(got: dict, want: dict) -> None:
    """Raise AssertionError unless `got` equals `want`: the same keys in the
    same order, and each array's dtype, shape and bytes (an object array's
    elements each equal in type, dtype and bytes)."""
    if list(got) != list(want):
        raise AssertionError(f"keys {list(got)} != {list(want)}")
    for k, w in want.items():
        g = got[k]
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{k}: {g.dtype} {g.shape} != {w.dtype} {w.shape}")
        if _objects(w.dtype):
            if not _same_objects(g, w):
                raise AssertionError(f"{k}: {g!r} != {w!r}")
        elif g.tobytes() != w.tobytes():
            raise AssertionError(f"{k}: {g!r} != {w!r}")


def _objects(dtype) -> bool:
    return dtype == object or bool(dtype.names) and any(_objects(dtype[n]) for n in dtype.names)


def _same_objects(g, w) -> bool:
    if g.dtype.names:
        return all(_same_objects(g[n], w[n]) for n in g.dtype.names)
    if g.dtype != object:
        return g.tobytes() == w.tobytes()
    for a, b in zip(g.reshape(-1).tolist(), w.reshape(-1).tolist()):
        if type(a) is not type(b):
            return False
        if isinstance(b, np.ndarray):
            if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
                return False
        elif a != b:
            return False
    return True
