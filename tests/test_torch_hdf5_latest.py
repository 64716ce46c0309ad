"""The port's HDF5 reader on the rest of the format, against h5py and
iltpu's h5py loader on files h5py writes here: groups stored as links
(compact and dense, in name and in creation order), every chunk index of
layout v4 (single chunk, implicit, fixed array, extensible array, v2
B-tree; paged fixed and extensible arrays), the datatypes beyond numbers
(strings, compound, array, enum, bitfield, opaque, variable-length,
committed), shared-message tables, the filters lzf, nbit, scale-offset
and szip, lookup3 and corrupted v2 checksums, unknown filter ids, what
stays refused, and the committed fixtures `hopper_expert_latest.hdf5` and
`formats_latest.hdf5`. Options h5py does not wrap (relaxed integrity
checks, shared-message tables) are set through ctypes in the libhdf5 h5py
loaded."""

import ctypes
import glob
import importlib.util
import mmap
import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from iltpu.data.dataset import load_d4rl_hdf5 as jax_load  # noqa: E402
from iltpu_torch.data import hdf5_filters  # noqa: E402
from iltpu_torch.data.dataset import load_d4rl_hdf5  # noqa: E402
from iltpu_torch.data.hdf5 import FILTERS, LAYOUT, _File, read_datasets  # noqa: E402
from iltpu_torch.data.hdf5_checksum import lookup3  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROADMAP = "ROADMAP.md, 'HDF5 newer formats'"
LIBVERS = [None, "latest", ("v108", "latest"), ("v110", "v110"), ("v108", "v108")]


def libver_id(v):
    return "default" if v is None else "-".join(v) if isinstance(v, tuple) else v


def fixture_module():
    spec = importlib.util.spec_from_file_location(
        "d4rl_fixture", os.path.join(REPO, "data", "d4rl", "fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def d4rl_arrays(rows=300, S=11, A=3, seed=0):
    rng = np.random.default_rng(seed)
    ends = np.zeros(rows, bool)
    ends[16::17] = True
    ends[-1] = True
    idx = np.flatnonzero(ends)
    terminals, timeouts = np.zeros(rows, bool), np.zeros(rows, bool)
    terminals[idx[::2]], timeouts[idx[1::2]] = True, True
    return {
        "observations": rng.standard_normal((rows, S)).astype(np.float32),
        "actions": rng.uniform(-1, 1, (rows, A)).astype(np.float32),
        "next_observations": rng.standard_normal((rows, S)).astype(np.float32),
        "rewards": rng.standard_normal(rows).astype(np.float32),
        "terminals": terminals,
        "timeouts": timeouts,
    }


def open_file(path, libver=None, **kw):
    return h5py.File(path, "w", **({} if libver is None else {"libver": libver}), **kw)


def h5py_reads(path, names=None, fapl=None):
    """{name: what h5py reads} for the root's datasets (those among `names`),
    in its order (a dataset of an array datatype through `[()]`:
    `np.asarray` refuses it)."""
    with h5py.File(path if fapl is None else h5py.h5f.open(path.encode(), fapl=fapl)) as f:
        names = [k for k in f if (isinstance(f[k], h5py.Dataset) if names is None else k in names)]
        out = {}
        for k in names:
            v = f[k][()] if f[k].dtype.subdtype else np.asarray(f[k])
            out[k] = v
        return out


def assert_h5py_equal(path, names=None):
    ref = h5py_reads(path, names)
    fixture_module().same(read_datasets(path, list(ref)), ref)


def assert_iltpu_equal(path):
    port, ref = load_d4rl_hdf5(path), jax_load(path)
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
        assert port[k].tobytes() == ref[k].tobytes(), k


def messages(path, name):
    """{message type: its data offset} of the root's dataset `name`, and the
    file's bytes."""
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        h5 = _File(mm)
        addr = h5.resolve(h5.root, h5.group(h5.root)[name])
        return {kind: p for kind, p, _ in h5.messages(addr)}, h5.at(addr), raw


def chunk_index(path, name):
    """A chunked dataset's layout version and (version 4) chunk index type."""
    found, _, raw = messages(path, name)
    p = found[LAYOUT]
    assert raw[p + 1] == 2, "not chunked"
    return raw[p], (raw[p + 5 + raw[p + 3] * raw[p + 4]] if raw[p] == 4 else None)


def group_order(path, group):
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        h5 = _File(mm)
        here = h5.root
        for part in filter(None, group.split("/")):
            here = h5.resolve(here, h5.group(here)[part])
        return list(h5.group(here))


# ----------------------------------------------------------------- groups


@pytest.mark.parametrize("track_order", [False, True], ids=["name_order", "creation_order"])
@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
def test_groups_in_h5py_order(tmp_path, libver, track_order):
    """A root of 48 links (dense under the newer formats: a fractal heap and
    a v2 B-tree name index), a compact group and a dense group of 300 links
    (indirect heap blocks, an internal B-tree node) tracking the other
    order, one link's name long enough to be a huge heap object: each lists
    its links as h5py's `keys()` does, and the D4RL datasets (made out of
    name order) load as through iltpu."""
    path = str(tmp_path / "groups.hdf5")
    with open_file(path, libver, track_order=track_order) as f:
        for k, v in reversed(list(d4rl_arrays().items())):
            f.create_dataset(k, data=v, compression="gzip")
        for i in range(40):
            f.create_dataset(f"info{(i * 7) % 40}", data=np.arange(i % 3 + 1))
        g = f.create_group("compact", track_order=track_order)
        for i in range(5):
            g.create_dataset(f"c{5 - i}", data=i)
        g = f.create_group("dense", track_order=not track_order)
        for i in range(300):
            g[f"name_{(i * 37) % 300:04d}_" + "x" * (i % 50)] = h5py.SoftLink("/compact/c1")
        g["long_" + "n" * 5000] = h5py.SoftLink("/compact/c2")  # a huge heap object
        f["soft"] = h5py.SoftLink("/dense/name_0000_")
        f["dangling"] = h5py.SoftLink("/nowhere")
    with h5py.File(path) as f:
        for group in ("/", "compact", "dense"):
            assert group_order(path, group) == list(f[group].keys()), group
    assert_iltpu_equal(path)
    assert_h5py_equal(path, ["info3", "soft", "info0"])
    with pytest.raises(KeyError):
        read_datasets(path, ["dangling"])


# ---------------------------------------------------------- chunk indexes

# index type of layout v4: 1 single chunk, 2 implicit, 3 fixed array,
# 4 extensible array, 5 v2 B-tree
INDEXES = {
    "single": (1, dict(chunks=(300, 11))),
    "single_gzip": (1, dict(chunks=(300, 11), compression="gzip")),
    "implicit": (2, None),
    "fixed_array": (3, dict(chunks=(20, 4))),
    "fixed_array_larger_max": (3, dict(chunks=(7, 3), maxshape=(400, 20))),
    "fixed_array_paged": (3, dict(chunks=(1, 2))),  # 1,800 chunks
    "fixed_array_paged_gzip": (3, dict(chunks=(1, 2), compression="gzip", shuffle=True)),
    "extensible_array": (4, dict(chunks=(3, 11), maxshape=(None, 11))),
    "extensible_array_lzf": (4, dict(chunks=(5, 4), maxshape=(None, 11), compression="lzf")),
    "extensible_array_second": (4, dict(chunks=(6, 2), maxshape=(300, None))),
    "extensible_array_paged": (4, None),  # past 131,060 chunks: paged data blocks
    "btree2": (5, dict(chunks=(4, 3), maxshape=(None, None))),
    "btree2_gzip_fletcher32": (5, dict(chunks=(2, 2), maxshape=(None, None),
                                       compression="gzip", fletcher32=True)),
}


@pytest.mark.parametrize("name", list(INDEXES))
def test_chunk_indexes_match_iltpu(tmp_path, name):
    """D4RL's `observations` under each of layout v4's chunk indexes, as
    iltpu's h5py loader reads it; paged indexes have unwritten pages (read as
    the fill value)."""
    kind, kw = INDEXES[name]
    path = str(tmp_path / f"{name}.hdf5")
    a = d4rl_arrays()
    with open_file(path, "latest") as f:
        for k, v in a.items():
            if k != "observations":
                f.create_dataset(k, data=v, compression="gzip")
        obs = a["observations"]
        if name == "implicit":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((32, 5))
            dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
            ds = h5py.h5d.create(f.id, b"observations", h5py.h5t.IEEE_F32LE,
                                 h5py.h5s.create_simple(obs.shape, (310, 12)), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, obs)
        elif name == "extensible_array_paged":
            d = f.create_dataset("observations", shape=(133_000, 1), maxshape=(None, 1),
                                 chunks=(1, 1), dtype=np.float32, fillvalue=-1.0)
            d[:40, 0] = obs[:40, 0]
            d[131_500:133_000, 0] = np.tile(obs[:, 0], 5)
        elif name.startswith("fixed_array_paged"):
            d = f.create_dataset("observations", shape=obs.shape, dtype=np.float32,
                                 fillvalue=0.5, **kw)
            d[:100], d[250:] = obs[:100], obs[250:]  # 1,024-entry pages: the second unwritten
        else:
            f.create_dataset("observations", data=obs, **kw)
    assert chunk_index(path, "observations") == (4, kind)
    assert_iltpu_equal(path)


@pytest.mark.parametrize("maxshape", [None, (None, 11), (None, None)],
                         ids=["fixed_array", "extensible_array", "btree2"])
def test_partial_edge_chunks_stored_raw(tmp_path, maxshape):
    """Layout v4's "don't filter partial edge chunks" (`H5Pset_chunk_opts`,
    which h5py does not wrap): chunks across the dataset's edge are stored
    without deflate and fletcher32 and with a filter mask of 0, and read as
    h5py reads them."""
    dont_filter_partial_chunks = 0x2
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((7, 3))
    dcpl.set_deflate(4)
    dcpl.set_fletcher32()
    assert libhdf5().H5Pset_chunk_opts(ctypes.c_int64(dcpl.id),
                                       ctypes.c_uint(dont_filter_partial_chunks)) >= 0
    x = np.round(np.random.default_rng(2).standard_normal((100, 11)), 2).astype("<f4")
    path = str(tmp_path / "edges.hdf5")
    with open_file(path, "latest") as f:
        top = None if maxshape is None else tuple(h5py.h5s.UNLIMITED if m is None else m
                                                  for m in maxshape)
        ds = h5py.h5d.create(f.id, b"x", h5py.h5t.IEEE_F32LE, h5py.h5s.create_simple((100, 11), top),
                             dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, x)
    with h5py.File(path) as f:
        last = f["x"].id.get_chunk_info(f["x"].id.get_num_chunks() - 1)
        assert (last.filter_mask, last.size) == (0, 7 * 3 * 4)  # raw, though its mask is 0
    assert_h5py_equal(path)


@pytest.mark.parametrize("libver", [None, "latest"])
def test_v1_btree_and_v4_indexes_agree_on_chunk_edges(tmp_path, libver):
    """A 3-d dataset whose chunks divide no dimension, under the v1 B-tree
    (layout v3) and the fixed array (layout v4), as h5py reads it."""
    path = str(tmp_path / "edges.hdf5")
    x = np.random.default_rng(3).standard_normal((13, 7, 5)).astype(">f8")
    with open_file(path, libver) as f:
        f.create_dataset("x", data=x, chunks=(4, 3, 2), compression="gzip", shuffle=True)
    assert chunk_index(path, "x") == ((3, None) if libver is None else (4, 3))
    assert_h5py_equal(path)


# -------------------------------------------------------------- datatypes


def write_types(path, libver):
    rng = np.random.default_rng(5)
    with open_file(path, libver) as f:
        f.create_dataset("fixed_ascii", data=np.array([b"", b"ab", b"abcdefgh"], "S8"))
        for pad, code in (("nullterm", h5py.h5t.STR_NULLTERM), ("spacepad", h5py.h5t.STR_SPACEPAD)):
            t = h5py.h5t.C_S1.copy()
            t.set_size(6)
            t.set_cset(h5py.h5t.CSET_UTF8)
            t.set_strpad(code)
            ds = h5py.h5d.create(f.id, f"fixed_utf8_{pad}".encode(), t, h5py.h5s.create_simple((3,)))
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array([b"ab   ", b"h\xc3\xb6p", b""], "S6"),
                     mtype=t)
        f.create_dataset("vlen_utf8", data=["", "SAC", "höpper", "x" * 300],
                         dtype=h5py.string_dtype())
        f.create_dataset("vlen_ascii", data=np.array([[b"a", b"bc"], [b"", b"def"]], object),
                         dtype=h5py.string_dtype("ascii"))
        f.create_dataset("vlen_scalar", data="SAC")
        seqs = np.empty(4, object)
        seqs[:] = [np.arange(3, dtype="<i2"), np.arange(0, dtype="<i2"),
                   np.arange(9, dtype="<i2") - 4, np.arange(1, dtype="<i2")]
        f.create_dataset("vlen_int16", data=seqs, dtype=h5py.vlen_dtype(np.int16))
        floats = np.empty(2, object)
        floats[:] = [rng.standard_normal(5), rng.standard_normal(2)]
        f.create_dataset("vlen_float64", data=floats, dtype=h5py.vlen_dtype(np.float64))
        inner = np.dtype([("u", "<u2"), ("v", ">f4")])
        nested = np.dtype([("a", "<i8"), ("in", inner), ("arr", "<f4", (2, 2)), ("flag", "?"),
                           ("s", "S3")])
        x = np.zeros(5, nested)
        x["a"], x["in"]["u"], x["in"]["v"] = np.arange(5), np.arange(5) * 3, rng.random(5)
        x["arr"], x["flag"], x["s"] = rng.random((5, 2, 2)), [1, 0, 1, 0, 1], b"xyz"
        f.create_dataset("compound_nested", data=x)
        aligned = np.dtype({"names": ["a", "b"], "formats": ["u1", "<f8"], "offsets": [0, 8],
                            "itemsize": 16})
        f.create_dataset("compound_aligned", data=np.ones(3, aligned))
        with_vlen = np.dtype([("n", "<i4"), ("name", h5py.string_dtype()), ("e", "?")])
        v = np.zeros(3, with_vlen)
        v["n"], v["name"], v["e"] = [1, 2, 3], ["one", "", "three"], [True, False, True]
        f.create_dataset("compound_vlen", data=v)
        f.create_dataset("array_f4", shape=(4,), dtype=np.dtype(("<f4", (3,))))[...] = \
            rng.random((4, 3))
        f.create_dataset("array_compound", shape=(2,), dtype=np.dtype((inner, (2,))))[...] = \
            np.ones((2, 2), inner)
        f.create_dataset("enum_u1", data=np.array([0, 5, 9], "u1"),
                         dtype=h5py.enum_dtype({"A": 0, "B": 5, "C": 9}, basetype="u1"))
        f.create_dataset("bool_from_i2", data=np.array([0, 1, 1, 0], "<i2"),
                         dtype=h5py.enum_dtype({"FALSE": 0, "TRUE": 1}, basetype="<i2"))
        ds = h5py.h5d.create(f.id, b"bitfield", h5py.h5t.STD_B32BE, h5py.h5s.create_simple((2,)))
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array([1, 2**31], ">u4"), mtype=h5py.h5t.STD_B32BE)
        f.create_dataset("opaque", data=np.frombuffer(b"abcde01234", "V5"))
        f["named"] = np.dtype([("x", "<i2"), ("y", ">f8")])
        for name in ("committed_a", "committed_b"):
            f.create_dataset(name, data=np.ones(3, f["named"].dtype), dtype=f["named"])
        f.create_dataset("empty_strings", shape=(0,), dtype=h5py.string_dtype())


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
def test_datatypes_match_h5py(tmp_path, libver):
    """Fixed and variable-length strings, variable-length sequences,
    compounds (nested, aligned, with array, bool and variable-length
    members), array types, enums, bitfields, opaque and committed types, as
    h5py reads them (committed types through a shared message in v1 and v2
    headers)."""
    path = str(tmp_path / "types.hdf5")
    write_types(path, libver)
    assert_h5py_equal(path)


def test_shared_message_table_matches_iltpu(tmp_path):
    """A file whose creation list keeps a shared-message table (`SMTB`, set
    through HDF5's `H5Pset_shared_mesg_*`, which h5py does not wrap): two
    indexes, dataspaces and datatypes in one, fill values, filter pipelines
    and attributes in the other, each message stored once in its index's
    fractal heap; D4RL's datasets and a committed and a compound type, as
    iltpu's loader and h5py read them."""
    lib = libhdf5()
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    dataspace, datatype, fill, pipeline, attribute = 1 << 1, 1 << 3, 1 << 5, 1 << 11, 1 << 12
    hid = ctypes.c_int64(fcpl.id)
    assert lib.H5Pset_shared_mesg_nindexes(hid, ctypes.c_uint(2)) >= 0
    for i, flags in enumerate((dataspace | datatype, fill | pipeline | attribute)):
        assert lib.H5Pset_shared_mesg_index(hid, ctypes.c_uint(i), ctypes.c_uint(flags),
                                            ctypes.c_uint(1)) >= 0
    path = str(tmp_path / "shared.hdf5")
    with h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)) as f:
        for k, v in d4rl_arrays().items():
            f.create_dataset(k, data=v, compression="gzip")
            f[k].attrs["unit"] = "none"
        f["named"] = np.dtype([("x", "<i2"), ("y", ">f8")])
        for name in ("committed_a", "committed_b"):
            f.create_dataset(name, data=np.ones(3, f["named"].dtype), dtype=f["named"])
        c = np.zeros(4, [("a", "<i4"), ("b", "S5")])
        f.create_dataset("compound_a", data=c)
        f.create_dataset("compound_b", data=c, compression="gzip")
    with open(path, "rb") as f:
        assert b"SMTB" in f.read()
    assert_iltpu_equal(path)
    assert_h5py_equal(path)


# ---------------------------------------------------------------- filters

FILTERS_CASES = {
    "lzf": dict(compression="lzf"),
    "lzf_shuffle_fletcher32": dict(compression="lzf", shuffle=True, fletcher32=True),
    "scaleoffset_int": dict(scaleoffset=0),
    "scaleoffset_int_bits": dict(scaleoffset=9),
    "scaleoffset_float": dict(scaleoffset=3),
}


@pytest.mark.parametrize("libver", [None, "latest"])
@pytest.mark.parametrize("name", list(FILTERS_CASES) + ["nbit", "szip"])
def test_filters_match_h5py(tmp_path, name, libver):
    """lzf (compressible chunks, and random ones lzf cannot shrink: stored
    raw, the filter's bit set in the mask), scale-offset on integers (its
    own bits, a fill value, both orders) and floats (decimal scale, a fill
    value), nbit as h5py writes it (whole-precision types: stored as is),
    szip (entropy coding and the preprocessor, 8- to 64-bit pixels in
    either order, blocks of 8 to 32 pixels, scanlines no block divides,
    runs of zero blocks), as h5py reads them."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / f"{name}.hdf5")
    with open_file(path, libver) as f:
        if name == "nbit":
            for i, (tid, dt) in enumerate(((h5py.h5t.STD_I32LE, "<i4"), (h5py.h5t.STD_U16BE, ">u2"))):
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_chunk((30,))
                dcpl.set_filter(hdf5_filters.NBIT, 0, ())
                data = rng.integers(0, 60000, 100).astype(dt)
                ds = h5py.h5d.create(f.id, f"nbit{i}".encode(), tid, h5py.h5s.create_simple((100,)),
                                     dcpl=dcpl)
                ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        elif name == "szip":
            walk = np.cumsum(rng.integers(-3, 4, 3000)) + 200
            for i, (dt, opts, chunks) in enumerate((
                    ("u1", ("nn", 8), (1000,)), ("<i2", ("ec", 16), (1000,)),
                    (">u2", ("nn", 32), (1000,)), ("<i4", ("ec", 8), (1500,)),
                    ("<f4", ("nn", 8), (37,)), (">f8", ("nn", 32), (3000,)))):
                data = (walk / 7 if dt[-2] == "f" else walk).astype(dt)
                f.create_dataset(f"x{i}", data=data, chunks=chunks, compression="szip",
                                 compression_opts=opts)
            runs = np.r_[np.zeros(2000), np.arange(300) % 11, np.zeros(2700)].astype("<u2")
            f.create_dataset("runs", data=runs, chunks=(5000,), compression="szip",
                             compression_opts=("nn", 16))
        else:
            kw = FILTERS_CASES[name]
            floats = name.endswith("float")
            for dt in ((">f4", "<f8") if floats else ("<i4", ">i2", "<u8", "<f4")):
                if dt == "<f4" and name.startswith("scaleoffset"):
                    continue
                if floats:
                    data = np.round(rng.standard_normal(500) * 100, 3).astype(dt)
                elif dt == "<f4":
                    data = np.repeat(rng.standard_normal(100), 5).astype(dt)
                else:
                    info = np.iinfo(np.dtype(dt))
                    data = rng.integers(max(info.min, -3000), min(info.max, 3000), 500).astype(dt)
                f.create_dataset(f"x{dt[1:]}", data=data, chunks=(64,), **kw)
                d = f.create_dataset(f"filled{dt[1:]}", shape=(500,), dtype=dt, chunks=(64,),
                                     fillvalue=7, **kw)
                d[100:300] = data[100:300]
            if name.startswith("lzf"):
                f.create_dataset("random", data=rng.integers(0, 2**32, 4096, dtype=np.uint64)
                                 .astype("<u4"), chunks=(1024,), **kw)
    assert_h5py_equal(path)


def libhdf5():
    """The HDF5 library h5py loaded, for the options h5py does not wrap."""
    libs = glob.glob(os.path.join(os.path.dirname(h5py.__file__), os.pardir, "h5py.libs",
                                  "libhdf5-*"))
    assert libs, "h5py's own libhdf5 not found"
    return ctypes.CDLL(libs[0])


def relaxed_fapl():
    """A file access list under which HDF5 1.14.6 writes and reads types
    whose precision is short of their size (what nbit packs): its
    `H5Pset_relax_file_integrity_checks`."""
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    unused_numeric_bits = 0x1
    assert libhdf5().H5Pset_relax_file_integrity_checks(
        ctypes.c_int64(fapl.id), ctypes.c_uint64(unused_numeric_bits)) >= 0
    return fapl


def reduced(base, precision, offset=0):
    t = base.copy()
    t.set_precision(precision)
    t.set_offset(offset)
    return t


@pytest.mark.parametrize("libver", [None, "latest"])
def test_nbit_packed_as_hdf5_packs_it(tmp_path, libver):
    """nbit's packing, which HDF5 does only for types whose precision is
    short of their size: integers of 12, 7 and 20 bits at bit offsets 0-5
    in either order, a compound of such members, a float and a string
    (stored whole), and an array type of them, as h5py reads them; the
    same types unfiltered (their precision and offset read by the
    datatype: shifted, sign-extended)."""
    path = str(tmp_path / "nbit.hdf5")
    fapl = relaxed_fapl()
    if libver:
        fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    rng = np.random.default_rng(11)
    i12 = reduced(h5py.h5t.STD_I32LE, 12)
    compound = h5py.h5t.create(h5py.h5t.COMPOUND, 16)
    compound.insert(b"a", 0, i12)
    compound.insert(b"b", 4, reduced(h5py.h5t.STD_U8LE, 5, 2))
    compound.insert(b"c", 5, h5py.h5t.IEEE_F64LE)
    s3 = h5py.h5t.C_S1.copy()
    s3.set_size(3)
    compound.insert(b"s", 13, s3)
    c = np.zeros(100, [("a", "<i4"), ("b", "u1"), ("c", "<f8"), ("s", "S3")])
    c["a"], c["b"] = rng.integers(-2048, 2048, 100), rng.integers(0, 32, 100)
    c["c"], c["s"] = rng.standard_normal(100), b"xyz"
    cases = {
        "i12": (i12, rng.integers(-2048, 2048, 120).astype("<i4")),
        "u7o3_be": (reduced(h5py.h5t.STD_U16BE, 7, 3), rng.integers(0, 128, 120).astype(">u2")),
        "i20o5_be": (reduced(h5py.h5t.STD_I32BE, 20, 5),
                     rng.integers(-2**19, 2**19, 120).astype(">i4")),
        "compound": (compound, c),
        "array": (h5py.h5t.array_create(i12, (2, 3)),
                  rng.integers(-2048, 2048, (70, 2, 3)).astype("<i4")),
    }
    with h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fapl=fapl)) as f:
        for name, (tid, data) in cases.items():
            mtype = (h5py.h5t.array_create(h5py.h5t.py_create(data.dtype), data.shape[1:])
                     if name == "array" else h5py.h5t.py_create(data.dtype))
            for filtered in (True, False):
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_chunk((40,))
                if filtered:
                    dcpl.set_filter(hdf5_filters.NBIT, 0, ())
                ds = h5py.h5d.create(f.id, f"{name}{'' if filtered else '_raw'}".encode(), tid,
                                     h5py.h5s.create_simple((len(data),)), dcpl=dcpl)
                ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data, mtype=mtype)
            assert f[name].id.get_create_plist().get_filter(0)[2][1] == 0  # packed, not as is
    with h5py.File(h5py.h5f.open(path.encode(), h5py.h5f.ACC_RDONLY, fapl=fapl)) as f:
        ref = {k: f[k][()] for k in f}
    fixture_module().same(read_datasets(path, list(ref)), ref)


# ------------------------------------------------------------- checksums


def test_lookup3_matches_the_published_values():
    """Bob Jenkins' lookup3.c driver: hashlittle of "" and of "Four score
    and seven years ago" with initval 0 and 1."""
    assert lookup3(b"") == 0xDEADBEEF
    assert lookup3(b"", 0xDEADBEEF) == 0xBD5B7DDE
    assert lookup3(b"Four score and seven years ago") == 0x17770551
    assert lookup3(b"Four score and seven years ago", 1) == 0xCD628161


def checksum_at(path, structure):
    """The offset of a v2 structure's stored checksum in a D4RL file under
    libver='latest' with a dense root."""
    found, header, raw = messages(path, "observations")
    sig = raw.index(b"\x89HDF\r\n\x1a\n")
    so = raw[sig + 9]
    if structure == "superblock":
        return sig + 12 + 4 * so
    if structure == "object_header":
        flags = raw[header + 5]
        q = header + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        return q + width + int.from_bytes(raw[q:q + width], "little")
    p = raw.index({"fixed_array": b"FAHD", "btree2": b"BTHD", "fractal_heap": b"FRHP"}[structure])
    if structure == "fixed_array":
        return p + 8 + 8 + so
    if structure == "btree2":
        return p + 16 + so + 2 + 8
    return p + 14 + 10 * 8 + 2 * so + 2 + 8 + 8 + 2 + 2 + so + 2


def corrupted(tmp_path, structure):
    """A D4RL file under libver='latest' with a dense root, read equal by
    both loaders, then one bit of `structure`'s stored checksum flipped."""
    path = str(tmp_path / "c.hdf5")
    with open_file(path, "latest") as f:
        for k, v in d4rl_arrays().items():
            f.create_dataset(k, data=v, chunks=(30,) + v.shape[1:], compression="gzip")
        for i in range(40):
            f.create_dataset(f"info{i}", data=i)
    assert_iltpu_equal(path)
    at = checksum_at(path, structure)
    with open(path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0x10]))
    return path


@pytest.mark.parametrize("structure", ["superblock", "object_header", "fixed_array", "btree2"])
def test_corrupted_checksums_are_refused_in_both(tmp_path, structure):
    """A v2 structure whose stored checksum is off by one bit: h5py refuses
    the file, and so does the port's loader."""
    path = corrupted(tmp_path, structure)
    with pytest.raises((OSError, KeyError, RuntimeError)):
        jax_load(path)
    with pytest.raises(ValueError, match="fails its checksum"):
        load_d4rl_hdf5(path)


def test_corrupted_fractal_heap_is_refused(tmp_path):
    """The dense root's fractal heap header with a bad checksum: the port's
    loader refuses it (HDF5 1.14.6 under h5py 3.14 ends the process on this
    file, so iltpu's loader is not run on it here)."""
    with pytest.raises(ValueError, match="fractal heap header at .* fails its checksum"):
        load_d4rl_hdf5(corrupted(tmp_path, "fractal_heap"))


@pytest.mark.parametrize("libver", [None, "latest"])
def test_unknown_filter_id_is_refused_in_both(tmp_path, libver):
    """lzf's id patched to 32123 in the filter pipeline message (the header's
    checksum made again under 'latest'): h5py cannot read the chunks that
    went through the filter, and the port's loader raises ValueError naming
    the id."""
    path = str(tmp_path / "unknown.hdf5")
    a = d4rl_arrays()
    a["observations"][:, 4:] = 0.0  # runs lzf shrinks: its chunks need the filter
    with open_file(path, libver) as f:
        for k, v in a.items():
            f.create_dataset(k, data=v, compression="lzf")
    found, header, raw = messages(path, "observations")
    p = found[FILTERS]
    at = p + (8 if raw[p] == 1 else 2)
    assert int.from_bytes(raw[at:at + 2], "little") == hdf5_filters.LZF
    raw = bytearray(raw)
    raw[at:at + 2] = (32123).to_bytes(2, "little")
    if libver:
        end = checksum_at_header(raw, header)
        raw[end:end + 4] = lookup3(bytes(raw[header:end])).to_bytes(4, "little")
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(OSError):
        jax_load(path)
    with pytest.raises(ValueError, match=f"filter id 32123 .*{ROADMAP}"):
        load_d4rl_hdf5(path)


def checksum_at_header(raw, header):
    flags = raw[header + 5]
    q = header + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    return q + width + int.from_bytes(raw[q:q + width], "little")


# --------------------------------------------------------- still refused


@pytest.mark.parametrize("what,libver", [
    ("virtual", "latest"),  # h5py writes virtual datasets from libver 'v110' on
    *((what, libver) for what in ("external_link", "external_data", "null_dataspace")
      for libver in (None, "latest"))])
def test_what_stays_refused_names_the_roadmap_item(tmp_path, what, libver):
    """The virtual layout, external links, raw data in external files and
    null dataspaces: iltpu's loader reads the file through h5py (an empty
    dataset is its `Empty`), the port's raises ValueError naming the
    structure and the ROADMAP item."""
    path = str(tmp_path / f"{what}.hdf5")
    a = d4rl_arrays()
    if what == "external_link":
        with open_file(str(tmp_path / "other.hdf5")) as f:
            f.create_dataset("observations", data=a["observations"])
    with open_file(path, libver) as f:
        for k, v in a.items():
            if k == "observations":
                continue
            f.create_dataset(k, data=v)
        if what == "virtual":
            f.create_dataset("source", data=a["observations"])
            layout = h5py.VirtualLayout(shape=a["observations"].shape, dtype=np.float32)
            layout[:] = h5py.VirtualSource(f["source"])
            f.create_virtual_dataset("observations", layout)
        elif what == "external_link":
            f["observations"] = h5py.ExternalLink("other.hdf5", "/observations")
        elif what == "external_data":
            raw = str(tmp_path / "observations.bin")
            a["observations"].tofile(raw)
            f.create_dataset("observations", shape=a["observations"].shape, dtype=np.float32,
                             external=[(raw, 0, a["observations"].nbytes)])
        else:
            f.create_dataset("observations", data=h5py.Empty(np.float32))
    structure = {"virtual": "virtual dataset layout", "external_link": "external link",
                 "external_data": "raw data in external files", "null_dataspace": "null dataspace"}[what]
    if what != "null_dataspace":
        assert np.array_equal(jax_load(path)["observations"], a["observations"])
    with pytest.raises(ValueError, match=f"{structure} .*{ROADMAP}"):
        load_d4rl_hdf5(path)


# --------------------------------------------------------------- fixtures


def test_committed_latest_fixtures_match_npz_h5py_and_their_seeds():
    """hopper_expert_latest.hdf5 (superblock v3, OHDR headers, fixed-array
    chunk indexes) through the port equals iltpu's h5py read and the npz;
    formats_latest.hdf5 through the port and through h5py (its packed nbit
    type read under HDF5's relaxed integrity checks) equals
    `fixture.formats_arrays()`, the arrays made again from their seed."""
    fixture = fixture_module()
    path = fixture.unpack("hopper_expert_latest.hdf5")
    assert_iltpu_equal(path)
    port = load_d4rl_hdf5(path)
    port.update(read_datasets(path, ["rewards"]))
    with np.load(os.path.join(REPO, "data", "hopper_expert.npz")) as npz:
        assert sorted(port) == sorted(npz.files)
        for k in npz.files:
            flag = k in ("terminals", "timeouts")
            assert port[k].dtype == (bool if flag else np.float32), k
            if flag:
                assert np.array_equal(port[k].astype(np.float32), npz[k]), k
            else:
                assert port[k].tobytes() == npz[k].tobytes(), k
    path = fixture.unpack("formats_latest.hdf5")
    want = fixture.formats_arrays()
    fixture.same(read_datasets(path, list(want)), want)
    ref = {k: (np.array(v, object) if isinstance(v, bytes) else v)
           for k, v in h5py_reads(path, list(want), relaxed_fapl()).items()}
    fixture.same(ref, want)
    assert chunk_index(path, "fixed_array_paged") == (4, 3)
    assert chunk_index(path, "extensible_array") == (4, 4)
    assert chunk_index(path, "btree2") == (4, 5)
    assert chunk_index(path, "implicit") == (4, 2)
    assert chunk_index(path, "single_chunk_gzip") == (4, 1)
