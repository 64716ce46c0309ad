"""The port's HDF5 reader (iltpu_torch/data/hdf5.py) and `load_d4rl_hdf5`
against iltpu's h5py loader, on files h5py writes here: the same keys in
the same order, dtypes, shapes and values, exactly. The cases cover D4RL's
layout at three gzip levels, the other filters and layouts, chunks that
divide neither dimension, chunk B-trees of several levels, other dtypes, a
user block, a root of several symbol nodes, header continuation blocks,
a chunk stored raw under its filter mask, unwritten chunks with a fill
value, and the reconstruction of `next_observations`; a hypothesis test
over random datasets; `libver='latest'` files raise ValueError naming the
ROADMAP item; and a 200,000-row file reads in well under 2 s."""

import os
import time

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from hypothesis import given, settings, strategies as st  # noqa: E402

from iltpu.data.dataset import load_d4rl_hdf5 as jax_load  # noqa: E402
from iltpu_torch.data.dataset import load_d4rl_hdf5  # noqa: E402
from iltpu_torch.data.hdf5 import _fletcher32, read_datasets  # noqa: E402


def d4rl_arrays(rows=1000, S=11, A=3, seed=0, every=97):
    """D4RL's arrays: episodes of `every` rows ending alternately in a
    terminal and a timeout, the last row an end too."""
    rng = np.random.default_rng(seed)
    ends = np.zeros(rows, bool)
    ends[every - 1::every] = True
    ends[-1] = True
    idx = np.flatnonzero(ends)
    terminals, timeouts = np.zeros(rows, bool), np.zeros(rows, bool)
    terminals[idx[::2]] = True
    timeouts[idx[1::2]] = True
    obs = rng.standard_normal((rows, S)).astype(np.float32)
    return {
        "observations": obs,
        "actions": rng.uniform(-1, 1, (rows, A)).astype(np.float32),
        "next_observations": rng.standard_normal((rows, S)).astype(np.float32),
        "rewards": rng.standard_normal(rows).astype(np.float32),
        "terminals": terminals,
        "timeouts": timeouts,
    }


def write(path, arrays, file_kw=None, meta=True, **dataset_kw):
    """`arrays` as D4RL writes them (`create_dataset(k, data=v, ...)`), with a
    `metadata/` group; a (value, kwargs) pair takes its own kwargs."""
    with h5py.File(path, "w", **(file_kw or {})) as f:
        for k, v in arrays.items():
            v, kw = v if isinstance(v, tuple) else (v, dataset_kw)
            f.create_dataset(k, data=v, **kw)
        if meta:
            g = f.create_group("metadata")
            g.create_dataset("algorithm", data="SAC")
            g.create_dataset("iteration", data=np.int64(3000000))
    return str(path)


def assert_same(port, ref):
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype, (k, port[k].dtype, ref[k].dtype)
        assert port[k].shape == ref[k].shape, (k, port[k].shape, ref[k].shape)
        assert np.array_equal(port[k], ref[k]), k


def compact(f, name, arr):
    """A dataset with the compact layout (its data inside its header)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    tid = h5py.h5t.py_create(arr.dtype, logical=True)
    dsid = h5py.h5d.create(f.id, name.encode(), tid, h5py.h5s.create_simple(arr.shape), dcpl=dcpl)
    dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(arr))


def _case(name, tmp_path):
    p = tmp_path / f"{name}.hdf5"
    if name.startswith("gzip"):
        return write(p, d4rl_arrays(), compression="gzip", compression_opts=int(name[4:]))
    if name == "shuffle_gzip":
        return write(p, d4rl_arrays(), compression="gzip", shuffle=True)
    if name == "fletcher32":
        return write(p, d4rl_arrays(), fletcher32=True)
    if name == "fletcher32_shuffle_gzip":
        return write(p, d4rl_arrays(rows=777), fletcher32=True, shuffle=True, compression="gzip")
    if name == "contiguous":
        return write(p, d4rl_arrays())
    if name == "chunked_raw":
        return write(p, d4rl_arrays(), chunks=True)
    if name == "compact":
        with h5py.File(p, "w") as f:
            for k, v in d4rl_arrays(rows=12, every=5).items():
                compact(f, k, v)
        return str(p)
    if name == "odd_chunks":  # 1,001 x 11 in (7, 3) chunks: edge chunks cropped both ways
        a = d4rl_arrays(rows=1001)
        return write(p, {k: (v, dict(chunks=(7, 3) if v.ndim == 2 else (7,), compression="gzip"))
                         for k, v in a.items()})
    if name == "multilevel":  # 1,250 chunks: a chunk B-tree of two levels
        a = d4rl_arrays(rows=20000)
        return write(p, {k: (v, dict(chunks=(16, v.shape[1]) if v.ndim == 2 else (16,)))
                         for k, v in a.items()})
    if name == "dtypes":
        a = d4rl_arrays()
        a["observations"] = a["observations"].astype(">f4")
        a["actions"] = a["actions"].astype(np.float64)
        a["terminals"] = a["terminals"].astype(np.uint8)
        a["timeouts"] = a["timeouts"].astype(">i2")
        a["rewards"] = a["rewards"].astype(np.float16)
        return write(p, a, compression="gzip")
    if name == "userblock":
        return write(p, d4rl_arrays(), file_kw=dict(userblock_size=512), compression="gzip")
    if name == "root40":  # 40 entries, some groups: the root spans several SNODs
        a = dict(d4rl_arrays())
        for i in range(34):
            a[f"info{i:02d}"] = np.arange(i + 1, dtype=np.int32)
        path = write(p, a, compression="gzip")
        with h5py.File(path, "a") as f:
            for i in range(5):
                f.create_group(f"group{i}").create_dataset("x", data=np.arange(3))
        return path
    if name == "continuation":  # attributes push the headers into continuation blocks
        path = write(p, d4rl_arrays(), compression="gzip")
        with h5py.File(path, "a") as f:
            for k in ("observations", "terminals"):
                for i in range(24):
                    f[k].attrs[f"a{i}"] = np.arange(i + 1, dtype=np.float64)
            for i in range(24):
                f.attrs[f"r{i}"] = np.arange(i + 1)
        return path
    if name == "filter_mask":  # one chunk written raw, its deflate bit set in its mask
        a = d4rl_arrays(rows=40)
        path = write(p, {k: (v, dict(chunks=(20,) + v.shape[1:], compression="gzip"))
                         for k, v in a.items()})
        with h5py.File(path, "a") as f:
            d = f["observations"]
            d.id.write_direct_chunk((20, 0), np.full((20, 11), 5.0, np.float32).tobytes(),
                                    filter_mask=1)
        return path
    if name == "unwritten":  # chunks never written read as the fill value
        a = d4rl_arrays(rows=100)
        path = write(p, {k: v for k, v in a.items() if k != "observations"}, compression="gzip")
        with h5py.File(path, "a") as f:
            d = f.create_dataset("observations", shape=(100, 11), dtype=np.float32,
                                 chunks=(10, 4), fillvalue=-2.5, compression="gzip")
            d[30:55, 2:9] = a["observations"][30:55, 2:9]
        return path
    if name == "no_next_observations":
        a = d4rl_arrays()
        del a["next_observations"]
        return write(p, a, compression="gzip")
    raise KeyError(name)


CASES = ["gzip1", "gzip4", "gzip9", "shuffle_gzip", "fletcher32", "fletcher32_shuffle_gzip",
         "contiguous", "chunked_raw", "compact", "odd_chunks", "multilevel", "dtypes",
         "userblock", "root40", "continuation", "filter_mask", "unwritten", "no_next_observations"]


@pytest.mark.parametrize("name", CASES)
def test_load_d4rl_hdf5_matches_iltpu(tmp_path, name):
    path = _case(name, tmp_path)
    ref = jax_load(path)
    assert_same(load_d4rl_hdf5(path), ref)
    if name == "no_next_observations":
        assert "weights" in ref and not ref["weights"].all()
    if name == "multilevel":  # the chunk index really has more than one level
        with h5py.File(path) as f:
            assert f["observations"].id.get_num_chunks() == 1250


def test_reads_every_root_dataset_as_h5py(tmp_path):
    """`read_datasets` beyond D4RL's keys: every dataset of the 40-entry
    root and of the compact file, groups skipped, as h5py reads them."""
    for name in ("root40", "compact", "dtypes"):
        path = _case(name, tmp_path)
        with h5py.File(path) as f:
            names = [k for k in f if isinstance(f[k], h5py.Dataset)]
            ref = {k: np.asarray(f[k]) for k in names}
        assert_same(read_datasets(path, names), ref)


def test_scalars_and_enums_as_h5py(tmp_path):
    path = str(tmp_path / "misc.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("scalar", data=np.float64(3.25))
        f.create_dataset("int_scalar", data=np.int16(-7))
        f.create_dataset("enum", data=np.array([0, 1, 42], np.int16),
                         dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 42}, basetype="i2"))
        f.create_dataset("cube", data=np.arange(2 * 5 * 7, dtype=">u4").reshape(2, 5, 7),
                         chunks=(1, 2, 3), shuffle=True, compression="gzip")
        f.create_dataset("empty", shape=(0, 3), dtype=np.float32)
    with h5py.File(path) as f:
        ref = {k: np.asarray(f[k]) for k in f}
    assert_same(read_datasets(path, list(ref)), ref)


DTYPES = ["<f4", ">f4", "<f8", ">f8", "<f2", "<i1", "<u1", "<i2", ">u2", "<i4", ">i8", "<u8", "?"]


@settings(max_examples=25, deadline=None)
@given(
    shape=st.lists(st.integers(1, 40), min_size=1, max_size=3),
    dtype=st.sampled_from(DTYPES),
    chunk_frac=st.lists(st.floats(0.05, 1.0), min_size=3, max_size=3),
    layout=st.sampled_from(["contiguous", "chunked"]),
    gzip=st.sampled_from([None, 1, 6]),
    shuffle=st.booleans(),
    fletcher32=st.booleans(),
    seed=st.integers(0, 2**16),
)
def test_random_datasets_match_iltpu(tmp_path_factory, shape, dtype, chunk_frac, layout, gzip,
                                     shuffle, fletcher32, seed):
    """Random shapes, dtypes, chunk shapes and filters for `observations` in
    a small D4RL file, through both loaders."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        obs = rng.standard_normal(shape).astype(dt)
    elif dt.kind == "b":
        obs = rng.random(shape) < 0.5
    else:
        info = np.iinfo(dt)
        obs = rng.integers(info.min, info.max, shape, dtype=dt.newbyteorder("="), endpoint=True)
        obs = obs.astype(dt)
    kw = {}
    if layout == "chunked":
        kw["chunks"] = tuple(max(1, int(round(n * c))) for n, c in zip(shape, chunk_frac))
        if gzip is not None:
            kw.update(compression="gzip", compression_opts=gzip)
        kw.update(shuffle=shuffle, fletcher32=fletcher32)
    rows = shape[0]
    a = d4rl_arrays(rows=rows, every=7, seed=seed)
    a["observations"] = (obs, kw)
    a["next_observations"] = (obs, kw)
    path = write(tmp_path_factory.mktemp("h") / "r.hdf5", a, compression="gzip")
    assert_same(load_d4rl_hdf5(path), jax_load(path))


def test_newer_formats_raise_naming_the_roadmap_item(tmp_path):
    """h5py's libver='latest' structures (superblock v3, OHDR headers, link
    messages, layout v4 indexes) are outside the subset: ValueError naming
    the ROADMAP item, while iltpu reads the file through h5py."""
    for libver in ("latest", ("v108", "latest"), ("v110", "v110")):
        path = write(tmp_path / f"{libver!r}.hdf5", d4rl_arrays(), file_kw=dict(libver=libver),
                     compression="gzip")
        assert len(jax_load(path)["observations"]) == 1000
        with pytest.raises(ValueError, match="ROADMAP.md, 'HDF5 newer formats'"):
            load_d4rl_hdf5(path)


def test_unsupported_filter_raises_naming_it(tmp_path):
    path = write(tmp_path / "lzf.hdf5", d4rl_arrays(), compression="lzf")
    with pytest.raises(ValueError, match="filter id 32000 .*'HDF5 newer formats'"):
        load_d4rl_hdf5(path)


def test_missing_file_raises_file_not_found_in_both(tmp_path):
    path = str(tmp_path / "absent.hdf5")
    with pytest.raises(FileNotFoundError):
        load_d4rl_hdf5(path)
    with pytest.raises(FileNotFoundError):
        jax_load(path)


def _fletcher32_reference(data: bytes):
    """H5_checksum_fletcher32 as the HDF5 library writes it, word by word."""
    s1 = s2 = 0
    n = len(data) // 2
    i = 0
    while n:
        t = min(n, 360)
        n -= t
        for _ in range(t):
            s1 += (data[i] << 8) | data[i + 1]
            i += 2
            s2 += s1
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[i] << 8
        s2 += s1
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
    return s1 % 65535, s2 % 65535


@pytest.mark.parametrize("size", [0, 1, 2, 719, 720, 721, 5001])
def test_fletcher32_sums_match_the_library_loop(size):
    data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert _fletcher32(data) == _fletcher32_reference(data)
    assert _fletcher32(b"\xff" * size) == _fletcher32_reference(b"\xff" * size)


def test_a_large_gzip_file_reads_fast(tmp_path):
    """200,000 x 11 float32 under gzip with h5py's automatic chunks (D4RL's
    1M-row files have thousands of chunks) in well under 2 s on the CPU."""
    rng = np.random.default_rng(1)
    big = rng.standard_normal((200_000, 11)).astype(np.float32)
    path = write(tmp_path / "big.hdf5", {"observations": big}, meta=False, compression="gzip")
    t0 = time.perf_counter()
    got = read_datasets(path, ["observations"])
    seconds = time.perf_counter() - t0
    assert np.array_equal(got["observations"], big)
    assert seconds < 2.0, f"{seconds:.3f} s"
    assert os.path.getsize(path) < big.nbytes
