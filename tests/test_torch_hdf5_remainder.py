"""The port's HDF5 reader on the last of what h5py reads, against h5py and
iltpu's h5py loader on files h5py writes here, each under h5py's default
libver and under libver='latest': raw data in external files (each way
HDF5 finds them), external links (each way HDF5 finds the file, to
groups, chained, missing, looping), virtual datasets (every selection kind
and encoding, `.` sources, missing sources and fill, nested and linked
sources, converted source types, printf-style and growing unlimited
mappings, each way HDF5 finds a source file), fractal heaps with filtered
blocks and filtered huge objects, floats of any layout (VAX included), and
what both packages refuse (time and reference types, user-defined links,
null dataspaces). HDF5 reads its prefix variables when the library starts,
so those cases run h5py and iltpu's loader in a fresh process."""

import ctypes
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from iltpu.data.dataset import load_d4rl_hdf5 as jax_load  # noqa: E402
from iltpu_torch.data.dataset import load_d4rl_hdf5  # noqa: E402
from iltpu_torch.data.hdf5 import read_datasets  # noqa: E402
from test_torch_hdf5_latest import (  # noqa: E402
    REPO, assert_h5py_equal, assert_iltpu_equal, d4rl_arrays, fixture_module, libhdf5, libver_id,
    open_file)

LIBVERS = [None, "latest"]


def main_file(path, libver, a, skip=("observations",), **kw):
    """A D4RL file of `a` without the keys in `skip`, open for more."""
    f = open_file(str(path), libver, **kw)
    for k, v in a.items():
        if k not in skip:
            f.create_dataset(k, data=v)
    return f


def both_refuse(path, match):
    """iltpu's loader raises (or returns what its trainer rejects) and the
    port raises ValueError matching `match`."""
    with pytest.raises(Exception):
        data = jax_load(path)
        np.asarray(data["observations"], np.float32)
    with pytest.raises(ValueError, match=match):
        load_d4rl_hdf5(path)


RUN = """
import os, pickle, sys
import numpy as np
import h5py
from iltpu.data.dataset import load_d4rl_hdf5
path, out = sys.argv[1], sys.argv[2]
res = {}
try:
    res["iltpu"] = load_d4rl_hdf5(path)
except Exception as e:
    res["iltpu"] = repr(e)
with h5py.File(path, "r") as f:
    res["h5py"] = {k: np.asarray(f[k]) for k in f if isinstance(f.get(k), h5py.Dataset)}
def plain(d):  # pickle drops a big-endian dtype's order: keep dtype, shape and bytes
    return d if isinstance(d, str) else {k: (v.dtype.str, v.shape, v.tobytes()) for k, v in d.items()}
with open(out, "wb") as f:
    pickle.dump({k: plain(v) for k, v in res.items()}, f)
"""


def fresh_process(tmp_path, path, env, cwd):
    """iltpu's loader's and h5py's reads of `path` in a process started
    with `env` set in `cwd`."""
    out = str(tmp_path / "fresh.pkl")
    full = {**os.environ, **env, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", RUN, path, out], env=full, cwd=cwd, check=True,
                   timeout=300, capture_output=True)
    with open(out, "rb") as f:
        res = pickle.load(f)
    return {k: v if isinstance(v, str) else
            {name: np.frombuffer(raw, dtype).reshape(shape) for name, (dtype, shape, raw) in v.items()}
            for k, v in res.items()}


def check(tmp_path, monkeypatch, path, env=None, cwd=None):
    """The port equals iltpu's loader and h5py's reads on `path` (in `cwd`,
    under `env`, where given)."""
    if cwd is not None:
        monkeypatch.chdir(cwd)
    if env:
        ref = fresh_process(tmp_path, path, env, cwd or os.getcwd())
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert not isinstance(ref["iltpu"], str), ref["iltpu"]
        port = load_d4rl_hdf5(path)
        assert list(port) == list(ref["iltpu"])
        for k, v in ref["iltpu"].items():
            assert port[k].dtype == v.dtype and port[k].shape == v.shape and port[k].tobytes() == v.tobytes(), k
        fixture_module().same(read_datasets(path, list(ref["h5py"])), ref["h5py"])
        return
    assert_iltpu_equal(path)
    assert_h5py_equal(path)


# ------------------------------------------------------ raw data in external files


def external_data(tmp_path, libver, how):
    """`observations` stored in external files named as `how` says;
    returns the file, the environment and the working directory to read
    it in."""
    a = d4rl_arrays()
    obs = a["observations"]
    raw = tmp_path / "raw"
    raw.mkdir()
    path = str(tmp_path / "main.hdf5")
    env, cwd, n = None, None, obs.nbytes
    if how == "short":  # the file ends 40 bytes into its slot: zeros past its end
        data = obs.tobytes()[:n - 40]
        slots = [(str(raw / "obs.bin"), 0, n)]
    elif how == "segments":  # three slots in two files, at offsets, the last unlimited
        data, head = obs.tobytes(), b"\x07" * 24
        (raw / "a.bin").write_bytes(head + data[:1000] + b"tail")
        (raw / "b.bin").write_bytes(data[1000:5000] + head + data[5000:])
        slots = [(str(raw / "a.bin"), 24, 1000), (str(raw / "b.bin"), 0, 4000),
                 (str(raw / "b.bin"), 4024, h5py.h5f.UNLIMITED)]
        data = None
    else:
        data = obs.tobytes()
        name = {"absolute": str(raw / "obs.bin"), "relative": "obs.bin", "origin": "raw/obs.bin",
                "prefix": "obs.bin", "missing": "nowhere.bin"}[how]
        slots = [(name, 0, n)]
        if how == "relative":
            cwd = str(raw)  # found from the working directory, as h5py finds it
        elif how == "origin":
            env = {"HDF5_EXTFILE_PREFIX": "${ORIGIN}"}
        elif how == "prefix":
            env = {"HDF5_EXTFILE_PREFIX": str(raw)}
    if data is not None:
        (raw / "obs.bin").write_bytes(data)
    with main_file(path, libver, a) as f:
        f.create_dataset("observations", shape=obs.shape, dtype=obs.dtype, external=slots)
    return path, env, cwd


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
@pytest.mark.parametrize("how", ["absolute", "relative", "origin", "prefix", "segments", "short"])
def test_external_raw_data_matches_iltpu(tmp_path, monkeypatch, how, libver):
    """Raw data in external files (message 0x7), the name absolute,
    relative (found from the working directory), under HDF5_EXTFILE_PREFIX
    as ${ORIGIN} and as a directory; three slots in two files at offsets,
    the last unlimited; a file shorter than its slot (zeros past its end,
    as HDF5 reads it)."""
    path, env, cwd = external_data(tmp_path, libver, how)
    check(tmp_path, monkeypatch, path, env, cwd)


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
def test_missing_external_raw_file_refused_in_both(tmp_path, libver):
    """An external raw file that is not there: h5py raises OSError, the
    port ValueError naming the structure."""
    path, _, _ = external_data(tmp_path, libver, "missing")
    both_refuse(path, "raw data in external files")


# ------------------------------------------------------------- external links


def target(path, a, libver=None, key="observations"):
    with open_file(str(path), libver) as f:
        f.create_dataset(key, data=a[key])
        g = f.create_group("group")
        g.create_dataset(key, data=a[key][::-1].copy())


def external_link(tmp_path, libver, how):
    a = d4rl_arrays()
    here, elsewhere = tmp_path / "here", tmp_path / "elsewhere"
    here.mkdir()
    elsewhere.mkdir()
    path = str(here / "main.hdf5")
    env, cwd = None, str(elsewhere)
    with main_file(path, libver, a) as f:
        if how == "beside":  # relative: found in the linking file's directory
            target(here / "t.hdf5", a, "earliest")
            f["observations"] = h5py.ExternalLink("t.hdf5", "/observations")
        elif how == "cwd":  # relative, found only from the working directory
            target(elsewhere / "t.hdf5", a)
            f["observations"] = h5py.ExternalLink("t.hdf5", "observations")
        elif how == "beside_over_cwd":  # both hold one: the linking file's directory wins
            target(here / "t.hdf5", a)
            target(elsewhere / "t.hdf5", d4rl_arrays(seed=1))
            f["observations"] = h5py.ExternalLink("t.hdf5", "/observations")
        elif how == "env":  # HDF5_EXT_PREFIX's second path, over the linking file's directory
            target(elsewhere / "t.hdf5", a)
            target(here / "t.hdf5", d4rl_arrays(seed=1))
            f["observations"] = h5py.ExternalLink("t.hdf5", "/observations")
            env, cwd = {"HDF5_EXT_PREFIX": f"{tmp_path / 'none'}:{elsewhere}"}, str(tmp_path)
        elif how == "absolute":
            target(elsewhere / "t.hdf5", a)
            f["observations"] = h5py.ExternalLink(str(elsewhere / "t.hdf5"), "/observations")
        elif how == "absolute_moved":  # gone from its absolute path: its name beside the link
            target(here / "t.hdf5", a)
            f["observations"] = h5py.ExternalLink(str(tmp_path / "gone" / "t.hdf5"), "/observations")
        elif how == "group":  # a link to a group, its dataset reached by a soft link
            target(here / "t.hdf5", a)
            f["ext"] = h5py.ExternalLink("t.hdf5", "/group")
            f["observations"] = h5py.SoftLink("/ext/observations")
        elif how == "chain":  # a link to a soft link to an external link
            target(elsewhere / "t.hdf5", a)
            with open_file(str(here / "hop.hdf5"), "latest") as g:
                g["to"] = h5py.ExternalLink(str(elsewhere / "t.hdf5"), "/observations")
                g["soft"] = h5py.SoftLink("/to")
            f["observations"] = h5py.ExternalLink("hop.hdf5", "/soft")
        elif how in ("missing", "loop"):
            if how == "loop":
                with open_file(str(here / "hop.hdf5")) as g:
                    g["observations"] = h5py.ExternalLink("main.hdf5", "/observations")
            f["observations"] = h5py.ExternalLink("hop.hdf5" if how == "loop" else "nowhere.hdf5",
                                                  "/observations")
    return path, env, cwd


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
@pytest.mark.parametrize("how", ["beside", "cwd", "beside_over_cwd", "env", "absolute",
                                 "absolute_moved", "group", "chain"])
def test_external_links_match_iltpu(tmp_path, monkeypatch, how, libver):
    """`observations` behind an external link (link type 64), its file
    found as HDF5 finds it: beside the linking file, from the working
    directory, the first over the second, HDF5_EXT_PREFIX's paths first,
    an absolute name, an absolute name moved (its last component beside
    the link); a link to a group (the target under libver 'earliest'); a
    chain of external and soft links across three files."""
    path, env, cwd = external_link(tmp_path, libver, how)
    check(tmp_path, monkeypatch, path, env, cwd)


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
@pytest.mark.parametrize("how,match", [("missing", "external link to 'nowhere.hdf5'"),
                                       ("loop", "nest too deep")])
def test_external_link_missing_or_looping_refused_in_both(tmp_path, monkeypatch, how, match, libver):
    """An external link to a file that is not there, and two files linking
    to each other: h5py raises, the port raises ValueError."""
    path, _, cwd = external_link(tmp_path, libver, how)
    monkeypatch.chdir(cwd)
    both_refuse(path, match)


# ------------------------------------------------------------ virtual datasets


def dims(maxshape):
    return None if maxshape is None else tuple(h5py.h5s.UNLIMITED if m is None else m for m in maxshape)


def hyper(shape, start, count, stride=None, block=None, maxshape=None):
    space = h5py.h5s.create_simple(shape, dims(maxshape))
    space.select_hyperslab(start, count, stride, block)
    return space


def blocks(shape, boxes, maxshape=None):
    """A selection of the union of `boxes` ((start, size) per box)."""
    space = h5py.h5s.create_simple(shape, maxshape)
    space.select_none()
    for start, size in boxes:
        space.select_hyperslab(start, (1,) * len(shape), None, size, h5py.h5s.SELECT_OR)
    return space


def nothing(shape):
    space = h5py.h5s.create_simple(shape)
    space.select_none()
    return space


def everything(shape, maxshape=None):
    space = h5py.h5s.create_simple(shape, maxshape)
    space.select_all()
    return space


def virtual(f, name, shape, dtype, maps, maxshape=None, fill=None):
    """A virtual dataset by h5py's low-level API: `maps` are (virtual
    selection, source file, source dataset, source selection)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if fill is not None:
        dcpl.set_fill_value(np.array(fill, dtype))
    for vspace, src_file, src_name, src_space in maps:
        dcpl.set_virtual(vspace, src_file.encode(), src_name.encode(), src_space)
    h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(np.dtype(dtype)),
                    h5py.h5s.create_simple(shape, dims(maxshape)), dcpl=dcpl)


def source(path, name, data, libver=None, **kw):
    with open_file(str(path), libver) if not os.path.exists(path) else h5py.File(str(path), "a") as f:
        f.create_dataset(name, data=data, **kw)


VDS = ["all", "rows", "strided", "irregular", "same_file", "missing", "nested",
       "linked", "convert", "wide_4", "wide_8", "printf", "growing", "beside", "cwd", "env_origin"]


def vds_file(tmp_path, libver, how):
    """`observations` (300 x 11 float32) virtual, mapped as `how` says;
    the other keys plain. Returns the file, environment and working
    directory."""
    a = d4rl_arrays()
    obs = a["observations"]
    S = obs.shape
    here, elsewhere = tmp_path / "here", tmp_path / "elsewhere"
    here.mkdir()
    elsewhere.mkdir()
    path = str(here / "main.hdf5")
    src = str(here / "src.hdf5")
    env, cwd = None, str(elsewhere)
    with main_file(path, libver, a) as f:
        if how == "all":  # a source's whole extent (selection 'all') onto all of it
            source(src, "obs", obs)
            virtual(f, "observations", S, "f4", [(everything(S), "src.hdf5", "obs", everything(S))])
        elif how == "rows":  # row blocks of two files, split unevenly, fill between
            source(src, "a", obs[:120])
            source(here / "src2.hdf5", "b", obs[120:], chunks=(7, 11), compression="gzip")
            virtual(f, "observations", S, "f4", [
                (hyper(S, (0, 0), (1, 1), None, (100, 11)), "src.hdf5", "a",
                 hyper((120, 11), (0, 0), (1, 1), None, (100, 11))),
                (hyper(S, (120, 0), (1, 1), None, (180, 11)), "src2.hdf5", "b", everything((180, 11)))],
                fill=-7.5)
        elif how == "strided":  # stride, count and block in both dimensions, both sides
            source(src, "obs", obs)
            virtual(f, "observations", S, "f4", [
                (hyper(S, (1, 0), (20, 3), (15, 4), (10, 3)), "src.hdf5", "obs",
                 hyper(S, (0, 2), (50, 9), (6, 1), (4, 1)))], fill=2.0)
        elif how == "irregular":  # unions of blocks (block lists), of other shapes on each side
            source(src, "obs", obs)
            virtual(f, "observations", S, "f4", [
                (blocks(S, [((0, 0), (10, 11)), ((40, 3), (5, 4)), ((200, 0), (20, 2))]), "src.hdf5",
                 "obs", blocks(S, [((160, 0), (2, 11)), ((50, 5), (100, 1)), ((290, 9), (8, 2)),
                                   ((280, 0), (16, 2))]))], fill=1.0)
        elif how == "same_file":  # source file ".", a later mapping over an earlier one, none
            f.create_dataset("raw_obs", data=obs)
            virtual(f, "observations", S, "f4", [
                (everything(S), ".", "raw_obs", everything(S)),
                (hyper(S, (10, 0), (1, 1), None, (5, 11)), ".", "/raw_obs",
                 hyper(S, (200, 0), (1, 1), None, (5, 11))),
                (nothing(S), ".", "raw_obs", nothing(S))])
        elif how == "missing":  # a missing file and a missing dataset: the fill value
            source(src, "obs", obs)
            virtual(f, "observations", S, "f4", [
                (hyper(S, (0, 0), (1, 1), None, (100, 11)), "src.hdf5", "obs",
                 hyper(S, (0, 0), (1, 1), None, (100, 11))),
                (hyper(S, (100, 0), (1, 1), None, (100, 11)), "nowhere.hdf5", "obs",
                 hyper(S, (100, 0), (1, 1), None, (100, 11))),
                (hyper(S, (200, 0), (1, 1), None, (100, 11)), "src.hdf5", "nothing",
                 hyper(S, (200, 0), (1, 1), None, (100, 11)))], fill=-1.0)
        elif how == "nested":  # a source that is itself virtual
            source(src, "obs", obs)
            with open_file(str(here / "mid.hdf5"), "latest") as g:
                virtual(g, "mid", S, "f4", [(everything(S), "src.hdf5", "obs", everything(S))])
            virtual(f, "observations", S, "f4", [(everything(S), "mid.hdf5", "mid", everything(S))])
        elif how == "linked":  # sources behind a soft link and an external link
            source(src, "obs", obs)
            with open_file(str(here / "links.hdf5"), libver) as g:
                g["soft"] = h5py.SoftLink("/ext")
                g["ext"] = h5py.ExternalLink("src.hdf5", "/obs")
            virtual(f, "observations", S, "f4", [
                (hyper(S, (0, 0), (1, 1), None, (150, 11)), "links.hdf5", "soft",
                 hyper(S, (0, 0), (1, 1), None, (150, 11))),
                (hyper(S, (150, 0), (1, 1), None, (150, 11)), "links.hdf5", "/ext",
                 hyper(S, (150, 0), (1, 1), None, (150, 11)))])
        elif how == "convert":  # float64 with values at float32's edges, and int64 saturating
            wide = obs.astype(np.float64) * (1 + 2.0 ** -30)
            top = float(np.finfo(np.float32).max)
            wide[0, :6] = [top * (1 + 2.0 ** -25), top * (1 + 2.0 ** -23), -top * 1.5, 1e-45, 7e-46, 2.0 ** -149 * 1.5]
            source(src, "wide", wide)
            virtual(f, "observations", S, "f4", [(everything(S), "src.hdf5", "wide", everything(S))])
            ints = np.arange(-2 ** 34, 2 ** 34, 2 ** 34 // 150, dtype=np.int64)[:300]
            source(src, "ints", ints)
            virtual(f, "counts", (300,), "<i4", [(everything((300,)), "src.hdf5", "ints", everything((300,)))])
            virtual(f, "big_endian", S, ">f4", [(everything(S), "src.hdf5", "wide", everything(S))])
        elif how == "wide_4":  # coordinates past 65,535: 4-byte fields
            big = np.zeros((70000, 11), np.float32)
            big[69000:69300] = obs
            source(src, "big", big, chunks=(1000, 11))
            virtual(f, "observations", S, "f4", [
                (everything(S), "src.hdf5", "big", hyper(big.shape, (69000, 0), (1, 1), None, S))])
        elif how == "wide_8":  # coordinates past 2^32: 8-byte fields (a sparse chunked source)
            n = 2 ** 33
            with open_file(src, libver) as g:
                d = g.create_dataset("big", shape=(11, n), maxshape=(None, None), dtype="f4",
                                     chunks=(11, 512), fillvalue=3.0)
                d[:, n - 300:] = obs.T
            virtual(f, "observations", S, "f4", [
                (blocks(S, [((0, 0), (150, 11))]), "src.hdf5", "big",
                 blocks((11, n), [((0, n - 300), (11, 70)), ((0, n - 200), (11, 80))])),
                (hyper(S, (150, 0), (1, 1), None, (150, 11)), "src.hdf5", "big",
                 hyper((11, n), (0, n - 150), (1, 1), None, (11, 150)))])
        elif how == "printf":  # %b names: block b from source file b while it exists
            for b in range(7):
                source(here / f"part_{b}%.hdf5", f"rows_{b}", obs[b * 40:(b + 1) * 40])
            vs = hyper(S, (0, 0), (h5py.h5s.UNLIMITED, 1), (43, 1), (40, 11), maxshape=(None, 11))
            virtual(f, "observations", S, "f4", [
                (vs, "part_%b%%.hdf5", "rows_%b", hyper((40, 11), (0, 0), (1, 1), None, (40, 11)))],
                maxshape=(None, 11), fill=4.0)
        elif how == "growing":  # an unlimited source selection onto an unlimited virtual one
            source(src, "grow", obs[:170], chunks=(10, 11), maxshape=(None, 11))
            vs = hyper(S, (0, 0), (h5py.h5s.UNLIMITED, 1), (3, 1), (2, 11), maxshape=(None, 11))
            ss = hyper((170, 11), (0, 0), (1, 1), None, (h5py.h5s.UNLIMITED, 11), maxshape=(None, 11))
            virtual(f, "observations", (10, 11), "f4", [(vs, "src.hdf5", "grow", ss)],
                    maxshape=(None, 11), fill=0.5)
        else:  # the source file found as HDF5 finds it
            where = {"beside": here, "cwd": elsewhere, "env_origin": here / "sub"}[how]
            where.mkdir(exist_ok=True)
            source(where / "s.hdf5", "obs", obs)
            if how == "env_origin":
                env = {"HDF5_VDS_PREFIX": "${ORIGIN}/sub"}
            virtual(f, "observations", S, "f4", [(everything(S), "s.hdf5", "obs", everything(S))])
    return path, env, cwd


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
@pytest.mark.parametrize("how", VDS)
def test_virtual_datasets_match_iltpu(tmp_path, monkeypatch, how, libver):
    """Virtual `observations` (layout class 3), with the selections HDF5
    serializes (all, points v1/v2, hyperslabs v1/v2/v3, regular and block
    lists, 2-, 4- and 8-byte fields), the fill value where no mapping or a
    missing source reaches, `.` sources, nested and linked sources, float64
    and int64 sources read as float32, big-endian float32 and int32 (HDF5's
    rounding, overflow to infinity and saturation), printf-style `%b`
    sources and a growing source under unlimited mappings (the extent h5py
    reports), the source file beside the virtual file, in the working
    directory and under HDF5_VDS_PREFIX with ${ORIGIN}."""
    path, env, cwd = vds_file(tmp_path, libver, how)
    check(tmp_path, monkeypatch, path, env, cwd)


def selections(path):
    """(kind, version, field size, regular) of every selection of the
    root's virtual `observations`."""
    from iltpu_torch.data import hdf5_virtual
    from iltpu_torch.data.hdf5 import LAYOUT, Files

    with Files() as files:
        h5 = files.open(path)
        where, addr = h5.follow(h5.root, h5.group(h5.root)["observations"])
        p = {kind: q for kind, q, _ in where.messages(addr)}[LAYOUT]
        return {(s.kind, s.version, s.size, s.regular is not None)
                for m in hdf5_virtual.mappings(where, p) for s in (m.source, m.virtual)}


def test_virtual_selection_encodings_covered(tmp_path):
    """The cases above hold every selection encoding HDF5 1.14.6 writes:
    all, none, hyperslab v1 (blocks), v2 (regular, unlimited),
    v3 (regular and blocks in 2, 4 and 8-byte fields)."""
    seen = set()
    for libver in LIBVERS:
        for how in VDS:
            sub = tmp_path / f"{how}_{libver_id(libver)}"
            sub.mkdir()
            if how == "wide_8" or how.startswith("env"):
                continue
            path, _, _ = vds_file(sub, libver, how)
            seen |= selections(path)
    sub = tmp_path / "wide_8"
    for libver in LIBVERS:
        (sub / libver_id(libver)).mkdir(parents=True)
        seen |= selections(vds_file(sub / libver_id(libver), libver, "wide_8")[0])
    want = {(3, 1, 4, False), (0, 1, 4, False), (2, 1, 4, False), (2, 2, 8, True),
            (2, 3, 2, True), (2, 3, 2, False), (2, 3, 4, True), (2, 3, 8, True), (2, 3, 8, False)}
    assert want <= seen, want - seen


# ------------------------------------------------- filtered fractal heaps


def deflated(path, libver, gcpl_too=False):
    """A file whose root group's link heap (and, with `gcpl_too`, the
    `runs` group's) is deflated: the filter set on the creation lists through
    ctypes (h5py does not wrap it for groups). Under the default libver the
    root tracks creation order, so that its links are messages too."""
    lib = libhdf5()
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    if libver is None:
        fcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED | h5py.h5p.CRT_ORDER_INDEXED)
    assert lib.H5Pset_deflate(ctypes.c_int64(fcpl.id), ctypes.c_uint(6)) >= 0
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    if libver == "latest":
        fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    f = h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl))
    if gcpl_too:
        gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
        gcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED)
        assert lib.H5Pset_deflate(ctypes.c_int64(gcpl.id), ctypes.c_uint(1)) >= 0
        h5py.h5g.create(f.id, b"runs", gcpl=gcpl)
    return f


def heap_of(path, group="/"):
    """The fractal heap of `group`'s links."""
    from iltpu_torch.data.hdf5 import LINK_INFO, Files
    from iltpu_torch.data.hdf5_fractal_heap import FractalHeap

    with Files() as files:
        h5 = files.open(str(path))
        where, here = h5.walk(group, 16)
        p = {kind: q for kind, q, _ in where.messages(here)}[LINK_INFO]
        heap = FractalHeap(where, where.addr(p + 2 + (8 if where.mm[p + 1] & 0x1 else 0)))
        tree = None
        if heap.huge_tree is not None:
            from iltpu_torch.data.hdf5_btree2 import BTree2
            tree = BTree2(where, heap.huge_tree).kind
        return bool(heap.filters), heap.root_rows, tree


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
@pytest.mark.parametrize("links", [4, 600])
def test_filtered_fractal_heaps_match_iltpu(tmp_path, links, libver):
    """A root whose link heap is deflated (the file creation list's deflate
    filter): a filtered root direct block (4 links) or indirect blocks of
    filtered direct blocks (600), a link name longer than the heap's
    largest managed object (a filtered huge object, v2 B-tree record type
    2), and a `runs` group deflated in its own creation list, reached by a
    soft link: each lists and reads as in h5py and iltpu."""
    a = d4rl_arrays()
    path = str(tmp_path / "heap.hdf5")
    with deflated(path, libver, gcpl_too=True) as f:
        for k, v in a.items():
            if k != "actions":
                f.create_dataset(k, data=v)
        for i in range(links):
            f[f"alias_{(i * 7919) % links:04d}_" + "abcdefgh" * (i % 9)] = h5py.SoftLink("/rewards")
        f["h" * 5000] = h5py.SoftLink("/terminals")
        runs = f["runs"]
        for i in range(40):
            runs[f"run_{i:02d}" + "x" * 300 * (i == 7)] = h5py.SoftLink("/observations")
        runs.create_dataset("actions", data=a["actions"])
        f["actions"] = h5py.SoftLink("/runs/actions")
    filtered, rows, huge = heap_of(path)
    assert filtered and huge == 2 and (rows > 0) == (links > 4)
    assert heap_of(path, "runs")[0]
    check_plain(path)
    with h5py.File(path, "r") as f:
        want = list(f["runs"])
    from test_torch_hdf5_latest import group_order
    assert group_order(path, "runs") == want and group_order(path, "/") == list(h5py.File(path, "r"))


def check_plain(path):
    assert_iltpu_equal(path)
    assert_h5py_equal(path)


# ---------------------------------------------------------- floats of any layout


FLOATS = {  # name: (size, order, offset, precision, sign, epos, esize, mpos, msize, bias, norm)
    "f24_in_4": (4, 0, 0, 24, 23, 16, 7, 0, 16, 63, 2),
    "half_bias_20": (2, 0, 0, 16, 15, 10, 5, 0, 10, 20, 2),
    "padded_48_of_64": (8, 0, 16, 48, 63, 52, 11, 16, 36, 1023, 2),
    "be_wide_exponent": (4, 1, 0, 32, 31, 21, 10, 0, 21, 511, 2),
    "explicit_leading_bit": (4, 0, 0, 32, 31, 23, 8, 0, 23, 127, 0),
    "sign_low": (4, 1, 0, 32, 0, 24, 8, 1, 23, 127, 2),
    "x87_in_12": (12, 0, 0, 80, 79, 64, 15, 0, 64, 16383, 0),
    "vax_order": (4, 2, 0, 32, 31, 23, 8, 0, 23, 127, 2),
    "vax_order_8": (8, 2, 0, 64, 63, 52, 11, 0, 52, 1023, 2),
}


def float_type(size, order, offset, precision, sign, epos, esize, mpos, msize, bias, norm):
    base = {2: h5py.h5t.IEEE_F16LE, 4: h5py.h5t.IEEE_F32LE, 8: h5py.h5t.IEEE_F64LE}.get(size)
    t = (base or h5py.h5t.NATIVE_LDOUBLE).copy()  # x87's 80 bits in 16 bytes
    if base is None:
        t.set_size(size)
    t.set_order([h5py.h5t.ORDER_LE, h5py.h5t.ORDER_BE, h5py.h5t.ORDER_VAX][order])
    # HDF5 checks each field against the precision and offset it has when set:
    # the fields low first, then the precision, the offset, the fields in place
    t.set_fields(sign - offset, epos - offset, esize, mpos - offset, msize)
    t.set_precision(precision)
    t.set_offset(offset)
    t.set_fields(sign, epos, esize, mpos, msize)
    t.set_ebias(bias)
    t.set_norm([h5py.h5t.NORM_NONE, h5py.h5t.NORM_MSBSET, h5py.h5t.NORM_IMPLIED][norm])
    return t


def float_bits(size, seed=0):
    """Bit patterns of `size` bytes: random ones (NaNs, infinities,
    denormals and all), zeros, and values whose cut-off bits make a tie."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (400, size), dtype=np.uint8)
    raw[:8] = 0
    raw[1, -1] = 0x80  # -0 wherever the sign is the top bit
    raw[8:40, :size // 2] = 0x80  # many zero bits low, one set: ties
    raw[40:60] = 0xFF
    raw[60:80, size // 2:] = 0
    return raw.view(f"V{size}").reshape(-1)


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
@pytest.mark.parametrize("name", list(FLOATS))
def test_floats_of_any_layout_match_h5py(tmp_path, name, libver):
    """A float of each layout, its bits random and chosen (ties, zeros,
    the exponent's extremes), read as h5py reads it: the dtype it picks
    and HDF5's conversion bit for bit (rounding, overflow to infinity,
    denormals, NaN); and `observations` stored in the layout, read as
    iltpu reads it. A VAX-ordered float's message is version 1 (HDF5 does
    not raise it), which HDF5 decodes as big-endian."""
    t = float_type(*FLOATS[name])
    path = str(tmp_path / "floats.hdf5")
    a = d4rl_arrays()
    with main_file(path, libver, a) as f:
        bits = float_bits(t.get_size())
        ds = h5py.h5d.create(f.id, b"bits", t, h5py.h5s.create_simple(bits.shape))
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, bits, mtype=t)
        ds = h5py.h5d.create(f.id, b"observations", t, h5py.h5s.create_simple(a["observations"].shape))
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a["observations"].astype(np.float64))
    check_plain(path)


def patched_version(path, name, version):
    """`name`'s datatype message raised to `version` in a file under the
    default libver (v1 object headers: no checksum)."""
    from test_torch_hdf5_latest import messages
    from iltpu_torch.data.hdf5 import DATATYPE

    found, _, raw = messages(path, name)
    raw = bytearray(raw)
    p = found[DATATYPE]
    raw[p] = (version << 4) | (raw[p] & 0xF)
    with open(path, "wb") as f:
        f.write(raw)


def test_vax_floats_of_a_version_3_message_refused_in_both(tmp_path):
    """A VAX-ordered float whose datatype message is version 3 (patched:
    HDF5 1.14.6 writes version 1), which HDF5 decodes as VAX: h5py has no
    dtype for that order (KeyError), the port raises ValueError."""
    path = str(tmp_path / "vax.hdf5")
    a = d4rl_arrays()
    with main_file(path, None, a) as f:
        for name in ("vax_order", "vax_order_8"):
            t = float_type(*FLOATS[name])
            bits = float_bits(t.get_size(), seed=1)
            ds = h5py.h5d.create(f.id, name.encode(), t, h5py.h5s.create_simple(bits.shape))
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, bits, mtype=t)
    for name in ("vax_order", "vax_order_8"):
        patched_version(path, name, 3)
    for name in ("vax_order", "vax_order_8"):
        with h5py.File(path, "r") as f, pytest.raises(KeyError):
            f[name].dtype
        with pytest.raises(ValueError, match="VAX-ordered float"):
            read_datasets(path, [name])


# ------------------------------------------------------- refused by both


def null_dataspace(f, a):
    f.create_dataset("observations", data=h5py.Empty(np.float32))


def time_type(f, a):
    lib = libhdf5()
    space = h5py.h5s.create_simple(a["observations"].shape)
    did = lib.H5Dcreate2(ctypes.c_int64(f.id.id), b"observations", ctypes.c_int64(h5py.h5t.UNIX_D32LE.id),
                         ctypes.c_int64(space.id), ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int64(0))
    assert did >= 0
    lib.H5Dclose(ctypes.c_int64(did))


def references(f, a):
    f.create_dataset("observations", data=[f["actions"].ref] * 4, dtype=h5py.ref_dtype)


def msb_set(f, a):
    t = h5py.h5t.IEEE_F32LE.copy()
    t.set_norm(h5py.h5t.NORM_MSBSET)
    ds = h5py.h5d.create(f.id, b"observations", t, h5py.h5s.create_simple(a["observations"].shape))
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a["observations"].view("V4"), mtype=t)


TRAVERSE = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                            ctypes.c_size_t, ctypes.c_int64, ctypes.c_int64)


class LinkClass(ctypes.Structure):
    _fields_ = [("version", ctypes.c_int), ("id", ctypes.c_int), ("comment", ctypes.c_char_p),
                ("create_func", ctypes.c_void_p), ("move_func", ctypes.c_void_p),
                ("copy_func", ctypes.c_void_p), ("trav_func", TRAVERSE),
                ("del_func", ctypes.c_void_p), ("query_func", ctypes.c_void_p)]


def user_defined_link(f, a):
    """A link of user-defined type 65 (its class registered through ctypes
    for the creation, then unregistered)."""
    lib = libhdf5()
    trav = TRAVERSE(lambda *args: -1)
    cls = LinkClass(1, 65, b"iltpu test", None, None, None, trav, None, None)
    assert lib.H5Lregister(ctypes.byref(cls)) >= 0
    try:
        assert lib.H5Lcreate_ud(ctypes.c_int64(f.id.id), b"observations", ctypes.c_int(65),
                                b"payload", ctypes.c_size_t(7), ctypes.c_int64(0),
                                ctypes.c_int64(0)) >= 0
    finally:
        lib.H5Lunregister(ctypes.c_int(65))


REFUSED = {"null_dataspace": (null_dataspace, "null dataspace"),
           "time": (time_type, "datatype class 2"),
           "references": (references, "datatype class 7"),
           "msb_set_float": (msb_set, "most significant bit set"),
           "user_defined_link": (user_defined_link, "user-defined link of type 65")}


@pytest.mark.parametrize("libver", LIBVERS, ids=libver_id)
@pytest.mark.parametrize("what", list(REFUSED))
def test_refused_in_both(tmp_path, what, libver):
    """`observations` as a null dataspace (h5py's Empty: iltpu's
    np.asarray raises TypeError), a time datatype (h5py has no dtype for
    it), references (iltpu returns h5py Reference objects its trainer
    cannot make floats of), a float normalised with its most significant
    bit set (HDF5 refuses to convert it), a user-defined link: iltpu's
    loader and the port both refuse."""
    make, match = REFUSED[what]
    path = str(tmp_path / f"{what}.hdf5")
    a = d4rl_arrays()
    with main_file(path, libver, a) as f:
        make(f, a)
    both_refuse(path, match)


# --------------------------------------------------------------- fixtures


def test_committed_remainder_fixtures_match_npz_h5py_and_their_seeds(tmp_path, monkeypatch):
    """hopper_expert_vds.hdf5 (each key virtual over row blocks of the two
    large fixtures, split at trajectory ends) and hopper_expert_links.hdf5
    (each key an external link into one of them) through the port equal
    iltpu's h5py reads and the npz, from any working directory;
    formats_remainder.hdf5 (read with HDF5_EXTFILE_PREFIX=${ORIGIN}, its
    root's link heap deflated) through the port and through h5py equals
    `fixture.remainder_arrays()`, the arrays made again from their seed."""
    fixture = fixture_module()
    monkeypatch.chdir(tmp_path)
    for name in ("hopper_expert_vds.hdf5", "hopper_expert_links.hdf5"):
        path = fixture.unpack(name)
        assert_iltpu_equal(path)
        port = load_d4rl_hdf5(path)
        port.update(read_datasets(path, ["rewards"]))
        with np.load(os.path.join(REPO, "data", "hopper_expert.npz")) as npz:
            assert sorted(port) == sorted(npz.files)
            for k in npz.files:
                flag = k in ("terminals", "timeouts")
                assert port[k].dtype == (bool if flag else np.float32), k
                assert (np.array_equal(port[k].astype(np.float32), npz[k]) if flag
                        else port[k].tobytes() == npz[k].tobytes()), k
    path = fixture.unpack("formats_remainder.hdf5")
    want = fixture.remainder_arrays()
    env = {"HDF5_EXTFILE_PREFIX": "${ORIGIN}"}
    fixture.same(fresh_process(tmp_path, path, env, str(tmp_path))["h5py"], want)
    monkeypatch.setenv("HDF5_EXTFILE_PREFIX", "${ORIGIN}")
    fixture.same(read_datasets(path, list(want)), want)
    filtered, rows, huge = heap_of(path)
    assert filtered and rows > 0 and huge == 2
