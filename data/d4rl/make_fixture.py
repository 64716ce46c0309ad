"""Write the HDF5 fixtures and their text forms (`<name>.b64`, the ones
committed):

- `hopper_expert.hdf5`: `data/hopper_expert.npz` in D4RL's HDF5 layout
  under h5py's default `libver=('earliest', ...)`;
- `hopper_expert_latest.hdf5`: the same under `libver='latest'` (superblock
  v3, `OHDR` headers, a compact link-message root, layout v4's fixed-array
  chunk index, filter pipeline v2);
- `formats_latest.hdf5`: `fixture.formats_arrays()` under `libver='latest'`,
  each dataset in the structure its name says.

    python data/d4rl/make_fixture.py

Needs h5py (the card's machine has none; the port reads the files without
it). A checkout made from a text diff drops binary files, so the files are
committed as base64 and `fixture.py` decodes them (sha256-checked) where
they are missing. The D4RL files' arrays go in as D4RL's generation scripts
write theirs, `create_dataset(k, data=v, compression="gzip")` with h5py's
automatic chunks: the float arrays as float32, `terminals` and `timeouts`
as bool (D4RL's dtype; the npz keeps them as float32), and a `metadata/`
group with a string `algorithm` and an int `iteration`, as D4RL's files
have.
"""

import base64
import ctypes
import glob
import hashlib
import os
import sys

import h5py
import numpy as np

from fixture import (ALIASES, DENSE, F24, HERE, HUGE, NAMED, REMAINDER_PARTS, SOFT, formats_arrays,
                     remainder_arrays, remainder_parts)

SOURCE = os.path.join(HERE, "..", "hopper_expert.npz")

FLOATS = ("observations", "actions", "next_observations", "rewards")
FLAGS = ("terminals", "timeouts")


def libhdf5():
    """The HDF5 library h5py loaded, for the options h5py does not wrap."""
    return ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(h5py.__file__), os.pardir,
                                              "h5py.libs", "libhdf5-*"))[0])


def latest(path, track_order=False, deflate=False, libver="latest"):
    """A new file under libver='latest' whose headers store no times (the
    same bytes on every run: h5py's own groups store them), where HDF5 may
    write types whose precision is short of their size (what nbit packs:
    HDF5 1.14.6 refuses them unless its relaxed integrity checks, which h5py
    does not wrap, are on)."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    if track_order:
        fcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED | h5py.h5p.CRT_ORDER_INDEXED)
    if deflate:  # the root group's link heap deflated: filtered fractal heap blocks
        libhdf5().H5Pset_deflate(ctypes.c_int64(fcpl.id), ctypes.c_uint(6))
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    if libver == "latest":
        fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    unused_numeric_bits = 0x1
    libhdf5().H5Pset_relax_file_integrity_checks(
        ctypes.c_int64(fapl.id), ctypes.c_uint64(unused_numeric_bits))
    return h5py.File(h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl))


def group(f, name):
    """A group that stores no times, tracking no creation order."""
    gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
    gcpl.set_obj_track_times(False)
    h5py.h5g.create(f.id, name.encode(), gcpl=gcpl)
    return f[name]


def hopper(path, libver=None):
    with np.load(SOURCE) as npz:
        data = {k: npz[k] for k in npz.files}
    with (h5py.File(path, "w") if libver is None else latest(path)) as f:
        for k in FLOATS:
            f.create_dataset(k, data=data[k].astype(np.float32), compression="gzip")
        for k in FLAGS:
            f.create_dataset(k, data=data[k].astype(bool), compression="gzip")
        meta = f.create_group("metadata") if libver is None else group(f, "metadata")
        # the npz's expert: SAC trained for 3M env steps (data/README.md)
        meta.create_dataset("algorithm", data="SAC")
        meta.create_dataset("iteration", data=np.int64(3_000_000))
    return f"{len(data['observations'])} rows"


def low_level(f, name, tid, shape, data, dcpl=None):
    """A dataset made by h5py's low-level API (a datatype or property the
    high-level one does not set), its bytes written as they are, no times
    stored."""
    dcpl = dcpl or h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_obj_track_times(False)
    ds = h5py.h5d.create(f.id, name.encode(), tid, h5py.h5s.create_simple(shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data), mtype=tid)


def formats(path):
    a = formats_arrays()
    with latest(path, track_order=True) as f:
        d = f.create_dataset("fixed_array_paged", shape=(4200,), dtype="<i2", chunks=(2,),
                             fillvalue=-3)
        d[:500], d[4000:] = a["fixed_array_paged"][:500], a["fixed_array_paged"][4000:]
        f.create_dataset("fixed_array_gzip", data=a["fixed_array_gzip"], chunks=(10, 3),
                         compression="gzip", shuffle=True)
        f.create_dataset("extensible_array", data=a["extensible_array"], chunks=(2,),
                         maxshape=(None,))
        f.create_dataset("extensible_array_lzf", data=a["extensible_array_lzf"], chunks=(4, 7),
                         maxshape=(40, None), compression="lzf")
        f.create_dataset("btree2", data=a["btree2"], chunks=(3, 4), maxshape=(None, None))
        f.create_dataset("btree2_gzip_fletcher32", data=a["btree2_gzip_fletcher32"],
                         chunks=(5, 5), maxshape=(None, None), compression="gzip",
                         fletcher32=True)
        f.create_dataset("single_chunk", data=a["single_chunk"], chunks=(20, 11))
        f.create_dataset("single_chunk_gzip", data=a["single_chunk_gzip"], chunks=(20, 11),
                         compression="gzip")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((5, 4))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        space = h5py.h5s.create_simple((12, 9), (15, 9))
        dcpl.set_obj_track_times(False)
        ds = h5py.h5d.create(f.id, b"implicit", h5py.h5t.IEEE_F64LE, space, dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a["implicit"])
        f.create_dataset("contiguous", data=a["contiguous"])
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        low_level(f, "compact", h5py.h5t.STD_U8LE, (4, 5), a["compact"], dcpl)

        f.create_dataset("strings", data=a["strings"])
        utf8 = h5py.h5t.C_S1.copy()  # null-terminated, where h5py's own are null-padded
        utf8.set_size(12)
        utf8.set_cset(h5py.h5t.CSET_UTF8)
        utf8.set_strpad(h5py.h5t.STR_NULLTERM)
        low_level(f, "strings_utf8", utf8, (len(a["strings_utf8"]),), a["strings_utf8"])
        f.create_dataset("vlen_strings", data=a["vlen_strings"], dtype=h5py.string_dtype())
        f.create_dataset("vlen_ints", data=a["vlen_ints"], dtype=h5py.vlen_dtype(np.int32))
        f.create_dataset("compound", data=a["compound"])
        f.create_dataset("compound_aligned", data=a["compound_aligned"])
        vlen_member = np.dtype([("n", "<i8"), ("name", h5py.string_dtype())])
        f.create_dataset("compound_vlen", data=a["compound_vlen"].astype(vlen_member))
        f.create_dataset("array", shape=(5,), dtype=np.dtype(("<f4", (2, 3))))[...] = a["array"]
        f.create_dataset("enum", data=a["enum"],
                         dtype=h5py.enum_dtype({"LOW": 0, "MID": 1, "HIGH": 2}, basetype="<i2"))
        f["committed_type"] = NAMED  # its header stores times: its bytes differ run to run
        f.create_dataset("committed", data=a["committed"], dtype=f["committed_type"])
        low_level(f, "bitfield", h5py.h5t.STD_B16LE, (9,), a["bitfield"])
        f.create_dataset("flags", data=a["flags"])
        f.create_dataset("scalar_string", data="SAC")
        f.create_dataset("scalar", data=a["scalar"])

        f.create_dataset("lzf", data=a["lzf"], compression="lzf")
        f.create_dataset("lzf_random", data=a["lzf_random"], chunks=(16, 16), compression="lzf")
        f.create_dataset("shuffle_gzip_fletcher32", data=a["shuffle_gzip_fletcher32"],
                         compression="gzip", shuffle=True, fletcher32=True)
        f.create_dataset("scaleoffset_int", data=a["scaleoffset_int"], chunks=(250,),
                         scaleoffset=0)
        f.create_dataset("scaleoffset_float", data=a["scaleoffset_float"], chunks=(250,),
                         scaleoffset=3)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((100,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0, ())
        i21 = h5py.h5t.STD_I32LE.copy()  # 21 of its 32 bits: what nbit packs
        i21.set_precision(21)
        ds = h5py.h5d.create(f.id, b"nbit", i21, h5py.h5s.create_simple((300,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, a["nbit"])
        f.create_dataset("szip", data=a["szip"], chunks=(1000,), compression="szip",
                         compression_opts=("nn", 16))

        dense = group(f, "dense")  # name order: it does not track creation order
        for i in SOFT:
            dense.create_dataset(f"data_{i}", data=a[f"soft_{i}"])
        for name in DENSE:  # soft links: a fractal heap with indirect blocks, little else
            number = int(name.split("_")[1])
            dense[name] = h5py.SoftLink(f"/dense/data_{number}" if number in SOFT else "/contiguous")
        for i in SOFT:  # relative, to a soft link in the dense group
            f[f"soft_{i}"] = h5py.SoftLink("dense/" + DENSE[[int(n.split("_")[1]) for n in DENSE].index(i)])
        for i in range(8):
            f.create_dataset(f"z_small_{7 - i}", data=a[f"z_small_{7 - i}"])
    return f"{len(a)} root datasets"


def trajectory_blocks():
    """Five row blocks of the npz, each ending at the end of every fifth
    trajectory (a terminal or a timeout), taken from the two large files in
    turns: [(source file, start, stop)]."""
    with np.load(SOURCE) as npz:
        ends = np.flatnonzero((npz["terminals"] > 0) | (npz["timeouts"] > 0)) + 1
    cuts = [0, *ends[4::5][:4].tolist(), int(ends[-1])]
    files = ("hopper_expert.hdf5", "hopper_expert_latest.hdf5")
    return [(files[i % 2], a, b) for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]


def virtual(f, name, dtype, shape, maps, fill=None, maxshape=None):
    """A virtual dataset by h5py's low-level API, no times stored: `maps`
    are (virtual selection, source file, source dataset, source
    selection)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_obj_track_times(False)
    if fill is not None:
        dcpl.set_fill_value(np.array(fill, dtype))
    for vspace, src_file, src_name, src_space in maps:
        dcpl.set_virtual(vspace, src_file.encode(), src_name.encode(), src_space)
    h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(np.dtype(dtype)),
                    h5py.h5s.create_simple(shape, maxshape), dcpl=dcpl)


def rows(shape, start, stop, maxshape=None):
    """A selection of rows [start, stop) of a dataspace of `shape`."""
    space = h5py.h5s.create_simple(shape, maxshape)
    space.select_hyperslab((start,) + (0,) * (len(shape) - 1), (1,) * len(shape), None,
                           (stop - start,) + tuple(shape[1:]))
    return space


def hopper_vds(path):
    """Each D4RL key virtual: the rows of `trajectory_blocks`, the source
    files named relative to this one."""
    blocks = trajectory_blocks()
    with h5py.File(os.path.join(HERE, "hopper_expert.hdf5"), "r") as src:
        kinds = {k: (src[k].shape, src[k].dtype) for k in (*FLOATS, *FLAGS)}
    with latest(path) as f:
        for k, (shape, dtype) in kinds.items():
            virtual(f, k, dtype, shape, [(rows(shape, a, b), name, k, rows(shape, a, b))
                                         for name, a, b in blocks])
    return f"{len(blocks)} blocks a key: " + ", ".join(f"{n} [{a}, {b})" for n, a, b in blocks)


def hopper_links(path):
    """Each D4RL key an external link into one of the two large files, in
    turns, under h5py's default libver."""
    files = ("hopper_expert.hdf5", "hopper_expert_latest.hdf5")
    with latest(path, libver=None) as f:
        for i, k in enumerate((*FLOATS, *FLAGS)):
            f[k] = h5py.ExternalLink(files[i % 2], "/" + k)
    return "6 external links"


def float_type(size, order, offset, precision, sign, epos, esize, mpos, msize, bias):
    t = h5py.h5t.IEEE_F32LE.copy() if size == 4 else h5py.h5t.IEEE_F64LE.copy()
    t.set_order(order)
    t.set_fields(sign - offset, epos - offset, esize, mpos - offset, msize)
    t.set_precision(precision)
    t.set_offset(offset)
    t.set_fields(sign, epos, esize, mpos, msize)
    t.set_ebias(bias)
    return t


def remainder(path):
    """formats_remainder.hdf5 and the files it names: its root's link heap
    deflated (filtered blocks, a filtered huge object), tracking creation
    order, under libver='latest'."""
    a, parts = remainder_arrays(), remainder_parts()
    for b, part in enumerate(parts):
        with latest(os.path.join(HERE, REMAINDER_PARTS[b])) as g:
            g.create_dataset("rows", data=part)
    raw = a["external_raw"].tobytes()
    with open(os.path.join(HERE, "formats_remainder_raw.bin"), "wb") as g:
        g.write(b"head" * 4 + raw[:700] + b"gap!" + raw[700:])
    with latest(path, track_order=True, deflate=True) as f:
        f.create_dataset("plain", data=a["plain"])
        f.create_dataset("external_raw", shape=(50, 8), dtype="<i4", external=[
            ("formats_remainder_raw.bin", 16, 700), ("formats_remainder_raw.bin", 720, len(raw) - 700)])
        f["external_link"] = h5py.ExternalLink(REMAINDER_PARTS[1], "/rows")
        virtual(f, "virtual_blocks", "<f4", (40, 6), [
            (rows((40, 6), 0, 10), ".", "plain", rows((40, 6), 30, 40)),
            (rows((40, 6), 10, 20), REMAINDER_PARTS[0], "rows", rows((10, 6), 0, 10))], fill=-1)
        vspace = h5py.h5s.create_simple((34, 6), (h5py.h5s.UNLIMITED, 6))
        vspace.select_hyperslab((0, 0), (h5py.h5s.UNLIMITED, 1), (12, 1), (10, 6))
        virtual(f, "virtual_printf", "<f4", (34, 6), [
            (vspace, "formats_remainder_part_%b.hdf5", "rows", rows((10, 6), 0, 10))],
            fill=9, maxshape=(h5py.h5s.UNLIMITED, 6))
        f.create_dataset("wide", data=a["wide"])
        virtual(f, "virtual_converted", "<f4", (64,), [(rows((64,), 0, 64), ".", "wide", rows((64,), 0, 64))])
        virtual(f, "virtual_missing", "<f4", (8, 3), [
            (rows((8, 3), 0, 8), "formats_remainder_nowhere.hdf5", "rows", rows((8, 3), 0, 8))], fill=2.5)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_obj_track_times(False)
        vax = h5py.h5t.IEEE_F32LE.copy()
        vax.set_order(h5py.h5t.ORDER_VAX)
        # each written from float32 by HDF5's conversion (exact for these values)
        for name, t, data in (("float_f24", float_type(*F24), a["float_f24"]),
                              ("float_vax", vax, a["float_vax"].view("u1").reshape(-1, 4)[:, [2, 3, 0, 1]]
                               .copy().view("<f4").reshape(-1))):
            ds = h5py.h5d.create(f.id, name.encode(), t, h5py.h5s.create_simple(data.shape), dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        for i in range(ALIASES):
            f[f"alias_{i:02d}"] = h5py.SoftLink("/plain")
        f[HUGE] = h5py.SoftLink("/plain")
    return f"{len(a)} root datasets"


def main(names):
    for name, write in (("hopper_expert.hdf5", hopper),
                        ("hopper_expert_latest.hdf5", lambda p: hopper(p, libver="latest")),
                        ("formats_latest.hdf5", formats),
                        ("hopper_expert_vds.hdf5", hopper_vds),
                        ("hopper_expert_links.hdf5", hopper_links),
                        ("formats_remainder.hdf5", remainder),
                        *((n, None) for n in ("formats_remainder_raw.bin", *REMAINDER_PARTS))):
        if names and name not in names:
            continue
        path = os.path.join(HERE, name)
        what = write(path) if write else "written with formats_remainder.hdf5"
        raw = open(path, "rb").read()
        with open(path + ".b64", "wb") as f:
            f.write(base64.encodebytes(raw))
        print(f"{path}: {len(raw)} bytes, {what}, sha256 {hashlib.sha256(raw).hexdigest()} "
              f"(fixture.SHA256); {path}.b64 written")


if __name__ == "__main__":
    main(sys.argv[1:])
