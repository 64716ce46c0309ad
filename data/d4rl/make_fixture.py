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

import h5py
import numpy as np

from fixture import DENSE, HERE, NAMED, SOFT, formats_arrays

SOURCE = os.path.join(HERE, "..", "hopper_expert.npz")

FLOATS = ("observations", "actions", "next_observations", "rewards")
FLAGS = ("terminals", "timeouts")


def latest(path, track_order=False):
    """A new file under libver='latest' whose headers store no times (the
    same bytes on every run: h5py's own groups store them), where HDF5 may
    write types whose precision is short of their size (what nbit packs:
    HDF5 1.14.6 refuses them unless its relaxed integrity checks, which h5py
    does not wrap, are on)."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    if track_order:
        fcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED | h5py.h5p.CRT_ORDER_INDEXED)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5py.h5f.LIBVER_LATEST, h5py.h5f.LIBVER_LATEST)
    libhdf5 = glob.glob(os.path.join(os.path.dirname(h5py.__file__), os.pardir, "h5py.libs",
                                     "libhdf5-*"))[0]
    unused_numeric_bits = 0x1
    ctypes.CDLL(libhdf5).H5Pset_relax_file_integrity_checks(
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


def main():
    for name, write in (("hopper_expert.hdf5", hopper),
                        ("hopper_expert_latest.hdf5", lambda p: hopper(p, libver="latest")),
                        ("formats_latest.hdf5", formats)):
        path = os.path.join(HERE, name)
        what = write(path)
        raw = open(path, "rb").read()
        with open(path + ".b64", "wb") as f:
            f.write(base64.encodebytes(raw))
        print(f"{path}: {len(raw)} bytes, {what}, sha256 {hashlib.sha256(raw).hexdigest()} "
              f"(fixture.SHA256); {path}.b64 written")


if __name__ == "__main__":
    main()
