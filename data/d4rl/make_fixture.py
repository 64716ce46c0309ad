"""Write `hopper_expert.hdf5`: `data/hopper_expert.npz` in D4RL's HDF5 layout,
and its text form `hopper_expert.hdf5.b64`, the one committed.

    python data/d4rl/make_fixture.py

Needs h5py (the card's machine has none; the port reads the file without
it). A checkout made from a text diff drops binary files, so the file is
committed as base64 and `fixture.py` decodes it (sha256-checked) where the
.hdf5 is missing. Each array goes in as D4RL's generation scripts write theirs,
`create_dataset(k, data=v, compression="gzip")` with h5py's automatic
chunks and its default `libver=('earliest', ...)`: the float arrays as
float32, `terminals` and `timeouts` as bool (D4RL's dtype; the npz keeps
them as float32), and a `metadata/` group with a string `algorithm` and an
int `iteration`, as D4RL's files have.
"""

import base64
import hashlib
import os

import h5py
import numpy as np

from fixture import PACKED, PATH as TARGET

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "..", "hopper_expert.npz")

FLOATS = ("observations", "actions", "next_observations", "rewards")
FLAGS = ("terminals", "timeouts")


def main():
    with np.load(SOURCE) as npz:
        data = {k: npz[k] for k in npz.files}
    with h5py.File(TARGET, "w") as f:
        for k in FLOATS:
            f.create_dataset(k, data=data[k].astype(np.float32), compression="gzip")
        for k in FLAGS:
            f.create_dataset(k, data=data[k].astype(bool), compression="gzip")
        meta = f.create_group("metadata")
        # the npz's expert: SAC trained for 3M env steps (data/README.md)
        meta.create_dataset("algorithm", data="SAC")
        meta.create_dataset("iteration", data=np.int64(3_000_000))
    raw = open(TARGET, "rb").read()
    with open(PACKED, "wb") as f:
        f.write(base64.encodebytes(raw))
    print(f"{TARGET}: {len(raw)} bytes, {len(data['observations'])} rows, sha256 "
          f"{hashlib.sha256(raw).hexdigest()} (fixture.SHA256); {PACKED} written")


if __name__ == "__main__":
    main()
