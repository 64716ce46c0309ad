"""The path of `hopper_expert.hdf5`, decoded from its committed text form.

    from fixture import unpack   # with data/d4rl on sys.path
    path = unpack()

`hopper_expert.hdf5.b64` (base64 of the file `make_fixture.py` writes) is
what the repo holds: a checkout made from a text diff drops binary files.
`unpack()` writes `hopper_expert.hdf5` beside it (gitignored) by an atomic
rename where it is missing or differs, and raises unless the bytes have the
sha256 below. Standard library only.
"""

import base64
import hashlib
import os

HERE = os.path.dirname(os.path.abspath(__file__))
PACKED = os.path.join(HERE, "hopper_expert.hdf5.b64")
PATH = os.path.join(HERE, "hopper_expert.hdf5")
SHA256 = "3fb83e93f06dd632ef560f42bbc26649833f3e290f3ccea77d41528aaf5e30ae"


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def unpack() -> str:
    """The decoded fixture's path."""
    if os.path.exists(PATH) and _sha256(PATH) == SHA256:
        return PATH
    with open(PACKED, "rb") as f:
        raw = base64.decodebytes(f.read())
    got = hashlib.sha256(raw).hexdigest()
    if got != SHA256:
        raise RuntimeError(f"{PACKED} decodes to sha256 {got}, not {SHA256}")
    tmp = f"{PATH}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(raw)
    os.replace(tmp, PATH)
    return PATH
