"""Checkpoint save/restore: the port of `iltpu/utils/checkpoint.py`.

A checkpoint is a directory holding `leaves.npz`, the tree's leaves as
numpy arrays under `leaf_0 .. leaf_n`, and the port's own header
`header_torch.pkl` (the leaves' paths and a small aux dict of plain Python
and numpy values). The leaves come in iltpu's `jax.tree.flatten` order for
the same state, so iltpu's treedef of that state unflattens them; the trees
that `iltpu_torch.convert` builds mirror iltpu's layouts. iltpu's own
header, `header.pkl`, pickles a JAX treedef: the port never opens it (that
would import JAX), so it reads only directories it wrote itself.

Flattening follows JAX: a dict's values in sorted key order, a tuple's or
list's in order, and a `Fields` node (iltpu's dataclasses and NamedTuples,
which JAX flattens field by field) in insertion order. Anything else is a
leaf.
"""

import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

HEADER = "header_torch.pkl"
LEAVES = "leaves.npz"


class Fields(dict):
    """A tree node flattened in insertion order, as JAX flattens a
    dataclass's fields."""


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(node, Fields):
        return [(f".{k}", v) for k, v in node.items()]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten(tree) -> Tuple[List[Any], List[str]]:
    """(leaves, their paths) in JAX's order."""
    leaves, paths = [], []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            leaves.append(node)
            paths.append(path)
            return
        for name, child in kids:
            walk(child, path + name)

    walk(tree, "")
    return leaves, paths


def unflatten(like, leaves: List[Any]):
    """A tree shaped like `like` with `leaves` in flatten order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if isinstance(node, Fields):
            return Fields((k, build(v)) for k, v in node.items())
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for v in node)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def save_checkpoint(path: str, tree, aux: Optional[Dict] = None) -> None:
    """Write `tree`'s leaves (as numpy) and `aux` to the directory `path`."""
    os.makedirs(path, exist_ok=True)
    leaves, paths = flatten(tree)
    np.savez(os.path.join(path, LEAVES),
             **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)})
    with open(os.path.join(path, HEADER), "wb") as f:
        pickle.dump({"paths": paths, "aux": aux or {}}, f)


def _header(path: str) -> Dict:
    header_path = os.path.join(path, HEADER)
    if not os.path.exists(header_path):
        raise FileNotFoundError(f"{path} has no {HEADER}: not a checkpoint of the port")
    with open(header_path, "rb") as f:
        return pickle.load(f)


def load_aux(path: str) -> Dict:
    """The aux of a directory the port wrote, without its leaves."""
    return _header(path)["aux"]


def load_leaves(path: str) -> Dict[str, np.ndarray]:
    """{leaf path (as `flatten` names it): leaf} of a directory the port wrote."""
    header = _header(path)
    with np.load(os.path.join(path, LEAVES)) as data:
        return {p: data[f"leaf_{i}"] for i, p in enumerate(header["paths"])}


def load_checkpoint(path: str, like=None):
    """(the leaves, or a tree shaped like `like`, and the aux) of a
    directory the port wrote; with `like`, its leaf paths must be the
    checkpoint's (ValueError names the first that differs)."""
    header = _header(path)
    with np.load(os.path.join(path, LEAVES)) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if like is None:
        return leaves, header["aux"]
    want = flatten(like)[1]
    if want != header["paths"]:
        diff = next((f"{a} != {b}" for a, b in zip(header["paths"], want) if a != b),
                    f"{len(header['paths'])} leaves, {len(want)} expected")
        raise ValueError(f"{path} holds another state layout: {diff}")
    return unflatten(like, leaves), header["aux"]
