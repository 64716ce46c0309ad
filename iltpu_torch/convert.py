"""Carry weights and optimiser state between iltpu's pytree shapes, as numpy,
and the port's update states.

The trees hold numpy arrays in iltpu's own layouts, so a JAX-side caller
only unravels optax's flat moments (`ravel_pytree`) and reads the counts:

  SAC tree: {actor_params, critic_params, target_critic_params: {"layers":
    ({"w", "b"}, ...)} (critic leaves (2, ...)-stacked), log_alpha (1,),
    actor_mu, actor_nu, critic_mu, critic_nu (per-leaf trees like the
    params), alpha_mu, alpha_nu (1,), actor_count, critic_count,
    alpha_count (ints)}
  discriminator tree: {params, mu, nu: {"g": {"layers": ({"w", "b"[, "u",
    "v"]}, ...)}}, count (int)}
  optimised MLP tree (DRIL's actor-shaped discriminator): {params, mu, nu:
    {"layers": ({"w", "b"}, ...)}, count (int)}
  RED tree: the optimised MLP tree of the predictor, plus target:
    {"layers": ...}, sigma_1 (float32 0-d), sigma_set (bool 0-d)

`load_*_` copy a tree into an existing state in place (so modules that
share the state's tensors see the values); `*_tree` read a state out.
"""

from typing import Dict, List

import numpy as np
import torch


def _layers(tree) -> List[np.ndarray]:
    out = []
    for layer in tree["layers"]:
        out += [layer["w"], layer["b"]]
    return out


def _tree(leaves) -> Dict:
    n = len(leaves) // 2
    return {"layers": tuple({"w": leaves[2 * i], "b": leaves[2 * i + 1]} for i in range(n))}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _copy_(dst: List[torch.Tensor], src) -> None:
    for d, s in zip(dst, src, strict=True):
        s = np.array(s, np.float32).reshape(d.shape)
        d.copy_(torch.from_numpy(s))


_SAC_TREES = (
    ("a", "actor_params"), ("am", "actor_mu"), ("av", "actor_nu"),
    ("c", "critic_params"), ("cm", "critic_mu"), ("cv", "critic_nu"),
    ("t", "target_critic_params"),
)
_SAC_VECTORS = (
    ("la", "log_alpha"), ("lam", "alpha_mu"), ("lav", "alpha_nu"),
    ("ta", "actor_count"), ("tc", "critic_count"), ("tal", "alpha_count"),
)


@torch.no_grad()
def load_sac_tree_(st: Dict, tree: Dict) -> None:
    for key, name in _SAC_TREES:
        _copy_(st[key], _layers(tree[name]))
    for key, name in _SAC_VECTORS:
        _copy_([st[key]], [tree[name]])


def sac_tree(st: Dict) -> Dict:
    out = {name: _tree([_np(t) for t in st[key]]) for key, name in _SAC_TREES}
    for key, name in _SAC_VECTORS:
        out[name] = _np(st[key])
    for name in ("actor_count", "critic_count", "alpha_count"):
        out[name] = int(out[name][0])
    return out


@torch.no_grad()
def load_disc_tree_(st: Dict, tree: Dict) -> None:
    params = tree["params"]["g"]["layers"]
    mu, nu = tree["mu"]["g"]["layers"], tree["nu"]["g"]["layers"]
    for key, layers in (("p", params), ("m", mu), ("v", nu)):
        _copy_(st[key], [x for layer in layers for x in (layer["w"], layer["b"])])
    if st["sn"]:
        for key, layers in (("sn", params), ("snm", mu), ("snv", nu)):
            _copy_(st[key], [x for layer in layers for x in (layer["u"], layer["v"])])
    _copy_([st["t"]], [tree["count"]])


def disc_tree(st: Dict) -> Dict:
    def layers(wb, uv):
        out = []
        for i in range(len(wb) // 2):
            layer = {"w": _np(wb[2 * i]), "b": _np(wb[2 * i + 1])}
            if uv:
                layer.update(u=_np(uv[2 * i]), v=_np(uv[2 * i + 1]))
            out.append(layer)
        return {"g": {"layers": tuple(out)}}

    return {
        "params": layers(st["p"], st["sn"]),
        "mu": layers(st["m"], st["snm"]),
        "nu": layers(st["v"], st["snv"]),
        "count": int(st["t"][0]),
    }


@torch.no_grad()
def load_opt_tree_(st: Dict, tree: Dict) -> None:
    for key, name in (("p", "params"), ("m", "mu"), ("v", "nu")):
        _copy_(st[key], _layers(tree[name]))
    _copy_([st["t"]], [tree["count"]])


def opt_tree(st: Dict) -> Dict:
    out = {name: _tree([_np(t) for t in st[key]]) for key, name in (("p", "params"), ("m", "mu"), ("v", "nu"))}
    out["count"] = int(st["t"][0])
    return out


@torch.no_grad()
def load_red_tree_(st: Dict, tree: Dict) -> None:
    load_opt_tree_(st, tree)
    _copy_(st["target"], _layers(tree["target"]))
    st["sigma_1"].fill_(float(tree["sigma_1"]))
    st["sigma_set"].fill_(bool(tree["sigma_set"]))


def red_tree(st: Dict) -> Dict:
    out = opt_tree(st)
    out["target"] = _tree([_np(t) for t in st["target"]])
    out["sigma_1"] = _np(st["sigma_1"])
    out["sigma_set"] = bool(st["sigma_set"])
    return out
