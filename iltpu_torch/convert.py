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
    "v"]}, ...)}[, "h": {"layers": ...} with reward shaping]}, count (int)}
  optimised MLP tree (DRIL's actor-shaped discriminator): {params, mu, nu:
    {"layers": ({"w", "b"}, ...)}, count (int)}
  RED tree: the optimised MLP tree of the predictor, plus target:
    {"layers": ...}, sigma_1 (float32 0-d), sigma_set (bool 0-d)
  PWIL pools: the (envs, N) float32 array of iltpu's batched
    `PWILState.expert_weights` (PWIL has no parameters)

`load_*_` copy a tree into an existing state in place (so modules that
share the state's tensors see the values); `*_tree` read a state out.

`train_state_tree(trainer)` is a trainer's whole state in the layout of
iltpu's `Trainer.state` (`iltpu/trainer.py:281-382`), built so that
`utils.checkpoint.flatten` gives its leaves in iltpu's `jax.tree.flatten`
order, with iltpu's shapes and dtypes: the optimiser moments as optax's
flat vectors, the counts as int32 scalars, the rings without their spare
row; `load_train_state_` copies such a tree back in place.
`agent_tree` and `disc_params_tree` are the run outputs `agent/` and
`discriminator/`.
"""

from typing import Dict, List

import numpy as np
import torch

from iltpu_torch.data.replay import COLUMNS
from iltpu_torch.utils.checkpoint import Fields, flatten, unflatten


def _layers(tree) -> List[np.ndarray]:
    out = []
    for layer in tree["layers"]:
        out += [layer["w"], layer["b"]]
    return out


def _tree(leaves) -> Dict:
    n = len(leaves) // 2
    return {"layers": tuple({"w": leaves[2 * i], "b": leaves[2 * i + 1]} for i in range(n))}


def _np(t: torch.Tensor) -> np.ndarray:
    # a copy made by torch: numpy never shares (and pins) the state's storage
    return t.detach().to("cpu", copy=True).numpy()


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


_NETS = ("g", "h")


@torch.no_grad()
def load_disc_tree_(st: Dict, tree: Dict) -> None:
    def nets(t):  # g's layers, then the shaping head's
        return [layer for n in _NETS if n in t for layer in t[n]["layers"]]

    params, mu, nu = nets(tree["params"]), nets(tree["mu"]), nets(tree["nu"])
    for key, layers in (("p", params), ("m", mu), ("v", nu)):
        _copy_(st[key], [x for layer in layers for x in (layer["w"], layer["b"])])
    if st["sn"]:
        for key, layers in (("sn", params), ("snm", mu), ("snv", nu)):
            _copy_(st[key], [x for layer in layers for x in (layer["u"], layer["v"])])
    _copy_([st["t"]], [tree["count"]])


def disc_tree(st: Dict) -> Dict:
    ng = st.get("ng", len(st["p"]))

    def layers(wb, uv):
        out = []
        for i in range(len(wb) // 2):
            layer = {"w": _np(wb[2 * i]), "b": _np(wb[2 * i + 1])}
            if uv:
                layer.update(u=_np(uv[2 * i]), v=_np(uv[2 * i + 1]))
            out.append(layer)
        nets = {"g": {"layers": tuple(out[:ng // 2])}}
        if ng < len(wb):
            nets["h"] = {"layers": tuple(out[ng // 2:])}
        return nets

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


@torch.no_grad()
def load_pwil_pools_(st, pools) -> None:
    _copy_([st.expert_weights], [pools])


def pwil_pools(st) -> np.ndarray:
    return _np(st.expert_weights)


# ------------------------------------------------- the trainer's whole state


def ravel(tree) -> np.ndarray:
    """The leaves of `tree` as one float32 vector, in flatten order
    (jax.flatten_util.ravel_pytree: optax.flatten's moments)."""
    return np.concatenate([np.asarray(x, np.float32).ravel() for x in flatten(tree)[0]])


def unravel(vec: np.ndarray, like):
    """`ravel`'s inverse: `vec` in the shapes of `like`'s leaves."""
    leaves, out, i = flatten(like)[0], [], 0
    for x in leaves:
        n = int(np.size(x))
        out.append(np.asarray(vec[i:i + n], np.float32).reshape(np.shape(x)))
        i += n
    return unflatten(like, out)


def _adam(count, mu, nu) -> tuple:
    """optax.flatten(adamw)'s state: (ScaleByAdamState(count, mu, nu),) with
    flat moments (its EmptyStates hold no leaves)."""
    return (Fields(count=np.asarray(count, np.int32), mu=ravel(mu), nu=ravel(nu)),)


def _from_adam(opt, like) -> Dict:
    a = opt[0]
    return {"mu": unravel(a["mu"], like), "nu": unravel(a["nu"], like), "count": int(a["count"])}


def replay_tree(rs) -> Fields:
    """iltpu's ReplayState: the ring without the spare row."""
    out = Fields((k, _np(rs.rows(k))) for k in COLUMNS)
    out.update(idx=np.asarray(int(rs.idx), np.int32), full=np.asarray(bool(rs.full)),
               num_trajectories=np.asarray(int(rs.num_trajectories), np.int32))
    return out


@torch.no_grad()
def load_replay_tree_(rs, tree) -> None:
    _copy_([rs.rows(k) for k in COLUMNS], [tree[k] for k in COLUMNS])
    for k in ("idx", "full", "num_trajectories"):
        getattr(rs, k).fill_(tree[k].item())


def sac_state_tree(st: Dict) -> Fields:
    """iltpu's SACState."""
    t = sac_tree(st)
    return Fields(
        actor_params=t["actor_params"], critic_params=t["critic_params"],
        target_critic_params=t["target_critic_params"], log_alpha=t["log_alpha"],
        actor_opt=_adam(t["actor_count"], t["actor_mu"], t["actor_nu"]),
        critic_opt=_adam(t["critic_count"], t["critic_mu"], t["critic_nu"]),
        alpha_opt=_adam(t["alpha_count"], t["alpha_mu"], t["alpha_nu"]),
    )


def load_sac_state_tree_(st: Dict, tree) -> None:
    t = {k: tree[k] for k in ("actor_params", "critic_params", "target_critic_params", "log_alpha")}
    for name, like in (("actor", "actor_params"), ("critic", "critic_params"),
                       ("alpha", "log_alpha")):
        a = _from_adam(tree[f"{name}_opt"], tree[like])
        t.update({f"{name}_mu": a["mu"], f"{name}_nu": a["nu"], f"{name}_count": a["count"]})
    load_sac_tree_(st, t)


def disc_params_tree(trainer):
    """The discriminator's parameters in iltpu's layout (`state["disc"]`,
    what iltpu writes to `discriminator/`); None for the algorithms
    without a trained discriminator."""
    alg, st = trainer.algorithm, trainer.disc_state
    if alg == "GAIL":
        return disc_tree(st)["params"]
    if alg == "DRIL":
        return opt_tree(st)["params"]
    if alg == "RED":
        t = red_tree(st)
        return Fields(predictor=t["params"], target=t["target"],
                      sigma_1=np.asarray(t["sigma_1"], np.float32),
                      sigma_set=np.asarray(t["sigma_set"]))
    if alg == "GMMIL":
        return Fields(gamma_1=_np(st.gamma_1), gamma_2=_np(st.gamma_2),
                      initialized=_np(st.initialized))
    if alg == "PWIL":
        return Fields(expert_weights=pwil_pools(st))
    return None


def agent_tree(sac: Dict) -> Dict:
    """What iltpu writes to `agent/`: actor, critic, log_alpha."""
    t = sac_tree(sac)
    return {"actor": t["actor_params"], "critic": t["critic_params"], "log_alpha": t["log_alpha"]}


def train_state_tree(trainer) -> Dict:
    """The trainer's whole state in the layout of iltpu's `Trainer.state`."""
    alg, st = trainer.algorithm, trainer.disc_state
    tree = {"sac": sac_state_tree(trainer.sac), "replay": replay_tree(trainer.replay),
            "expert": replay_tree(trainer.expert)}
    disc = disc_params_tree(trainer)
    if disc is not None:
        tree["disc"] = disc
    if alg in ("GAIL", "DRIL", "RED"):
        t = disc_tree(st) if alg == "GAIL" else opt_tree(st)
        tree["disc_opt"] = _adam(t["count"], t["mu"], t["nu"])
    if alg == "DRIL":
        tree["dril_threshold"] = _np(trainer.dril_threshold).reshape(())
    if alg == "AdRIL":
        tree["relabel"] = Fields(sample_expert=_np(trainer.relabel))
    return tree


@torch.no_grad()
def load_train_state_(trainer, tree: Dict) -> None:
    """Copy `train_state_tree`'s layout into the trainer's tensors, in place
    (the SAC state, the rings, the discriminator state and the graphs
    share them)."""
    alg, st = trainer.algorithm, trainer.disc_state
    load_sac_state_tree_(trainer.sac, tree["sac"])
    load_replay_tree_(trainer.replay, tree["replay"])
    load_replay_tree_(trainer.expert, tree["expert"])
    disc = tree.get("disc")
    if alg in ("GAIL", "DRIL", "RED"):
        like = disc["predictor"] if alg == "RED" else disc
        opt = dict(params=like, **_from_adam(tree["disc_opt"], like))
        if alg == "GAIL":
            load_disc_tree_(st, opt)
        elif alg == "DRIL":
            load_opt_tree_(st, opt)
            _copy_([trainer.dril_threshold], [tree["dril_threshold"]])
        else:
            load_red_tree_(st, dict(opt, target=disc["target"], sigma_1=disc["sigma_1"],
                                    sigma_set=disc["sigma_set"]))
    elif alg == "GMMIL":
        for k in ("gamma_1", "gamma_2", "initialized"):
            getattr(st, k).fill_(disc[k].item())
        st.settled = False  # its first call reads the flag on the device
    elif alg == "PWIL":
        load_pwil_pools_(st, disc["expert_weights"])
    if alg == "AdRIL":
        trainer.relabel.fill_(tree["relabel"]["sample_expert"].item())
