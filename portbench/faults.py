"""What must make `correct` come out false: the control and the planted
faults, each put under a run's trainer by replacing a name the trainer's
module calls (`iltpu_torch.trainer.<name>`), and undone after.

The shared ones, of the SAC update and the ring, which every algorithm
has:

- `control`: the plain reference in the kernels' place, its products in
  TF32 (the nearest precision below the configuration's float32 with TF32
  off); each algorithm's adapter adds its own kernels' part;
- `sac_unchanged`: a step that returns its state unchanged (the kernel
  runs, its writes are taken back);
- `sac_half`: half of the batch left out, the mean taken over the rest;
- `ring_altered`: an answer altered where it is produced: one reward of
  every env step changed as the ring appends it;
- `reward_altered`: one reward of every update's batch changed on its way
  into the SAC step.

Each adapter of `algorithms/` adds its own (`FAULTS`, `patches`). The
exchange between chips has no fault here: every cell runs on one card.
"""

import contextlib
from typing import Callable, Dict

import torch

from portbench import algorithms
from portbench.reference import sac as ref_sac

SHARED = ("control", "sac_unchanged", "sac_half", "ring_altered", "reward_altered")


@contextlib.contextmanager
def tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _leaves(st: Dict):
    out = []
    for v in st.values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, list):
            out += [x for x in v if isinstance(x, torch.Tensor)]
    return out


def taken_back(fn, states: int = 1):
    """`fn(h..., st..., *args)` with its `states` state dicts (after as many
    hyperparameter arguments) put back as they were after it ran."""
    def step(*args):
        held = [x for st in args[states:2 * states] for x in _leaves(st)]
        keep = [x.clone() for x in held]
        out = fn(*args)
        for x, k in zip(held, keep):
            x.copy_(k)
        return out
    return step


def _shared(name: str, mod) -> Dict[str, Callable]:
    sac = mod.sac_update
    if name == "control":
        def sac_ref(h, st, batch, eps2, eps_new):
            with tf32():
                return ref_sac.sac_step(h, st, batch, eps2, eps_new)["aux"]
        return {"sac_update": sac_ref}
    if name == "sac_unchanged":
        return {"sac_update": taken_back(sac)}
    if name == "sac_half":
        def half(h, st, batch, eps2, eps_new):
            n = batch["states"].shape[0] // 2
            aux = sac(h, st, {k: v[:n].contiguous() for k, v in batch.items()},
                      eps2[:n].contiguous(), eps_new[:n].contiguous())
            return {k: (torch.cat([v, v]) if v.dim() else v) for k, v in aux.items()}
        return {"sac_update": half}
    if name == "ring_altered":
        append = mod.replay_append_batch

        def altered(rs, step, states, actions, rewards, *rest, **kw):
            rewards = rewards.clone()
            rewards[0] += 1.0
            return append(rs, step, states, actions, rewards, *rest, **kw)
        return {"replay_append_batch": altered}
    if name == "reward_altered":
        def altered(h, st, batch, eps2, eps_new):
            batch = dict(batch)
            batch["rewards"] = batch["rewards"].clone()
            batch["rewards"][0] += 1.0
            return sac(h, st, batch, eps2, eps_new)
        return {"sac_update": altered}
    return {}


def _patches(name: str, mod) -> Dict[str, Callable]:
    out = _shared(name, mod)
    for alg in algorithms.names():
        out.update(algorithms.adapter(alg).patches(name, mod))
    if not out:
        raise ValueError(f"no fault {name!r}")
    return out


NAMES = SHARED + tuple(f for alg in algorithms.names() for f in algorithms.adapter(alg).FAULTS)


@contextlib.contextmanager
def planted(name: str):
    """Run the body with `name` planted under the trainer's module."""
    from iltpu_torch import trainer as mod

    patches = _patches(name, mod)
    old = {k: getattr(mod, k) for k in patches}
    for k, v in patches.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)
