"""What must make `correct` come out false: the control and the planted
faults, each put under a run's trainer by replacing a name the trainer's
module calls (`iltpu_torch.trainer.<name>`), and undone after.

- `control`: the plain reference in the kernels' place, its products in
  TF32 (the nearest precision below the configuration's float32 with TF32
  off);
- `sac_unchanged`, `gail_unchanged`: a step that returns its state
  unchanged (the kernel runs, its writes are taken back);
- `sac_half`, `gail_half`: half of the batch left out, the mean taken over
  the rest;
- `ring_altered`: an answer altered where it is produced: one reward of
  every env step changed as the ring appends it;
- `reward_altered`: one reward of every update's batch changed between the
  GAIL step and the SAC step.

The exchange between chips has no fault here: every cell runs on one card.
"""

import contextlib
from typing import Callable, Dict

import torch

from portbench.reference import gail as ref_gail
from portbench.reference import sac as ref_sac


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


def _taken_back(fn):
    def step(h, st, *args):
        keep = [x.clone() for x in _leaves(st)]
        out = fn(h, st, *args)
        for x, k in zip(_leaves(st), keep):
            x.copy_(k)
        return out
    return step


def _patches(name: str, mod) -> Dict[str, Callable]:
    sac, gail = mod.sac_update, mod.gail_update
    if name == "control":
        def sac_ref(h, st, batch, eps2, eps_new):
            with tf32():
                return ref_sac.sac_step(h, st, batch, eps2, eps_new)["aux"]

        def gail_ref(h, st, *args):
            with tf32():
                out = ref_gail.gail_step(h, st, *args)
            return out["loss"], out["rewards"]
        return {"sac_update": sac_ref, "gail_update": gail_ref}
    if name == "sac_unchanged":
        return {"sac_update": _taken_back(sac)}
    if name == "gail_unchanged":
        return {"gail_update": _taken_back(gail)}
    if name == "sac_half":
        def half(h, st, batch, eps2, eps_new):
            n = batch["states"].shape[0] // 2
            aux = sac(h, st, {k: v[:n].contiguous() for k, v in batch.items()},
                      eps2[:n].contiguous(), eps_new[:n].contiguous())
            return {k: (torch.cat([v, v]) if v.dim() else v) for k, v in aux.items()}
        return {"sac_update": half}
    if name == "gail_half":
        def half(h, st, *args):
            n = args[0].shape[0] // 2
            cut = [a if a is None else a[:n].contiguous() for a in args]
            loss, rewards = gail(h, st, *cut)
            return loss, torch.cat([rewards, rewards])
        return {"gail_update": half}
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
    raise ValueError(f"no fault {name!r}")


NAMES = ("control", "sac_unchanged", "gail_unchanged", "sac_half", "gail_half", "ring_altered",
         "reward_altered")


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
