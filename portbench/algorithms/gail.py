"""GAIL's adapter (`algorithm=GAIL`): the discriminator with its reward head,
stepped before the SAC update, by the GAIL kernel one update at a time or,
on the K-blocked path (`training.update_block=K`), with K SAC updates in
one launch of the K-blocked kernel. The interface is `algorithms/__init__.py`'s.

The trainer's discriminator state: p [W1, b1, W2, b2], m and v (AdamW
moments), sn (spectral-norm vectors, or []), t (clock).

Its faults, beside the shared ones of `faults.py`:

- `control` (its part): the plain GAIL step, and the K-step chain of plain
  GAIL and SAC steps in the K-blocked kernel's place, products in TF32;
- `gail_unchanged`, `kblock_unchanged`: the step (the unit) taken back;
- `gail_half`, `kblock_half`: half of the batch left out, the mean taken
  over the rest.
"""

from typing import Dict, List

import torch

from portbench.reference import gail as ref_gail
from portbench.reference import sac as ref_sac
from portbench.work import gail_update
from portbench.work import step as step_work

PARAMS, MOMENT = "p", "m"
FAULTS = ("gail_unchanged", "gail_half", "kblock_unchanged", "kblock_half")


def state(trainer) -> Dict[str, List[torch.Tensor]]:
    d = trainer.disc_state
    return {"p": d["p"], "m": d["m"], "sn": d["sn"]}


def nets(trainer):
    d = trainer.disc_state
    return {"disc": [tuple(x.shape) for x in d["p"]]}, (("disc",) if d["sn"] else ())


def installed(st: Dict, w: Dict) -> list:
    return [(st["p"], w["disc"]), (st["sn"], w["sn"])]


def setup(run) -> None:
    pass


def closed(run) -> None:
    pass


def start(run, w: Dict) -> list:
    return installed(run.state_before, w)


def facts(trainer) -> Dict:
    cfg = trainer.cfg
    return {"Hd": cfg.imitation.discriminator.hidden_size,
            "mixup": cfg.imitation.loss_function == "Mixup", "sn": bool(trainer.disc_state["sn"])}


def hyper(cfg) -> Dict:
    i = cfg.imitation
    return dict(grad_penalty=float(i.grad_penalty), lr=float(i.learning_rate),
                weight_decay=float(i.weight_decay),
                reward_function=i.discriminator.reward_function,
                loss_function=i.loss_function, entropy_bonus=float(i.entropy_bonus))


def init(w: Dict, run) -> Dict:
    return ref_gail.init_state(w["disc"], w["sn"])


def step(h: Dict, st: Dict, tb: Dict, eb: Dict, nz: Dict) -> Dict:
    return ref_gail.gail_step(ref_gail.GAILHyper(**h), st, eb["states"], eb["actions"],
                              eb["weights"], tb["states"], tb["actions"], tb["weights"],
                              nz["eps_gp"], nz.get("mix"))


def loss(aux: Dict) -> torch.Tensor:
    return aux["discriminator_loss"]


def ref_loss(out: Dict, sac_out: Dict) -> float:
    return float(out["loss"][0])


def numbers(run, w: Dict, facts: Dict, config: Dict, ref: Dict) -> Dict:
    return {}


# ------------------------------------------------------------------ faults

def _kblock_chain(sh, gh, sac_st, disc_st, batches, expert, noise):
    """K x (plain GAIL step -> plain SAC step) in place, in TF32: the
    K-blocked kernel's control. Returns its last micro-update's aux."""
    from portbench import faults

    mix = noise.get("mix")
    with faults.tf32():
        for k in range(batches["states"].shape[0]):
            tb = {key: v[k] for key, v in batches.items()}
            g = ref_gail.gail_step(gh, disc_st, expert["states"][k], expert["actions"][k],
                                   expert["weights"][k], tb["states"], tb["actions"],
                                   tb["weights"], noise["eps_gp"][k],
                                   None if mix is None else mix[k])
            tb["rewards"] = g["rewards"]
            s = ref_sac.sac_step(sh, sac_st, tb, noise["eps2"][k], noise["eps_new"][k])
    return {"loss": g["loss"], "rewards": g["rewards"], **s["aux"]}


def patches(name: str, mod) -> Dict:
    from portbench import faults  # which lists every adapter's faults

    gail, kblock = mod.gail_update, mod.kblock_update
    if name == "control":
        def gail_ref(h, st, *args):
            with faults.tf32():
                out = ref_gail.gail_step(h, st, *args)
            return out["loss"], out["rewards"]
        return {"gail_update": gail_ref, "kblock_update": _kblock_chain}
    if name == "gail_unchanged":
        return {"gail_update": faults.taken_back(gail)}
    if name == "kblock_unchanged":
        return {"kblock_update": faults.taken_back(kblock, states=2)}
    if name == "gail_half":
        def half(h, st, *args):
            n = args[0].shape[0] // 2
            cut = [a if a is None else a[:n].contiguous() for a in args]
            d_loss, rewards = gail(h, st, *cut)
            return d_loss, torch.cat([rewards, rewards])
        return {"gail_update": half}
    if name == "kblock_half":
        def half(sh, gh, sac_st, disc_st, *batches):
            n = batches[0]["states"].shape[1] // 2
            out = kblock(sh, gh, sac_st, disc_st,
                         *({k: v[:, :n].contiguous() for k, v in d.items()} for d in batches))
            return {k: (torch.cat([v, v]) if k != "loss" and v.dim() else v) for k, v in out.items()}
        return {"kblock_update": half}
    return {}


# ------------------------------------------------------------- trace run

def probe(run) -> None:
    """Keep the penalty's rows and the first layer of the discriminator
    before the next update (a unit's first micro-update), for the count of
    its active units."""
    t = run.trainer
    update, update_unit = t.update, t.update_unit

    def keep(tb, eb, nz):
        p = t.disc_state["p"]
        gx = (nz["eps_gp"][:, None] * torch.cat([eb["states"], eb["actions"]], 1)
              + (1 - nz["eps_gp"][:, None]) * torch.cat([tb["states"], tb["actions"]], 1))
        run.probe = (gx.clone(), p[0].detach().clone(), p[1].detach().clone())
        for hook in ("update", "update_unit"):
            t.__dict__.pop(hook, None)

    def once(s, tb, eb, nz):
        keep(tb, eb, nz)
        return update(s, tb, eb, nz)

    def once_unit(s, tb, eb, nz):
        keep(*({k: v[0] for k, v in d.items()} for d in (tb, eb, nz)))
        return update_unit(s, tb, eb, nz)

    t.update, t.update_unit = once, once_unit


def context(run) -> Dict:
    """`gail_active`: the active share of the penalty's rows."""
    return {"gail_active": None if run.probe is None else gail_update.active_share(*run.probe)}


def update_flops(ctx):
    f, active = ctx["facts"], ctx.get("gail_active")
    if active is None:
        return None
    return step_work.flops(f["S"], f["A"], f["B"], f["H"], f["Hd"], active, f["mixup"])
