"""SAC's adapter (`algorithm=SAC`): no reward model; the SAC update trains on
the env's rewards as the ring holds them. The interface is
`algorithms/__init__.py`'s.

`loss_gap` reads the mean over the batch of the update's Q-values (the
smaller twin's, before the step), the SAC kernel's one number of the
critic: it returns no critic loss.
"""

from typing import Dict

import torch

from portbench.work import sac_update

PARAMS = MOMENT = None
FAULTS = ()


def state(trainer) -> Dict:
    return {}


def nets(trainer):
    return {}, ()


def installed(st: Dict, w: Dict) -> list:
    return []


def setup(run) -> None:
    pass


def closed(run) -> None:
    pass


def start(run, w: Dict) -> list:
    return []


def facts(trainer) -> Dict:
    return {}


def hyper(cfg) -> Dict:
    return {}


def init(w: Dict, run):
    return None


def step(h: Dict, st, tb: Dict, eb: Dict, nz: Dict) -> Dict:
    return {"rewards": None, "grads": []}


def loss(aux: Dict) -> torch.Tensor:
    return aux["Q_values"].mean()


def ref_loss(out: Dict, sac_out: Dict) -> float:
    return float(sac_out["aux"]["Q_values"].mean())


def numbers(run, w: Dict, facts: Dict, config: Dict, ref: Dict) -> Dict:
    return {}


def patches(name: str, mod) -> Dict:
    return {}


def probe(run) -> None:
    pass


def context(run) -> Dict:
    return {}


def update_flops(ctx):
    f = ctx["facts"]
    return sac_update.flops(f["S"], f["A"], f["B"], f["H"])
