"""DRIL's adapter (`algorithm=DRIL`): a 5-member MC-dropout ensemble of the
actor's shape, trained by behavioural cloning in set-up
(`Trainer.pretrain_discriminator`: `imitation.pretraining.iterations`
steps on expert batches, then the threshold, a quantile of the expert
rows' uncertainty), and frozen after: an update's reward is +1 where the
members' variance of pi(a | s) is at most the threshold, else -1, on the
update's own keep-masks (`dril_mask<k>`). The configuration's
`imitation.bc_aux_loss` adds the BC auxiliary step before the SAC update;
the check follows it for every algorithm (`correct.py`). The interface is
`algorithms/__init__.py`'s.

What set-up trains is checked apart: the harness's wrappers on the
trainer's `pretrain_discriminator` and `_expert_batch`, on the ensemble's
`uncertainty_threshold` and on its network's `draw_masks` keep the
ensemble's state when pretraining starts (the start check compares it
with the benchmark's weights, zero moments and clock), the first
`PRETRAIN_STEPS` expert batches and keep-masks with the state after them,
the threshold's keep-masks, and the state and threshold when set-up ends.
The reference follows the updates from that end state and threshold, and
adds four numbers (`numbers`):

- `pretrain_steps_wrong`: |the ensemble's AdamW clock after set-up -
  `imitation.pretraining.iterations`|, exact;
- `pretrain_gap`: the first `PRETRAIN_STEPS` pretraining steps from the
  benchmark's weights on the batches and masks the program drew, the gap
  of the median leaf's change (`correct.norm_gap`);
- `threshold_gap`: |the program's threshold - the reference's quantile|
  over the latter, from the ensemble after set-up, the expert rows of the
  file and the masks the program drew for them;
- `reward_rows_wrong`: the rows whose +-1 reward differs from the
  reference's, over the checked units and the loop's last iteration, which
  runs after the window's close (`closed` keeps its reward calls on the
  host): early rows lie below the threshold nearly all, where a reward
  without dropout (+1) reads the same.

`loss_gap` reads the mean over the batch of the update's Q-values, as
`sac.py` does: the update returns no loss of its own.

Its faults, beside the shared ones of `faults.py`:

- `control` (its part): the BC step (auxiliary and pretraining) and the
  reward and threshold by the reference, in TF32;
- `bc_aux_skipped`: no BC auxiliary step; `bc_aux_half`: the auxiliary
  step on half of the expert rows;
- `dril_masks_unused`: the reward computed without dropout;
- `dril_threshold_off`: the threshold halved;
- `pretrain_short`: a tenth of the pretraining iterations.
"""

import os
from typing import Dict, List

import numpy as np
import torch

from portbench import correct
from portbench.reference import bc as ref_bc
from portbench.reference import dril as ref_dril
from portbench.reference import rows as ref_rows
from portbench.work import dril as dril_work

PARAMS = MOMENT = None  # the ensemble trains in set-up only
FAULTS = ("bc_aux_skipped", "bc_aux_half", "dril_masks_unused", "dril_threshold_off",
          "pretrain_short")
PRETRAIN_STEPS = 3  # pretraining steps the reference follows


def state(trainer) -> Dict[str, List[torch.Tensor]]:
    return {"ens": trainer.disc_state["p"], "thr": [trainer.dril_threshold]}


def nets(trainer):
    return {"ens": [tuple(x.shape) for x in trainer.disc_state["p"]]}, ()


def installed(st: Dict, w: Dict) -> list:
    return [(st["ens"], w["ens"])]


def _snapshot(d: Dict) -> Dict:
    return {"p": [x.detach().clone() for x in d["p"]], "m": [x.clone() for x in d["m"]],
            "v": [x.clone() for x in d["v"]], "t": d["t"].clone()}


def setup(run) -> None:
    """Wrappers on the trainer's pretraining, kept in `run.setup` and taken
    off when it ends."""
    t = run.trainer
    disc, net = t.disc, t.disc.net
    cap = run.setup
    cap.update(batches=[], masks=[], thr_masks=None, phase=None)
    pretrain, expert_batch = t.pretrain_discriminator, t._expert_batch
    threshold, draw = disc.uncertainty_threshold, net.draw_masks

    def pretrain_hook():
        cap["start"] = _snapshot(t.disc_state)
        cap["phase"] = "pretrain"
        try:
            return pretrain()
        finally:
            cap["phase"] = None
            cap["end"] = _snapshot(t.disc_state)
            cap["threshold"] = t.dril_threshold.detach().clone()
            for obj, name in ((t, "pretrain_discriminator"), (t, "_expert_batch"),
                              (disc, "uncertainty_threshold"), (net, "draw_masks")):
                obj.__dict__.pop(name, None)

    def batch_hook():
        n = len(cap["batches"])
        if cap["phase"] == "pretrain" and n == PRETRAIN_STEPS and "after" not in cap:
            cap["after"] = _snapshot(t.disc_state)
        b = expert_batch()
        if cap["phase"] == "pretrain" and n < PRETRAIN_STEPS:
            cap["batches"].append({k: v.detach().clone() for k, v in b.items()})
        return b

    def threshold_hook(*args, **kw):
        cap["phase"] = "threshold"
        try:
            return threshold(*args, **kw)
        finally:
            cap["phase"] = "pretrain"

    def draw_hook(rows, generator):
        m = draw(rows, generator)
        kept = lambda: [None if x is None else x.clone() for x in m]
        if cap["phase"] == "threshold":
            cap["thr_masks"] = kept()
        elif cap["phase"] == "pretrain" and len(cap["masks"]) < len(cap["batches"]):
            cap["masks"].append(kept())
        return m

    t.pretrain_discriminator, t._expert_batch = pretrain_hook, batch_hook
    disc.uncertainty_threshold, net.draw_masks = threshold_hook, draw_hook


def closed(run) -> None:
    """Keep, on the host, the inputs and the +-1 output of each reward call
    of the loop's last iteration."""
    disc = run.trainer.disc
    reward, kept = disc.dril_reward, run.setup.setdefault("closing", [])

    def hook(state, action, threshold, masks=None, generator=None):
        out = reward(state, action, threshold, masks, generator)
        kept.append({"states": state.cpu(), "actions": action.cpu(), "rewards": out.cpu(),
                     "masks": [None if m is None else m.cpu() for m in masks]})
        return out

    disc.dril_reward = hook


def start(run, w: Dict) -> list:
    """The ensemble's state when pretraining starts: the benchmark's weights,
    zero moments and clock."""
    s = run.setup["start"]
    zeros = lambda xs: [torch.zeros_like(x) for x in xs]
    return [(s["p"], w["ens"]), (s["m"], zeros(s["m"])), (s["v"], zeros(s["v"])),
            ([s["t"]], [torch.zeros_like(s["t"])])]


def facts(trainer) -> Dict:
    return {"ensemble": [tuple(x.shape) for x in trainer.disc_state["p"][0::2]]}


def hyper(cfg) -> Dict:
    i, d = cfg.imitation, cfg.imitation.discriminator
    return dict(rates=[float(d.input_dropout)] + [float(d.dropout)] * int(d.depth),
                activation=d.activation, lr=float(i.learning_rate),
                weight_decay=float(i.weight_decay), iterations=int(i.pretraining.iterations),
                quantile=float(i.quantile_cutoff))


def init(w: Dict, run) -> Dict:
    """The ensemble and threshold as the program held them before its first
    update (what set-up made of the weights)."""
    b = run.state_before
    return {"ens": [x.clone() for x in b["ens"]], "thr": b["thr"][0].clone()}


def _masks(nz: Dict, n: int) -> list:
    return [nz.get(f"dril_mask{k}") for k in range(n)]


def step(h: Dict, st: Dict, tb: Dict, eb: Dict, nz: Dict) -> Dict:
    u = ref_dril.uncertainty(st["ens"], tb["states"], tb["actions"],
                             _masks(nz, len(st["ens"]) // 2), h["rates"], h["activation"])
    return {"rewards": ref_dril.reward(u, st["thr"]), "grads": []}


def loss(aux: Dict) -> torch.Tensor:
    return aux["Q_values"].mean()


def ref_loss(out: Dict, sac_out: Dict) -> float:
    return float(sac_out["aux"]["Q_values"].mean())


def _expert(config: Dict, facts: Dict, device):
    path = os.path.join(correct.HERE, os.pardir, config["expert_file"])
    with np.load(path) as f:
        rows = ref_rows.expert_rows({k: f[k] for k in f.files}, facts["trajectories"],
                                    facts["absorbing"])
    S, A = facts["S"], facts["A"]
    rows = torch.as_tensor(rows, device=device)
    return rows[:, :S], rows[:, S:S + A]


def numbers(run, w: Dict, facts: Dict, config: Dict, ref: Dict) -> Dict:
    h, cap = facts["hyper"]["model"], run.setup
    end = cap["end"]
    steps_wrong = abs(int(end["t"].item()) - h["iterations"])

    st = ref_bc.opt_state(w["ens"])
    for b, m in zip(cap["batches"], cap["masks"]):
        ref_bc.bc_step(st, b["states"], b["actions"], b["weights"], h["lr"], h["weight_decay"],
                       h["activation"], m, h["rates"])
    after = cap.get("after", end)["p"]
    prog = [y - x for x, y in zip(cap["start"]["p"], after)]
    want = [y - x for x, y in zip(w["ens"], st["p"])]
    pretrain = correct.norm_gap(prog, want)["median"]

    states, actions = _expert(config, facts, end["p"][0].device)
    masks = cap["thr_masks"]
    if masks is None or any(m is not None and m.shape[1] != states.shape[0] for m in masks):
        thr_gap = float("inf")  # no threshold drawn, or over other rows than the file's
    else:
        u = ref_dril.uncertainty(end["p"], states, actions, masks, h["rates"], h["activation"])
        q = ref_dril.quantile(u, h["quantile"])
        thr_gap = float((cap["threshold"] - q).abs() / q.abs().clamp_min(1e-30))

    wrong = 0
    for rec, out in zip(run.captured[run.lead:], ref["outs"]):
        wrong += int((rec["rewards"] != out["rewards"]).sum())
    st = init(w, run)
    dev = st["thr"].device
    for c in cap.get("closing", []):
        u = ref_dril.uncertainty(st["ens"], c["states"].to(dev), c["actions"].to(dev),
                                 [None if m is None else m.to(dev) for m in c["masks"]],
                                 h["rates"], h["activation"])
        wrong += int((ref_dril.reward(u, st["thr"]).cpu() != c["rewards"]).sum())
    return {"pretrain_steps_wrong": steps_wrong, "pretrain_gap": pretrain,
            "threshold_gap": thr_gap, "reward_rows_wrong": wrong}


# ------------------------------------------------------------------ faults

def _rates(net) -> list:
    """The dropout rate before each of the program's network's layers."""
    return [net.input_dropout] + [net.dropout] * (net.n_layers - 1)


def _control_bc(bc):
    """`behavioural_cloning_update` by the reference, in TF32, with the masks
    the program would draw."""
    from portbench import faults

    def step(actor, opt_state, batch, *, lr, weight_decay, masks=None, generator=None,
             train_dropout=False, mesh=None):
        net = actor.net
        if train_dropout and masks is None and generator is not None:
            masks = net.draw_masks(batch["states"].shape[:-1], generator)
        with faults.tf32():
            out = ref_bc.bc_step(opt_state, batch["states"], batch["actions"], batch["weights"],
                                 lr, weight_decay, net.activation,
                                 masks if train_dropout else None, _rates(net))
        return out["loss"]
    return step


def _uncertainty_tf32(actor, states, actions, masks, generator):
    from portbench import faults

    net = actor.net
    if masks is None:
        masks = actor.ensemble_masks(states.shape[0], generator)
    with faults.tf32():
        return ref_dril.uncertainty(net.leaves(), states, actions, masks, _rates(net),
                                    net.activation)


def patches(name: str, mod) -> Dict:
    base = mod.SoftActor
    bc = mod.behavioural_cloning_update
    actor = lambda **methods: {"SoftActor": type(f"SoftActor_{name}", (base,), methods)}

    def aux_only(fn):
        """`fn` in the per-update auxiliary step's place (the call that passes
        `mesh`), the pretraining's calls as they were."""
        def call(actor_, opt_state, batch, **kw):
            return (fn if "mesh" in kw else bc)(actor_, opt_state, batch, **kw)
        return call

    if name == "control":
        def threshold(self, s, a, q, masks=None, generator=None):
            return ref_dril.quantile(_uncertainty_tf32(self, s, a, masks, generator), q)

        def reward(self, s, a, thr, masks=None, generator=None):
            return ref_dril.reward(_uncertainty_tf32(self, s, a, masks, generator), thr)
        return {"behavioural_cloning_update": _control_bc(bc),
                **actor(uncertainty_threshold=threshold, dril_reward=reward)}
    if name == "bc_aux_skipped":
        return {"behavioural_cloning_update": aux_only(lambda *a, **kw: None)}
    if name == "bc_aux_half":
        def half(actor_, opt_state, batch, **kw):
            n = batch["states"].shape[0] // 2
            return bc(actor_, opt_state, {k: v[:n] for k, v in batch.items()}, **kw)
        return {"behavioural_cloning_update": aux_only(half)}
    if name == "dril_masks_unused":
        def reward(self, s, a, thr, masks=None, generator=None):
            probs = torch.exp(self.log_prob(s, a)).expand(dril_work.MEMBERS, -1)
            return torch.where(torch.var(probs, 0, correction=1) <= thr, 1.0, -1.0)
        return actor(dril_reward=reward)
    if name == "dril_threshold_off":
        def threshold(self, *args, **kw):
            return 0.5 * base.uncertainty_threshold(self, *args, **kw)
        return actor(uncertainty_threshold=threshold)
    if name == "pretrain_short":
        class Short(mod.Trainer):
            def pretrain_discriminator(self):
                p = self.cfg["imitation"]["pretraining"]
                n = p["iterations"]
                p["iterations"] = max(1, n // 10)
                try:
                    return super().pretrain_discriminator()
                finally:
                    p["iterations"] = n
        return {"Trainer": Short}
    return {}


# ------------------------------------------------------------- trace run

def probe(run) -> None:
    pass


def context(run) -> Dict:
    return {}


def update_flops(ctx):
    f = ctx["facts"]
    return dril_work.flops(f["S"], f["A"], f["B"], f["H"], f["ensemble"])
