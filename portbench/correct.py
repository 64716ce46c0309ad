"""How `correct` is decided for a training cell.

Set-up drives the trainer it hands to the window through its first updates
(the host loop's own call and feed); the plain reference follows them from
the benchmark's weights, on the batches and draws the program sampled for
them, micro-update by micro-update: every unit up to the third of the size
the window runs (one update, or K on the K-blocked path), the lead before
those three included (`harness.Run`). Compared over those three checked
units, each against its limit:

- `loss_gap`: the loss the algorithm's adapter names (its reward model's,
  or SAC's own number) as each unit returned it (its last micro-update's), its
  gap relative to the reference's, the median of the three;
- `grad_gap`: each leaf's first gradient as its optimiser got it, worked
  out from its AdamW first moment after the first checked unit, m / (1 -
  b1), against the reference's gradient where that unit is the run's
  first update alone and no BC auxiliary step comes before its SAC step,
  else against the reference's moment after the same micro-updates (with
  the BC step the actor's moment holds b1 g_bc + g_sac on both sides):
  the widest gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, the larger;
- `change_gap`: the same gap of each leaf's change over the three units
  (critic, target critic, actor, log alpha, the adapter's trained leaves),
  the median leaf's, leaving out leaves whose reference gradient (as
  above) is under a thousandth of the median leaf's (they move by
  round-off alone).

and exactly (limit 0) what the reference skips by following the program's
batches: `start_state_gap` (the state before the first update is the
benchmark's weights, zero moments and log alpha 0; a leaf that set-up
trains is compared where its training starts, as the adapter's `start`
gives it), `batch_rows_unknown`
(policy rows that are no row of the ring as it stood),
`expert_rows_unknown` (expert rows that are no row of the first
trajectories of the expert file), and `ring_rows_wrong`: the ring's rows
from the window's first iteration on, against the rows the stepper's
outputs give with the absorbing wrap, and where its write index ended.

The loss and the change are taken at the median unit and leaf, not the
widest: a relu unit or a penalty row whose pre-activation lies within
rounding of zero switches the other way in one of the two, which moves one
step's loss or one leaf's later change by ~1e-5 (the gradient penalty and
relu derivatives are not continuous there, and Adam carries a near-zero
gradient's sign into a whole step of the learning rate), on some seeds
(PERF.md gives the readings). The widest of each stays in `detail`.

The configuration's `imitation.bc_aux_loss` (any algorithm) puts the
BC auxiliary step on the SAC actor's own AdamW state (a, am, av and its
clock ta) before each SAC step, on the update's expert batch, with SAC's
learning rate and weight decay, in the program and in the reference
(`reference/bc.py`). Where set-up trains the adapter's state (a reward
model pretrained there), the reference starts from that state as the
program held it before its first update (the adapter's `init`), and the
adapter's `numbers` check set-up's work apart: each number under its own
name, with its limit in the cell's limits file beside the three graded
ones.

A cell's limits are `limits/<config>.<traffic>.json` where that file is,
else `limits/<config>.json`.
"""

import json
import os
from typing import Dict, List

import numpy as np
import torch

from portbench import algorithms
from portbench.reference import bc as ref_bc
from portbench.reference import rows as ref_rows
from portbench.reference import sac as ref_sac

HERE = os.path.dirname(os.path.abspath(__file__))
EXACT = ("start_state_gap", "batch_rows_unknown", "expert_rows_unknown", "ring_rows_wrong")
GRADED = ("loss_gap", "grad_gap", "change_gap")
FLOOR = 1e-3  # leaves under this share of the median leaf's gradient move by round-off


def limits_of(config_name: str, traffic_name: str) -> Dict[str, float]:
    path = os.path.join(HERE, "limits", f"{config_name}.{traffic_name}.json")
    if not os.path.exists(path):
        path = os.path.join(HERE, "limits", f"{config_name}.json")
    with open(path) as f:
        lim = json.load(f)["limits"]
    return {**lim, **{k: 0 for k in EXACT}}


def hyper_of(cfg) -> Dict:
    """The reference's hyperparameters, read from the configuration."""
    r, t = cfg.reinforcement, cfg.training
    return {
        "bc_aux": bool(cfg.imitation.get("bc_aux_loss")),
        "sac": dict(lr=float(t.learning_rate), weight_decay=float(t.weight_decay),
                    alpha_lr=float(t.learning_rate), discount=float(r.discount),
                    target_temperature=float(r.target_temperature), polyak=float(r.polyak_factor),
                    min_alpha=float(r.get("min_alpha", 0.0) or 0.0)),
        "model": algorithms.adapter(cfg.algorithm).hyper(cfg),
    }


def window_ring(run, replay) -> Dict:
    """The ring's rows from the window's first iteration to the loop's end,
    and the rows the reference makes of the stepper's outputs for them."""
    first, last = run.calls0, run.step1 // run.N
    calls = run.calls[first:last + 1]
    want = ref_rows.ring_rows(calls, [k * run.N + 1 for k in range(first, last + 1)],
                              replay.absorbing)
    n = len(want["step"])
    where = torch.as_tensor((run.idx0 + np.arange(n)) % replay.size, device=replay.idx.device)
    got = {k: getattr(replay, k)[where] for k in ref_rows.COLUMNS}
    return {"want": ring_matrix(want), "got": ring_matrix(got), "idx_end": int(replay.idx),
            "idx_want": (run.idx0 + n) % replay.size, "calls": len(calls),
            "iterations": last - first + 1}


def ring_matrix(cols: Dict) -> np.ndarray:
    """Ring columns (tensors or arrays) -> one float32 (rows, features)
    matrix, in `rows.COLUMNS` order."""
    parts = []
    for k in ref_rows.COLUMNS:
        x = cols[k]
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        parts.append(x.reshape(x.shape[0], -1).astype(np.float32))
    return np.concatenate(parts, 1)


def _norms(leaves: List[torch.Tensor]) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(x.double())) for x in leaves])


def _split(state: Dict, keys) -> List[torch.Tensor]:
    """Leaves in a fixed order, each twin of the critic leaves apart."""
    out = []
    for k in keys:
        for x in state[k]:
            out += [x[0], x[1]] if k in ("c", "cm", "t") else [x]
    return out


def norm_gap(prog: List[torch.Tensor], ref: List[torch.Tensor], keep=None) -> Dict:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), median leaf
    norm), over the leaves `keep` allows: the widest, the median leaf's,
    and each leaf's reading (0 for a leaf left out)."""
    p, r = _norms(prog), _norms(ref)
    keep = np.ones(len(r), bool) if keep is None else np.asarray(keep)
    scale = np.maximum(r, np.median(r[keep]))
    gaps = np.abs(p - r) / np.where(scale > 0, scale, 1.0)
    gaps[~keep] = 0.0
    return {"widest": float(gaps.max()), "median": float(np.median(gaps[keep])),
            "leaves": gaps.tolist()}


def _ref_leaves(model, sac: Dict, st, moment: bool = False) -> Dict:
    """The reference's leaves by the keys the check reads: the parameters
    (a, c, t, la and the adapter's `PARAMS`), or their first moments (a, c,
    la and the adapter's, under the same keys)."""
    if moment:
        out = {"a": sac["am"], "c": sac["cm"], "la": [sac["lam"]]}
    else:
        out = {"a": sac["a"], "c": sac["c"], "t": sac["t"], "la": [sac["la"]]}
    if model.PARAMS:
        out[model.PARAMS] = st[model.MOMENT if moment else model.PARAMS]
    return out


def reference_steps(run, w: Dict, facts: Dict, device) -> Dict:
    """The reference's micro-updates from the benchmark's weights (and the
    adapter's start) on the program's batches and draws, every captured
    unit in order: the loss and the adapter's step output of each checked
    unit, the first gradients, the state before the first checked unit and
    after the third."""
    h = facts["hyper"]
    model = algorithms.adapter(facts["algorithm"])
    sh = ref_sac.SACHyper(lr=h["sac"]["lr"], weight_decay=h["sac"]["weight_decay"],
                          alpha_lr=h["sac"]["alpha_lr"], discount=h["sac"]["discount"],
                          entropy_target=h["sac"]["target_temperature"] * facts["A"],
                          polyak=h["sac"]["polyak"], min_alpha=h["sac"]["min_alpha"])
    sac = ref_sac.init_state(w["actor"], w["critic"])
    st = model.init(w, run)
    bc = {"p": sac["a"], "m": sac["am"], "v": sac["av"], "t": sac["ta"]} if h["bc_aux"] else None
    losses, outs, grads, before = [], [], None, None
    for i, rec in enumerate(run.captured):
        if i == run.lead:
            before = {k: [x.clone() for x in v] for k, v in _ref_leaves(model, sac, st).items()}
        tb, eb, nz = rec["tb"], rec["eb"], rec["nz"]
        K = tb["states"].shape[0]
        for k in range(K):
            pick = lambda d: {key: v[k] for key, v in d.items()}
            out = model.step(h["model"], st, pick(tb), pick(eb), pick(nz))
            batch = pick(tb)
            if out["rewards"] is not None:
                batch["rewards"] = out["rewards"]
            if bc is not None:
                e = pick(eb)
                ref_bc.bc_step(bc, e["states"], e["actions"], e["weights"], h["sac"]["lr"],
                               h["sac"]["weight_decay"])
            s = ref_sac.sac_step(sh, sac, batch, nz["eps2"][k], nz["eps_new"][k])
        if i >= run.lead:
            losses.append(model.ref_loss(out, s))
            outs.append(out)
        if i == run.lead == 0 and K == 1 and bc is None:  # the run's first update: its gradients
            grads = {"a": s["grads"]["a"], "c": s["grads"]["c"], "la": s["grads"]["la"]}
            if model.PARAMS:
                grads[model.PARAMS] = out["grads"]
        elif i == run.lead:  # else the moments after the unit, as gradients
            grads = {k: [x / (1.0 - ref_sac.ADAM_B1) for x in v]
                     for k, v in _ref_leaves(model, sac, st, moment=True).items()}
    return {"losses": losses, "outs": outs, "grads": grads, "before": before,
            "state": _ref_leaves(model, sac, st)}


def graded(run, facts: Dict, ref: Dict) -> Dict:
    """The three graded numbers, with each leaf's reading."""
    b1 = ref_sac.ADAM_B1
    model = algorithms.adapter(facts["algorithm"])
    P, M = model.PARAMS, model.MOMENT
    prog_loss = [float(r["loss"]) for r in run.captured[run.lead:]]
    step_gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_loss, ref["losses"])]
    a1 = run.state_after1
    moments = ("am", "cm", "lam") + ((M,) if M else ())
    prog_grads = [x / (1.0 - b1) for x in _split({k: a1[k] for k in moments}, moments)]
    ref_grads = _split(ref["grads"], ("a", "c", "la") + ((P,) if P else ()))
    grad = norm_gap(prog_grads, ref_grads)

    g_norm = _norms(ref_grads)
    moves = g_norm >= FLOOR * np.median(g_norm)
    n_a, n_c = len(ref["grads"]["a"]), 2 * len(ref["grads"]["c"])
    # change leaves: a, c (split), t (split, as its critic leaf), la, the adapter's
    keep = np.concatenate([moves[:n_a], moves[n_a:n_a + n_c], moves[n_a:n_a + n_c],
                           moves[n_a + n_c:]])
    b, e = run.state_at_check, run.state_after3
    keys = ("a", "c", "t", "la") + ((P,) if P else ())
    prog_change = [y - x for x, y in zip(_split(b, keys), _split(e, keys))]
    ref_change = [y - x for x, y in zip(_split(ref["before"], keys), _split(ref["state"], keys))]
    change = norm_gap(prog_change, ref_change, keep)
    return {"loss_gap": float(np.median(step_gaps)), "grad_gap": grad["widest"],
            "change_gap": change["median"],
            "detail": {"losses": prog_loss, "ref_losses": ref["losses"],
                       "loss_widest_step": max(step_gaps), "grad_median_leaf": grad["median"],
                       "change_widest_leaf": change["widest"], "grad_leaves": grad["leaves"],
                       "change_leaves": change["leaves"], "left_out": int((~keep).sum()),
                       "lead_units": run.lead, "unit": facts["unit"]}}


def _sac_pairs(st: Dict, w: Dict) -> list:
    return [(st["a"], w["actor"]), (st["c"], w["critic"]), (st["t"], w["critic"])]


def installed(st: Dict, w: Dict, model) -> list:
    """(leaves, weights) pairs of a state keyed as `harness.Run._state` keys
    it, or of the trainer's own: actor, critic and its target, then the
    adapter's."""
    return _sac_pairs(st, w) + model.installed(st, w)


def exact(run, ring: Dict, w: Dict, facts: Dict, config: Dict) -> Dict:
    """The four exact numbers."""
    model = algorithms.adapter(facts["algorithm"])
    b = run.state_before
    start = 0.0
    for got, want in _sac_pairs(b, w) + model.start(run, w):
        start = max([start] + [float((x - y).abs().max()) for x, y in zip(got, want)])
    for k in ("am", "cm", "la", "lam") + ((model.MOMENT,) if model.MOMENT else ()):
        start = max([start] + [float(x.abs().max()) for x in b[k]])

    rows = lambda v: v.reshape((-1,) + v.shape[2:])  # a unit's updates, one after another
    tb_rows = np.concatenate([ring_matrix({k: rows(r["tb"][k]) for k in ref_rows.COLUMNS})
                              for r in run.captured])
    batch_unknown = ref_rows.unknown_rows(tb_rows, run.ring_at_capture)

    with np.load(os.path.join(HERE, os.pardir, config["expert_file"])) as f:
        data = {k: f[k] for k in f.files}
    known = ref_rows.expert_rows(data, facts["trajectories"], facts["absorbing"])
    eb_rows = np.concatenate([torch.cat([rows(r["eb"]["states"]), rows(r["eb"]["actions"]),
                                         rows(r["eb"]["weights"])[:, None]], 1).cpu().numpy()
                              for r in run.captured])
    expert_unknown = ref_rows.unknown_rows(eb_rows, known)

    wrong = int((ring["got"] != ring["want"]).any(1).sum())
    wrong += abs(ring["idx_end"] - ring["idx_want"]) + abs(ring["calls"] - ring["iterations"])
    return {"start_state_gap": start, "batch_rows_unknown": batch_unknown,
            "expert_rows_unknown": expert_unknown, "ring_rows_wrong": wrong}


def readings(run, ring: Dict, w: Dict, facts: Dict, config: Dict, device) -> Dict:
    """Every number compared, with the graded ones' detail, the reference
    in float32 with TF32 off; the adapter's own numbers under "model"."""
    model = algorithms.adapter(facts["algorithm"])
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference_steps(run, w, facts, device)
        own = model.numbers(run, w, facts, config, ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return {**exact(run, ring, w, facts, config), **graded(run, facts, ref), "model": own}


def check(run, ring: Dict, w: Dict, facts: Dict, config: Dict, traffic: Dict, device) -> Dict:
    """{name: (value, limit)} of every number compared, and `correct`."""
    r = readings(run, ring, w, facts, config, device)
    lim = limits_of(config["name"], traffic["name"])
    numbers = {k: (r[k], lim[k]) for k in EXACT + GRADED}
    numbers.update({k: (v, lim[k]) for k, v in r["model"].items()})
    return {"numbers": numbers, "detail": r["detail"],
            "correct": all(v <= l for v, l in numbers.values())}
