"""How `correct` is decided for a training cell.

Set-up drives the trainer it hands to the window through its first updates
(the host loop's own call and feed); the plain reference follows the first
three from the benchmark's weights, on the batches and draws the program
sampled for them. Compared, each against its limit:

- `loss_gap`: the discriminator's loss at each of the three steps, each
  step's gap relative to the reference's loss, the median of the three;
- `grad_gap`: each leaf's first gradient as its optimiser got it (the
  program's worked out from its AdamW moment after one step, m / (1 - b1)),
  the widest gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, the larger;
- `change_gap`: the same gap of each leaf's change over the three steps
  (critic, target critic, actor, log alpha, discriminator), the median
  leaf's, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

and exactly (limit 0) what the reference skips by following the program's
batches: `start_state_gap` (the state before the first update is the
benchmark's weights, zero moments and log alpha 0), `batch_rows_unknown`
(policy rows that are no row of the ring as it stood),
`expert_rows_unknown` (expert rows that are no row of the first
trajectories of the expert file), and `ring_rows_wrong`: the ring's rows
from the window's first iteration on, against the rows the stepper's
outputs give with the absorbing wrap, and where its write index ended.

The loss and the change are taken at the median step and leaf, not the
widest: a relu unit or a penalty row whose pre-activation lies within
rounding of zero switches the other way in one of the two, which moves one
step's loss or one leaf's later change by ~1e-5 (the gradient penalty and
relu derivatives are not continuous there, and Adam carries a near-zero
gradient's sign into a whole step of the learning rate), on some seeds
(PERF.md gives the readings). The widest of each stays in `detail`.
"""

import json
import os
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import gail as ref_gail
from portbench.reference import rows as ref_rows
from portbench.reference import sac as ref_sac

HERE = os.path.dirname(os.path.abspath(__file__))
EXACT = ("start_state_gap", "batch_rows_unknown", "expert_rows_unknown", "ring_rows_wrong")
GRADED = ("loss_gap", "grad_gap", "change_gap")
FLOOR = 1e-3  # leaves under this share of the median leaf's gradient move by round-off


def limits_of(config_name: str) -> Dict[str, float]:
    with open(os.path.join(HERE, "limits", f"{config_name}.json")) as f:
        lim = json.load(f)["limits"]
    return {**{k: 0 for k in EXACT}, **{k: lim[k] for k in GRADED}}


def hyper_of(cfg) -> Dict:
    """The reference's hyperparameters, read from the configuration."""
    r, t, i = cfg.reinforcement, cfg.training, cfg.imitation
    return {
        "sac": dict(lr=float(t.learning_rate), weight_decay=float(t.weight_decay),
                    alpha_lr=float(t.learning_rate), discount=float(r.discount),
                    target_temperature=float(r.target_temperature), polyak=float(r.polyak_factor),
                    min_alpha=float(r.get("min_alpha", 0.0) or 0.0)),
        "gail": dict(grad_penalty=float(i.grad_penalty), lr=float(i.learning_rate),
                     weight_decay=float(i.weight_decay),
                     reward_function=i.discriminator.reward_function,
                     loss_function=i.loss_function, entropy_bonus=float(i.entropy_bonus)),
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


def reference_steps(captured: List[Dict], w: Dict, facts: Dict, device) -> Dict:
    """The reference's three steps from the benchmark's weights on the
    program's batches and draws: losses, first gradients, state after
    three."""
    h = facts["hyper"]
    sh = ref_sac.SACHyper(lr=h["sac"]["lr"], weight_decay=h["sac"]["weight_decay"],
                          alpha_lr=h["sac"]["alpha_lr"], discount=h["sac"]["discount"],
                          entropy_target=h["sac"]["target_temperature"] * facts["A"],
                          polyak=h["sac"]["polyak"], min_alpha=h["sac"]["min_alpha"])
    gh = ref_gail.GAILHyper(**h["gail"])
    sac = ref_sac.init_state(w["actor"], w["critic"])
    disc = ref_gail.init_state(w["disc"], w["sn"])
    losses, grads = [], None
    for k, rec in enumerate(captured):
        tb, eb, nz = rec["tb"], rec["eb"], rec["nz"]
        g = ref_gail.gail_step(gh, disc, eb["states"], eb["actions"], eb["weights"],
                               tb["states"], tb["actions"], tb["weights"], nz["eps_gp"],
                               nz.get("mix"))
        batch = dict(tb)
        batch["rewards"] = g["rewards"]
        s = ref_sac.sac_step(sh, sac, batch, nz["eps2"], nz["eps_new"])
        losses.append(float(g["loss"][0]))
        if k == 0:
            grads = {"a": s["grads"]["a"], "c": s["grads"]["c"], "la": s["grads"]["la"],
                     "p": g["grads"]}
    return {"losses": losses, "grads": grads,
            "state": {"a": sac["a"], "c": sac["c"], "t": sac["t"], "la": [sac["la"]],
                      "p": disc["p"]}}


def graded(run, w: Dict, facts: Dict, device, ref: Dict) -> Dict:
    """The three graded numbers, with each leaf's reading."""
    b1 = ref_sac.ADAM_B1
    prog_loss = [float(r["loss"]) for r in run.captured]
    step_gaps = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_loss, ref["losses"])]
    a1 = run.state_after1
    prog_grads = [x / (1.0 - b1) for x in _split({"am": a1["am"], "cm": a1["cm"],
                                                  "lam": a1["lam"], "m": a1["m"]},
                                                 ("am", "cm", "lam", "m"))]
    ref_grads = _split(ref["grads"], ("a", "c", "la", "p"))
    grad = norm_gap(prog_grads, ref_grads)

    g_norm = _norms(ref_grads)
    moves = g_norm >= FLOOR * np.median(g_norm)
    n_a, n_c = len(ref["grads"]["a"]), 2 * len(ref["grads"]["c"])
    # change leaves: a, c (split), t (split, as its critic leaf), la, p
    keep = np.concatenate([moves[:n_a], moves[n_a:n_a + n_c], moves[n_a:n_a + n_c],
                           moves[n_a + n_c:]])
    b, e = run.state_before, run.state_after3
    keys = ("a", "c", "t", "la", "p")
    prog_change = [y - x for x, y in zip(_split(b, keys), _split(e, keys))]
    init = {"a": w["actor"], "c": w["critic"], "t": w["critic"],
            "la": [torch.zeros(1, device=device)], "p": w["disc"]}
    ref_change = [y - x for x, y in zip(_split(init, keys), _split(ref["state"], keys))]
    change = norm_gap(prog_change, ref_change, keep)
    return {"loss_gap": float(np.median(step_gaps)), "grad_gap": grad["widest"],
            "change_gap": change["median"],
            "detail": {"losses": prog_loss, "ref_losses": ref["losses"],
                       "loss_widest_step": max(step_gaps), "grad_median_leaf": grad["median"],
                       "change_widest_leaf": change["widest"], "grad_leaves": grad["leaves"],
                       "change_leaves": change["leaves"], "left_out": int((~keep).sum())}}


def exact(run, ring: Dict, w: Dict, facts: Dict, config: Dict) -> Dict:
    """The four exact numbers."""
    b = run.state_before
    start = 0.0
    for got, want in ((b["a"], w["actor"]), (b["c"], w["critic"]), (b["t"], w["critic"]),
                      (b["p"], w["disc"]), (b["sn"], w["sn"])):
        start = max([start] + [float((x - y).abs().max()) for x, y in zip(got, want)])
    for k in ("am", "cm", "la", "lam", "m"):
        start = max([start] + [float(x.abs().max()) for x in b[k]])

    tb_rows = np.concatenate([ring_matrix({k: r["tb"][k] for k in ref_rows.COLUMNS})
                              for r in run.captured])
    batch_unknown = ref_rows.unknown_rows(tb_rows, run.ring_at_capture)

    with np.load(os.path.join(HERE, os.pardir, config["expert_file"])) as f:
        data = {k: f[k] for k in f.files}
    known = ref_rows.expert_rows(data, facts["trajectories"], facts["absorbing"])
    eb_rows = np.concatenate([torch.cat([r["eb"]["states"], r["eb"]["actions"],
                                         r["eb"]["weights"][:, None]], 1).cpu().numpy()
                              for r in run.captured])
    expert_unknown = ref_rows.unknown_rows(eb_rows, known)

    wrong = int((ring["got"] != ring["want"]).any(1).sum())
    wrong += abs(ring["idx_end"] - ring["idx_want"]) + abs(ring["calls"] - ring["iterations"])
    return {"start_state_gap": start, "batch_rows_unknown": batch_unknown,
            "expert_rows_unknown": expert_unknown, "ring_rows_wrong": wrong}


def readings(run, ring: Dict, w: Dict, facts: Dict, config: Dict, device) -> Dict:
    """Every number compared, with the graded ones' detail, the reference
    in float32 with TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference_steps(run.captured, w, facts, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return {**exact(run, ring, w, facts, config), **graded(run, w, facts, device, ref)}


def check(run, ring: Dict, w: Dict, facts: Dict, config: Dict, device) -> Dict:
    """{name: (value, limit)} of every number compared, and `correct`."""
    r = readings(run, ring, w, facts, config, device)
    lim = limits_of(config["name"])
    numbers = {k: (r[k], lim[k]) for k in EXACT + GRADED}
    return {"numbers": numbers, "detail": r["detail"],
            "correct": all(v <= l for v, l in numbers.values())}
