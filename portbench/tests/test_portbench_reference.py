"""The plain reference agrees with the port's own plain versions at small
sizes on the CPU (the reference imports none of the port; these tests do,
to hold the two side by side)."""

import os

import numpy as np
import pytest
import torch

from portbench.reference import gail as ref_gail
from portbench.reference import rows as ref_rows
from portbench.reference import sac as ref_sac

S, A, B, H, HD = 7, 3, 24, 16, 8


def _sac_state(g):
    from iltpu_torch.ops.sac_update import SCALAR_KEYS, STATE_KEYS, state_shapes

    shapes = state_shapes(S, A, H)
    leaves = [0.3 * torch.randn(s, generator=g) for s in shapes]
    st, i = {}, 0
    for k in STATE_KEYS:
        st[k] = leaves[i:i + 6]
        i += 6
    for k in SCALAR_KEYS:
        st[k] = leaves[i]
        i += 1
    for k in ("am", "av", "cm", "cv"):
        st[k] = [x.abs() if k.endswith("v") else x for x in st[k]]
    for k in ("lam", "lav", "ta", "tc", "tal"):
        st[k] = st[k].abs() + (2.0 if k.startswith("t") else 0.0)
    return st


def _batch(g):
    return {"states": torch.randn(B, S, generator=g), "actions": torch.rand(B, A, generator=g) * 2 - 1,
            "rewards": torch.randn(B, generator=g), "next_states": torch.randn(B, S, generator=g),
            "terminals": (torch.rand(B, generator=g) < 0.2).float(),
            "weights": torch.rand(B, generator=g) + 0.5,
            "absorbing": (torch.rand(B, generator=g) < 0.2).float()}


def _copy(st):
    return {k: [x.clone() for x in v] if isinstance(v, list) else v.clone() for k, v in st.items()}


@pytest.mark.parametrize("min_alpha", [0.0, 0.05])
def test_sac_matches_the_port(min_alpha):
    from iltpu_torch.ops.sac_update import SACHyper, sac_update_plain

    g = torch.Generator().manual_seed(3)
    st, batch = _sac_state(g), _batch(g)
    eps2, eps_new = torch.randn(B, A, generator=g), torch.randn(B, A, generator=g)
    h = SACHyper(3e-4, 0.01, 3e-4, 0.97, -1.5, 0.99, min_alpha)
    mine, theirs = _copy(st), _copy(st)
    out = ref_sac.sac_step(ref_sac.SACHyper(*h), mine, batch, eps2, eps_new)
    aux = sac_update_plain(h, theirs, batch, eps2, eps_new)
    for k in st:
        torch.testing.assert_close(mine[k], theirs[k], rtol=1e-6, atol=1e-7)
    for k in aux:
        torch.testing.assert_close(out["aux"][k], aux[k], rtol=1e-6, atol=1e-7)
    # the gradients it returns are those the moments took: m1 = (1 - b1) g from zero
    z = _copy(st)
    for k in ("am", "cm", "lam"):
        z[k] = [torch.zeros_like(x) for x in z[k]] if isinstance(z[k], list) else torch.zeros_like(z[k])
    z["ta"], z["tc"], z["tal"] = (torch.zeros(1) for _ in range(3))
    out = ref_sac.sac_step(ref_sac.SACHyper(*h), z, batch, eps2, eps_new)
    for k, m in (("a", "am"), ("c", "cm")):
        for gr, mm in zip(out["grads"][k], z[m]):
            torch.testing.assert_close(mm / (1 - ref_sac.ADAM_B1), gr, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("loss, sn, head, bonus", [("BCE", True, "AIRL", 0.0),
                                                   ("Mixup", True, "AIRL", 0.24),
                                                   ("BCE", False, "GAIL", 0.0),
                                                   ("Mixup", False, "FAIRL", 0.1)])
def test_gail_matches_the_port(loss, sn, head, bonus):
    from iltpu_torch.ops.gail_update import GAILHyper, gail_update_plain

    g = torch.Generator().manual_seed(5)
    D = S + A
    p = [0.3 * torch.randn(D, HD, generator=g), 0.1 * torch.randn(HD, generator=g),
         0.3 * torch.randn(HD, 1, generator=g), 0.1 * torch.randn(1, generator=g)]
    unit = lambda x: x / x.norm()
    vecs = [unit(torch.randn(HD, generator=g)), unit(torch.randn(D, generator=g)),
            torch.ones(1), unit(torch.randn(HD, generator=g))] if sn else []
    st = {"p": p, "sn": vecs, "m": [torch.zeros_like(x) for x in p],
          "v": [torch.zeros_like(x) for x in p], "t": torch.zeros(1)}
    args = [torch.randn(B, S, generator=g), torch.rand(B, A, generator=g),
            torch.rand(B, generator=g) + 0.5, torch.randn(B, S, generator=g),
            torch.rand(B, A, generator=g), torch.rand(B, generator=g) + 0.5,
            torch.rand(B, generator=g), torch.rand(B, generator=g) if loss == "Mixup" else None]
    h = GAILHyper(0.3, 3e-4, 8.0, head, loss, bonus)
    mine, theirs = _copy(st), _copy(st)
    out = ref_gail.gail_step(ref_gail.GAILHyper(*h), mine, *args)
    l2, r2 = gail_update_plain(h, theirs, *args)
    torch.testing.assert_close(out["loss"], l2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(out["rewards"], r2, rtol=1e-6, atol=1e-7)
    for k in ("p", "sn", "m", "v", "t"):
        torch.testing.assert_close(mine[k], theirs[k], rtol=1e-6, atol=1e-7)
    for gr, m in zip(out["grads"], mine["m"]):
        torch.testing.assert_close(m / (1 - ref_sac.ADAM_B1), gr, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("absorbing", [True, False])
def test_ring_rows_match_the_port(absorbing):
    from iltpu_torch.data import replay_append_batch, replay_init

    rng = np.random.default_rng(0)
    n, Sx, size = 6, 5, 40
    rs = replay_init(size, Sx, 2, absorbing)
    calls, ids = [], []
    for k in range(5):
        c = {"obs": rng.normal(size=(n, Sx)).astype(np.float32),
             "actions": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
             "rewards": rng.normal(size=n).astype(np.float32),
             "next_obs": rng.normal(size=(n, Sx)).astype(np.float32),
             "terminals": (rng.uniform(size=n) < 0.3).astype(np.float32),
             "timeouts": (rng.uniform(size=n) < 0.2).astype(np.float32)}
        c["timeouts"] *= 1 - c["terminals"]
        calls.append(c)
        ids.append(k * n + 1)
        t = {key: torch.from_numpy(v) for key, v in c.items()}
        replay_append_batch(rs, torch.full((n,), float(k * n + 1)), t["obs"], t["actions"],
                            t["rewards"], t["next_obs"], t["terminals"], t["timeouts"])
    want = ref_rows.ring_rows(calls, ids, absorbing)
    m = len(want["step"])
    assert int(rs.idx) == m % size and m <= size
    for k in ref_rows.COLUMNS:
        np.testing.assert_array_equal(getattr(rs, k)[:m].numpy(), want[k])


def test_expert_rows_match_the_port():
    from iltpu_torch.data import build_expert_transitions

    with np.load(os.path.join(os.path.dirname(ref_rows.__file__), "..", "..", "data",
                              "hopper_expert.npz")) as f:
        data = {k: f[k] for k in f.files}
    mine = ref_rows.expert_rows(data, 5, True)
    # build_expert_transitions clears its input's terminal flags in place: give it a copy
    tr, _ = build_expert_transitions({k: v.copy() for k, v in data.items()}, trajectories=5,
                                     absorbing=True)
    theirs = np.concatenate([tr["states"], tr["actions"], tr["weights"][:, None]], 1)
    np.testing.assert_array_equal(mine, theirs)
    assert ref_rows.unknown_rows(theirs, mine) == 0
    assert ref_rows.unknown_rows(theirs + 1.0, mine) == len(theirs)


def _mlp(g, sizes, scale=0.3):
    p = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        p += [scale * torch.randn(i, o, generator=g), 0.1 * torch.randn(o, generator=g)]
    return p


def _expert(g, rows):
    return {"states": torch.randn(rows, S, generator=g),
            "actions": torch.rand(rows, A, generator=g) * 2.2 - 1.1,  # some past the clamp
            "weights": torch.rand(rows, generator=g) + 0.5}


@pytest.mark.parametrize("activation, depth, dropout", [("relu", 2, 0.0), ("tanh", 1, 0.2)])
def test_bc_matches_the_port(activation, depth, dropout):
    """The reference's BC step against `behavioural_cloning_update`: the
    SAC actor's auxiliary step (relu, no dropout) and DRIL's pretraining
    (tanh, dropout with the same masks), three steps each."""
    from iltpu_torch.models.actor import SoftActor
    from iltpu_torch.updates.bc import behavioural_cloning_update

    from portbench.reference import bc as ref_bc

    g = torch.Generator().manual_seed(11)
    actor = SoftActor(S, A, H, depth, activation, input_dropout=dropout, dropout=dropout)
    p = _mlp(g, [S] + [H] * depth + [2 * A])
    p[-2] = p[-2] * 3  # log_std past the clamp on some rows
    mine, theirs = ref_bc.opt_state(p), ref_bc.opt_state(p)
    rates = [dropout] * (depth + 1)
    for _ in range(3):
        batch = _expert(g, B)
        masks = actor.net.draw_masks(B, g) if dropout else None
        out = ref_bc.bc_step(mine, batch["states"], batch["actions"], batch["weights"], 3e-4,
                             0.5, activation, masks, rates)
        loss = behavioural_cloning_update(actor, theirs, batch, lr=3e-4, weight_decay=0.5,
                                          masks=masks, train_dropout=bool(dropout))
        torch.testing.assert_close(out["loss"], loss, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mine["t"], theirs["t"], rtol=0, atol=0)
    for k in ("m", "v"):
        for x, y in zip(mine[k], theirs[k]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6 * float(y.abs().max()))
    # an element whose gradients stay within rounding of zero, not at zero,
    # takes Adam's step (the learning rate) with either sign: compare the others
    for x, y, v in zip(mine["p"], theirs["p"], theirs["v"]):
        keep = (v == 0) | (v.sqrt() > 1e-5 * v.sqrt().max())
        assert keep.any()
        torch.testing.assert_close(x[keep], y[keep], rtol=1e-5, atol=1e-7)


def test_dril_matches_the_port():
    """The reference's uncertainty, threshold and +-1 reward against the
    port's ensemble, on seeded weights and fixed masks."""
    from iltpu_torch.models.actor import SoftActor

    from portbench.reference import dril as ref_dril

    g = torch.Generator().manual_seed(13)
    ens = SoftActor(S, A, 16, 1, "tanh", input_dropout=0.21, dropout=0.2)
    p = _mlp(g, [S, 16, 2 * A], 0.5)
    with torch.no_grad():
        for dst, src in zip(ens.net.leaves(), p):
            dst.copy_(src)
    rows = 200
    e = _expert(g, rows)
    masks = ens.ensemble_masks(rows, g)
    u = ref_dril.uncertainty(p, e["states"], e["actions"], masks, [0.21, 0.2], "tanh")
    torch.testing.assert_close(u, ens.action_uncertainty(e["states"], e["actions"], masks),
                               rtol=1e-5, atol=0.0)
    for q in (0.0, 0.5, 0.8595, 1.0):
        theirs = ens.uncertainty_threshold(e["states"], e["actions"], q, masks)
        torch.testing.assert_close(ref_dril.quantile(u, q), theirs, rtol=1e-5, atol=0.0)
    thr = torch.quantile(u, 0.6)
    torch.testing.assert_close(ref_dril.reward(u, thr),
                               ens.dril_reward(e["states"], e["actions"], thr, masks))
    assert 0 < int((ref_dril.reward(u, thr) > 0).sum()) < rows
