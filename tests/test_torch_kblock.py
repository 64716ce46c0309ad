"""The port's K-blocked GAIL+SAC update (iltpu_torch/ops/kblock_update.py,
the plain twin of the cooperative CUDA kernel) against iltpu's K-blocked
Pallas kernel in interpret mode (`gail_sac_update_kblock`), on iltpu's leaf
layouts built as its trainer builds them, with the same numpy inputs
handed to both; the wrapper's refusals; and a short K-blocked run through
the CLI on the CPU."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iltpu.models.actor import SoftActor
from iltpu.models.critic import TwinCritic
from iltpu.ops.pallas_fused_block import gail_sac_update_kblock
from iltpu.ops.pallas_gail import gail_leaves_to_state, gail_state_to_leaves
from iltpu.ops.pallas_sac import sac_leaves_to_state, sac_state_to_leaves
from iltpu.rewards.gail import GAILDiscriminator
from iltpu.updates.sac import SACLearner
from iltpu_torch import convert
from iltpu_torch.ops import kblock_update as kb
from iltpu_torch.ops import operands
from iltpu_torch.ops.gail_update import GAILHyper, gail_update
from iltpu_torch.ops.kblock_update import kblock_update
from iltpu_torch.ops.sac_update import SACHyper, sac_update
from test_torch_convert import assert_trees_close, jax_disc_tree, jax_sac_tree, port_disc_state, port_sac_state
from test_torch_gail import _launch_pointers as gail_pointers
from test_torch_sac import _launch_pointers as sac_pointers
from test_torch_sac import bound_argtypes, c_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, B, S, A, H = 4, 16, 5, 2, 32  # pointmass: state 4 + absorbing bit, action 2
# K=1: no micro-update hands rewards to a later one; K=4 and odd K=5: the
# last micro-update's rewards must end in the `rewards` output
KS = (1, 4, 5)
LR, WD = 3e-5, 10.0

CONFIGS = {
    # the bench configuration and a tuned-like one (tests/test_torch_trainer.py)
    "bce_sn": dict(spectral_norm=True, reward_function="AIRL", loss="BCE", gp=1.0, ent=0.0),
    "mixup_airl": dict(spectral_norm=False, reward_function="AIRL", loss="Mixup", gp=0.436, ent=0.01),
}


def _inputs(seed, K=K, S=S, A=A):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    policy = {
        "states": f32(rng.normal(size=(K, B, S))),
        "actions": f32(np.tanh(rng.normal(size=(K, B, A)))),
        "next_states": f32(rng.normal(size=(K, B, S))),
        "terminals": f32(rng.uniform(size=(K, B)) < 0.1),
        "weights": f32(1.0 + 0.5 * rng.uniform(size=(K, B))),
        "absorbing": f32(rng.uniform(size=(K, B)) < 0.2),
    }
    expert = {
        "states": f32(rng.normal(size=(K, B, S))),
        "actions": f32(np.tanh(rng.normal(size=(K, B, A)))),
        "weights": f32(1.0 + 0.5 * rng.uniform(size=(K, B))),
    }
    noise = {
        "eps_gp": f32(rng.uniform(size=(K, B))),
        "eps2": f32(rng.normal(size=(K, B, A))),
        "eps_new": f32(rng.normal(size=(K, B, A))),
        "mix": f32(rng.uniform(size=(K, B))),
    }
    return policy, expert, noise


def _setup(cfg, S=S, A=A):
    learner = SACLearner(
        SoftActor(S, A, hidden_size=H, depth=2), TwinCritic(S, A, hidden_size=H, depth=2),
        learning_rate=3e-4, weight_decay=1e-2, discount=0.97, entropy_target=-1.0,
        polyak_factor=0.99,
    )
    sac = learner.init(jax.random.key(0))
    disc = GAILDiscriminator(S, A, hidden_size=64, depth=1, spectral_norm=cfg["spectral_norm"],
                             reward_function=cfg["reward_function"])
    params = disc.init(jax.random.key(1))
    opt = optax.flatten(optax.adamw(LR, weight_decay=WD)).init(params)
    return learner, sac, disc, params, opt


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kblock_matches_iltpu(name, K):
    _kblock_matches_iltpu(name, K)


def test_kblock_matches_iltpu_at_ant_widths():
    """Ant's state 112 + action 8: 120 discriminator inputs, the card's wide
    GAIL variant; two micro-updates."""
    _kblock_matches_iltpu("bce_sn", 2, S=112, A=8)


def _kblock_matches_iltpu(name, K, S=S, A=A):
    cfg = CONFIGS[name]
    learner, sac, disc, params, opt = _setup(cfg, S, A)
    policy, expert, noise = _inputs(3, K, S, A)
    if cfg["loss"] == "BCE":
        noise.pop("mix")
        tgt = np.stack([
            np.broadcast_to(np.concatenate([np.ones(B), np.zeros(B)]), (K, 2 * B)),
            np.concatenate([expert["weights"], policy["weights"]], 1),
        ], 1).astype(np.float32)  # (K, 2, 2B): [BCE targets | weights], trainer.py:839-856
    else:
        tgt = noise["mix"].reshape(K, 1, B)

    # iltpu: leaves as its trainer builds them (trainer.py:857-860), one kernel, back to state
    sac_lv = sac_state_to_leaves(sac)
    disc_lv, moments = gail_state_to_leaves(params, opt)
    jp, je = ({k: jnp.asarray(v) for k, v in d.items()} for d in (policy, expert))
    sac_lv, disc_lv, want = gail_sac_update_kblock(
        learner, disc, sac_lv, disc_lv, jp, je, jnp.asarray(noise["eps_gp"]), jnp.asarray(tgt),
        jnp.asarray(noise["eps2"]), jnp.asarray(noise["eps_new"]),
        grad_penalty=cfg["gp"], learning_rate=LR, weight_decay=WD,
        loss_function=cfg["loss"], entropy_bonus=cfg["ent"], interpret=True,
    )
    want_sac = sac_leaves_to_state(sac, sac_lv, K)
    want_params, want_opt = gail_leaves_to_state(opt, disc_lv, K, moments)

    tl, st = port_sac_state(learner, sac)
    _, dst = port_disc_state(disc, params, opt)
    hyper = GAILHyper(cfg["gp"], LR, WD, cfg["reward_function"], cfg["loss"], cfg["ent"])
    got = kblock_update(tl.hyper, hyper, st, dst, _torch(policy), _torch(expert), _torch(noise))

    tol = dict(rtol=1e-4, atol=1e-5)  # the chain tolerance: K dependent fp32 updates
    assert_trees_close(convert.sac_tree(st), jax_sac_tree(want_sac), what="sac", **tol)
    assert_trees_close(convert.disc_tree(dst), jax_disc_tree(want_params, want_opt),
                       what="disc", **tol)
    for key, mine in (("discriminator_loss", got["loss"][0]), ("predicted_rewards", got["rewards"]),
                      ("alphas", got["alpha"]), ("entropies", -got["log_probs"]),
                      ("Q_values", got["Q_values"])):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want[key]), err_msg=key, **tol)


def test_wrapper_refuses_mixed_devices_and_wrong_shapes():
    cfg = CONFIGS["bce_sn"]
    learner, sac, disc, params, opt = _setup(cfg)
    tl, st = port_sac_state(learner, sac)
    _, dst = port_disc_state(disc, params, opt)
    hyper = GAILHyper(cfg["gp"], LR, WD, cfg["reward_function"], "BCE", 0.0)
    policy, expert, noise = (_torch(d) for d in _inputs(4))
    noise.pop("mix")
    before = kblock_update.launches
    aux = kblock_update(tl.hyper, hyper, st, dst, policy, expert, noise)
    assert kblock_update.launches == before and aux["rewards"].shape == (B,)

    def refused(match, p=policy, e=expert, n=noise):
        with pytest.raises(ValueError, match=match):
            kblock_update(tl.hyper, hyper, st, dst, p, e, n)

    refused("one device", p={**policy, "terminals": policy["terminals"].to("meta")})
    refused(r"want contiguous float32 \(4, 16, 5\)", e={**expert, "states": expert["states"][:3]})
    refused(r"want contiguous float32 \(4, 16\)", n={**noise, "eps_gp": noise["eps_gp"].reshape(K * B)})
    refused("contiguous=False", p={**policy, "weights": policy["weights"].T.contiguous().T})
    refused("Mixup", n={**noise, "mix": noise["eps_gp"]})


def _states_and_inputs(name, seed):
    """The port's SAC and discriminator states of CONFIGS[name] and
    K-stacked inputs (no Mixup draw for BCE), on the CPU."""
    cfg = CONFIGS[name]
    learner, sac, disc, params, opt = _setup(cfg)
    tl, st = port_sac_state(learner, sac)
    _, dst = port_disc_state(disc, params, opt)
    policy, expert, noise = (_torch(d) for d in _inputs(seed))
    if cfg["loss"] == "BCE":
        noise.pop("mix")
    hyper = GAILHyper(cfg["gp"], LR, WD, cfg["reward_function"], cfg["loss"], cfg["ent"])
    return tl.hyper, hyper, st, dst, policy, expert, noise


def _as_ints(table):
    return [p or 0 for p in table]  # ctypes reads a null c_void_p as None


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pointers_are_the_per_update_arrays_at_the_slab_bases(name):
    """The two arrays are the per-update entries' (the SAC and GAIL tests'
    own listings) with each batch and draw at its K-stacked slab's base and
    the SAC batch's rewards at the GAIL step's rewards output: BCE with
    spectral norm, and Mixup without (null u, v)."""
    _, _, st, dst, policy, expert, noise = _states_and_inputs(name, 5)
    outs = [torch.empty(n) for n in (1, B, B, B, 1)]
    loss, rewards, lp, min_q, alpha = outs
    tables = operands.Table(), operands.Table()
    sac, gail = kb.pointers(*tables, st, dst, policy, expert, noise, outs)
    assert _as_ints(sac) == sac_pointers(st, {**policy, "rewards": rewards}, noise["eps2"],
                                         noise["eps_new"], [lp, min_q, alpha])
    args = [expert["states"], expert["actions"], expert["weights"], policy["states"],
            policy["actions"], policy["weights"], noise["eps_gp"], noise.get("mix")]
    assert _as_ints(gail) == gail_pointers(dst, args, [loss, rewards])


def test_wrapper_binds_each_state_once_and_again_for_a_swapped_leaf():
    """A second call on the same states with new slabs packs no state
    (`sac_update.binds`, `gail_update.binds` stay); a SAC leaf swapped for
    a copy binds the SAC table again, a discriminator leaf the GAIL one."""
    sh, gh, st, dst, policy, expert, noise = _states_and_inputs("mixup_airl", 6)
    binds = lambda: (sac_update.binds, gail_update.binds)
    kblock_update(sh, gh, st, dst, policy, expert, noise)
    before = binds()
    _, _, _, _, policy, expert, noise = _states_and_inputs("mixup_airl", 7)
    kblock_update(sh, gh, st, dst, policy, expert, noise)
    assert binds() == before
    st["c"][2] = st["c"][2].clone()
    kblock_update(sh, gh, st, dst, policy, expert, noise)
    assert binds() == (before[0] + 1, before[1])
    dst["p"][0] = dst["p"][0].clone()
    kblock_update(sh, gh, st, dst, policy, expert, noise)
    assert binds() == (before[0] + 1, before[1] + 1)


def test_entry_args_keep_the_c_entrys_order():
    """`entry_args` lays out the launch's arguments as
    `iltpu_kblock_update` declares them: the listing here, one distinct
    value a name, is the reference. `_bind` gives the entry the C types."""
    sh = SACHyper(lr=0.5, weight_decay=0.25, alpha_lr=0.125, discount=0.96875,
                  entropy_target=-3.0, polyak=0.75, min_alpha=0.0625)
    gh = GAILHyper(grad_penalty=1.5, lr=2.5, weight_decay=3.5, reward_function="FAIRL",
                   loss_function="Mixup", entropy_bonus=4.5)
    dst = _states_and_inputs("bce_sn", 8)[3]  # spectral norm
    scratch = torch.empty(4)
    want = {"sac_ptr": "sac", "gail_ptr": "gail", "K": K, "B": B, "S": S, "A": A, "H": H,
            "Hd": 64, "sn": 1, "bce": 0, "reward_fn": 2, "lr": 0.5, "wd": 0.25, "alpha_lr": 0.125,
            "discount": 0.96875, "entropy_target": -3.0, "polyak": 0.75, "polyak_c": 0.25,
            "min_alpha": 0.0625, "gp": 1.5, "glr": 2.5, "gwd": 3.5, "ent": 4.5,
            "scratch": scratch.data_ptr()}
    sig = c_params("kblock_update.cu", "iltpu_kblock_update")
    assert list(sig) == [*want, "stream"]
    assert bound_argtypes(kb._bind, "iltpu_kblock_update") == list(sig.values())
    got = kb.entry_args(sh, gh, dst, torch.empty(K, B), ("sac", "gail"), (K, B, S, A, H, 64),
                        scratch)
    assert got == tuple(want.values())


def test_cli_kblock_short_run_on_cpu(tmp_path):
    args = [
        "algorithm=GAIL", "env=pointmass", "env_backend=jax", "steps=200", "training.start=64",
        "num_envs=4", "evaluation.episodes=2", "logging.interval=0", "memory.size=1000",
        "imitation.trajectories=4", "training.batch_size=16", "training.sac_pallas=true",
        "training.disc_pallas=true", "training.fused_update_scan=true", "training.update_block=4",
        "reinforcement.actor.hidden_size=16", "reinforcement.critic.hidden_size=16",
        "check_time_usage=true", "platform=cpu", f"output_dir={tmp_path}",
    ]
    r = subprocess.run(
        [sys.executable, "-m", "iltpu_torch.train", *args], cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert np.isfinite(summary["mean_normalized_score"])
    for name in ("agent", "discriminator", "metrics.pkl", "config.yaml"):
        assert os.path.exists(os.path.join(summary["out_dir"], name))
