"""One run of one cell: build the trainer of `iltpu_torch` from the cell's
configuration and traffic files, drive its normal entry (`Trainer.run`),
open the measured window after warm-up and close it after `seconds`, and
keep what the window's metrics and the check of `correct` need.

The harness edits no program file. It puts thin wrappers on the one
trainer instance it builds:

- `front_of`, which the host loop calls once an iteration, first: the
  iteration's top. The window opens at the first top past the traffic's
  warm-up and closes at the first top `seconds` later, each with a device
  synchronise; closing lowers `cfg.steps` to the current step, which the
  loop checks, so it ends after that iteration, untimed (the adapter's
  `closed` may keep what that iteration computes). The profiled sub-window
  of a traced run opens and closes at tops too.
- the stepper's `step` (the C call that steps every env and copies its
  outputs): its host time, and the outputs the replay ring must hold.
- `update`, the per-update body, and `update_unit`, the K-blocked path's
  unit of K updates in one launch (`Trainer.unit` > 1): every unit from
  the run's first update until three units of the size the window runs
  (`Run.K`: K on the K-blocked path, else 1) are done: their inputs, the
  state around them, their losses and rewards, for the reference. The
  units before those three (on the K-blocked path, the first iteration's
  updates that K does not divide, one at a time) are the check's lead.

Whatever belongs to one algorithm's reward model comes from its adapter
(`portbench/algorithms/<algorithm>.py`), picked by the trainer's
`cfg.algorithm`, and so do the wrappers on what set-up trains (the
adapter's `setup`, such as a reward model's pretraining), which keep what
they see in `Run.setup`.

Everything else runs as the program runs it.
"""

import gc
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import algorithms, correct
from portbench import trace as trace_mod
from portbench import weights as weights_mod
from portbench.reference.rows import COLUMNS

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RUN_STEPS = 10**9  # the loop's step budget: the window, not this, ends a run
CHECKED_UNITS = 3


def load_named(kind: str, name: str) -> Dict:
    """`portbench/<kind>/<name>.json`."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def overrides_of(config: Dict, traffic: Dict, seed: int, out_dir: str) -> List[str]:
    """The `load_config` overrides of a run: the configuration's, the
    traffic's, the seed, the expert file by its path in the checkout, and
    the run's own step budget and output directory."""
    return (list(config["overrides"]) + list(traffic["overrides"]) + [
        f"num_envs={traffic['num_envs']}", f"seed={seed}", f"steps={RUN_STEPS}",
        "expert_data.source=npz", f"expert_data.path={os.path.join(ROOT, config['expert_file'])}",
        f"output_dir={out_dir}",
    ])


class Run:
    """The hooks on one trainer, and what they record."""

    def __init__(self, trainer, traffic: Dict, seconds: float, trace: bool, t_start: float):
        self.trainer = trainer
        self.sync = torch.cuda.synchronize if trainer.device.type == "cuda" else lambda: None
        cfg = trainer.cfg
        N = cfg.num_envs
        self.N = N
        self.open_step = cfg.training.start + int(traffic["warmup_iterations"]) * N
        self.seconds = float(seconds)
        self.t_start = t_start
        self.tops: List[tuple] = []  # (step, host s) of every iteration's top
        self.front_ends: List[float] = []
        self.t0 = self.t1 = self.step0 = self.step1 = None
        self.idx0 = None
        self.calls: List[Dict] = []  # the stepper's outputs, call by call
        self.env_spans: List[tuple] = []  # (host start, host end) of each C call
        self.profiler = trace_mod.SubWindow(traffic, seconds) if trace else None
        self.model = algorithms.adapter(cfg.algorithm)
        self.K = trainer.unit(trainer.update_block)  # updates in each of the window's units
        self.captured: List[Dict] = []  # every unit up to the third checked one, in order
        self.lead = self.checked = 0  # units before the first checked one; checked so far
        self.state_before = self.state_at_check = self.state_after1 = self.state_after3 = None
        self.ring_at_capture = None
        self.probe = None
        self.setup: Dict = {}  # what the adapter's set-up wrappers keep
        self._install()

    # --------------------------------------------------------------- hooks

    def _install(self):
        t = self.trainer
        front_of, update = t.front_of, t.update
        env = t.env.env  # the stepper behind HostEnv

        def front_hook(step, acted, n_updates):
            self._top(int(step))
            out = front_of(step, acted, n_updates)
            self.front_ends.append(time.perf_counter())
            return out

        step_fn = env.step

        def env_hook(actions):
            obs = t.env.obs
            s = time.perf_counter()
            out = step_fn(actions)
            e = time.perf_counter()
            self.env_spans.append((s, e))
            next_obs, rewards, terminals, timeouts, _ = out
            self.calls.append({"obs": obs, "actions": np.array(actions, np.float32, copy=True),
                               "rewards": rewards, "next_obs": next_obs,
                               "terminals": terminals, "timeouts": timeouts})
            return out

        def capturing(fn, stacked: bool):
            def hook(step, tb, eb, nz):
                size = tb["states"].shape[0] if stacked else 1
                if stacked and size == 1:  # its one update goes through `update`, which keeps it
                    return fn(step, tb, eb, nz)
                checked = size == self.K
                if not self.captured:
                    self.state_before = self._state()
                if checked and self.checked == 0:
                    self.lead = len(self.captured)
                    self.state_at_check = self._state() if self.lead else self.state_before
                if checked and self.checked + 1 == CHECKED_UNITS:
                    # every row the samples so far drew from is written
                    self.ring_at_capture = self._ring_head()
                rec = {k: _clone(d, stacked) for k, d in (("tb", tb), ("eb", eb), ("nz", nz))}
                aux = fn(step, tb, eb, nz)
                rec["loss"] = self.model.loss(aux).detach().clone()
                rec["rewards"] = aux["predicted_rewards"].detach().clone()
                self.captured.append(rec)
                if checked:
                    self.checked += 1
                    if self.checked == 1:
                        self.state_after1 = self._state()
                    if self.checked == CHECKED_UNITS:
                        self.state_after3 = self._state()
                        for name in ("update", "update_unit"):  # the class's own, for the window
                            t.__dict__.pop(name, None)
                return aux
            return hook

        t.front_of = front_hook
        t.update = capturing(update, False)
        t.update_unit = capturing(t.update_unit, True)
        env.step = env_hook
        self.model.setup(self)

    def _state(self) -> Dict[str, List[torch.Tensor]]:
        t = self.trainer
        sac = t.sac
        return {k: [x.detach().clone() for x in v] for k, v in (
            ("a", sac["a"]), ("am", sac["am"]), ("c", sac["c"]), ("cm", sac["cm"]),
            ("t", sac["t"]), ("la", [sac["la"]]), ("lam", [sac["lam"]]),
            *self.model.state(t).items())}

    def _ring_head(self) -> np.ndarray:
        """The ring's rows written so far, as one (rows, columns) matrix."""
        r = self.trainer.replay
        n = int(r.idx)
        return correct.ring_matrix({k: getattr(r, k)[:n] for k in COLUMNS})

    def _top(self, step: int):
        now = time.perf_counter()
        self.tops.append((step, now))
        if self.t0 is None:
            if step >= self.open_step:
                self.sync()
                self.t0, self.step0 = time.perf_counter(), step
                self.idx0 = int(self.trainer.replay.idx)
                self.calls0 = step // self.N  # the call iteration k appends is call k
            return
        if self.t1 is not None:
            return
        el = now - self.t0
        if self.profiler is not None:
            self.profiler.at_top(el, len(self.tops) - 1, self)
        if el >= self.seconds:
            if self.profiler is not None:
                self.profiler.stop(len(self.tops) - 1, self)
            self.sync()
            self.t1, self.step1 = time.perf_counter(), step
            self.trainer.cfg.steps = step  # the loop ends after this iteration
            self.model.closed(self)

    def probe_model(self):
        """In a traced run, at the profiled sub-window's opening: what the
        adapter's per-layer metrics need from the next update."""
        self.model.probe(self)


def _clone(d: Dict, stacked: bool) -> Dict:
    """A copy of an update's (or a unit's) inputs, each with a leading unit
    axis."""
    return {k: v.detach().clone() if stacked else v.detach().clone()[None] for k, v in d.items()}


def build(config: Dict, traffic: Dict, seed: int, out_dir: str, extra: Optional[List[str]] = None):
    """The trainer of a run, through the program's own config loader."""
    from iltpu_torch.config import load_config
    from iltpu_torch.trainer import Trainer

    cfg = load_config(overrides_of(config, traffic, seed, out_dir) + list(extra or []),
                      use_tuned=bool(config.get("use_tuned")))
    return Trainer(cfg, out_dir=out_dir)


def nets_of(trainer):
    """The networks the benchmark's weights fill, each by its leaf shapes
    from the configuration as the trainer holds it (the actor, the twin
    critic, then the adapter's), and the names of those with spectral-norm
    vectors."""
    extra, spectral = algorithms.adapter(trainer.cfg.algorithm).nets(trainer)
    return {"actor": [tuple(x.shape) for x in trainer.sac["a"]],
            "critic": [tuple(x.shape) for x in trainer.sac["c"]], **extra}, spectral


@torch.no_grad()
def install_weights(trainer, w: Dict) -> None:
    """Copy the benchmark's weights into the trainer's own tensors, in
    place (the modules share them)."""
    model = algorithms.adapter(trainer.cfg.algorithm)
    live = {"a": trainer.sac["a"], "c": trainer.sac["c"], "t": trainer.sac["t"],
            **model.state(trainer)}
    for dst, src in correct.installed(live, w, model):
        if len(dst) != len(src):
            raise ValueError(f"{len(src)} leaves for {len(dst)}")
        for d, s in zip(dst, src):
            d.copy_(s)


def run_cell(config: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
             t_start: float, extra: Optional[List[str]] = None) -> Dict:
    """Build, warm up, measure and check one run (`t_start`: the process's
    start on the host clock). `extra` overrides go last (the CPU tests give
    `platform=cpu` and small sizes). Returns the run, the window's facts,
    the shapes, the checks, the memory peak, the device and the weights."""
    out_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        trainer = build(config, traffic, seed, out_dir, extra)
        dev = trainer.device
        w = weights_mod.make(seed, *nets_of(trainer), device=dev)
        install_weights(trainer, w)
        run = Run(trainer, traffic, seconds, trace, t_start)
        if trace:
            trace_mod.SubWindow.prepare()
        trainer.run()
        if run.t1 is None:
            raise RuntimeError("the loop ended before the window closed")
        memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        cfg = trainer.cfg
        facts = {
            "algorithm": cfg.algorithm, "unit": run.K,
            "S": trainer.state_size, "A": trainer.action_size, "B": cfg.training.batch_size,
            "H": cfg.reinforcement.actor.hidden_size,
            "absorbing": bool(cfg.imitation.absorbing),
            "trajectories": int(cfg.imitation.trajectories),
            "hyper": correct.hyper_of(cfg), **run.model.facts(trainer),
        }
        window = window_facts(run)
        ring = correct.window_ring(run, trainer.replay)
        for hook in ("front_of", "update", "update_unit"):
            trainer.__dict__.pop(hook, None)
        del trainer
        run.trainer = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checks = correct.check(run, ring, w, facts, config, traffic, dev)
        return {"run": run, "window": window, "facts": facts, "checks": checks,
                "memory_peak": memory_peak, "device": dev, "weights": w}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def window_facts(run: Run) -> Dict:
    """The window's host-clock facts: its length, env steps, and the
    iteration times and the stepper's C-call times before the profiled
    sub-window of a traced run (all of the window otherwise)."""
    tops = run.tops
    first = next(i for i, (s, _) in enumerate(tops) if s == run.step0)
    last = next(i for i, (s, _) in enumerate(tops) if s == run.step1 and i > first)
    cut = run.profiler.first_profiled() if run.profiler is not None else None
    end = last if cut is None else min(cut, last)
    iter_ms = [1e3 * (tops[i + 1][1] - tops[i][1]) for i in range(first, end)]
    t_lo, t_hi = tops[first][1], tops[end][1]
    env_ms = [1e3 * (e - s) for s, e in run.env_spans if t_lo <= s < t_hi]
    return {"seconds": run.t1 - run.t0, "env_steps": run.step1 - run.step0,
            "setup_s": run.t0 - run.t_start, "iter_ms": iter_ms, "env_ms": env_ms,
            "iterations": last - first}
