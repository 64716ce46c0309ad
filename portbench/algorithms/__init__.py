"""The algorithm adapters: what the harness, the check of `correct`, the
faults and the trace run need to know of one algorithm's reward model, one
module an algorithm, named after the trainer's `cfg.algorithm` in lower
case (`sac.py` for `algorithm=SAC`). The SAC update itself, which every
algorithm ends its update with, is the harness's own.

An adapter module defines:

- `PARAMS`, `MOMENT`: the keys of its trained leaves and of their AdamW
  first moments in `state`, or None where it trains nothing;
- `state(trainer)`: its leaves in the trainer's state, {key: [tensors]},
  in the order the check reads them;
- `nets(trainer)`: the networks the benchmark's weights add to the actor
  and critic, {name: leaf shapes}, and the names among them whose matrices
  get spectral-norm vectors (`weights.make`);
- `installed(st, w)`: (leaves of `st`, weights leaves) pairs, `st` keyed as
  `state` gives it: what set-up copies into the trainer before
  `Trainer.run`, so that the seed fixes set-up's start;
- `setup(run)`: wrappers on what set-up trains (pretraining), put on the
  trainer before `Trainer.run`, keeping what the check needs in
  `run.setup` and taken off when that work ends; nothing where set-up
  trains nothing;
- `closed(run)`: at the window's close, before the loop's last iteration
  (untimed): wrappers that keep what the check reads of that iteration;
  nothing where the check needs nothing of it;
- `start(run, w)`: the (leaves, wanted) pairs `start_state_gap` compares
  exactly: each leaf where its training starts, the weights (and zero
  moments and clocks, where that is set-up's pretraining) (`MOMENT` is
  checked zero at the first update besides); `installed(run.state_before,
  w)` where set-up trains nothing;
- `facts(trainer)`: the shapes its work counts read;
- `hyper(cfg)`: its reference's hyperparameters;
- `init(w, run)`: its reference's state (with `PARAMS` and `MOMENT` under
  the same keys): from the weights, or where set-up trains it, from the
  leaves (and threshold) as `run.state_before` holds them before the
  first update; `step(hyper, st, tb, eb, nz)`: its reference's step
  before the SAC step, returning {"rewards": the SAC batch's rewards or
  None, "grads": the gradients of `PARAMS`, ...};
- `loss(aux)`: the number `loss_gap` reads from what the program's update
  (or update unit) returned; `ref_loss(out, sac_out)`: the same number of
  the reference's micro-update;
- `numbers(run, w, facts, config, ref)`: its own numbers compared, {name:
  value}, each with its limit under that name in the cell's limits file
  (`ref` holds the reference's step outputs of the checked units under
  "outs"); {} where it has none;
- `patches(name, mod)`: the trainer module's names it replaces for the
  control or one of its faults (`faults.py`), {} for a name not its own;
  `FAULTS`: the names of its own faults;
- `probe(run)`: in a traced run, keeps from the next update what its
  per-layer metrics need; `context(run)`: what those readers find in
  `ctx`; `update_flops(ctx)`: the model FLOPs of one whole update (its step
  and the SAC update), or None where the trace run could not tell.
"""

import importlib
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))


def adapter(algorithm: str):
    """The adapter of `algorithm` (as the trainer's configuration names it)."""
    return importlib.import_module(f"portbench.algorithms.{algorithm.lower()}")


def names() -> List[str]:
    """Every adapter's module name."""
    return sorted(n[:-3] for n in os.listdir(HERE) if n.endswith(".py") and n != "__init__.py")
