"""The on-device loop's chunks on the card, as CUDA-graph replays.

A chunk of the on-device loop (`Trainer._device_loop`) is n_iters
iterations of act -> env step -> PWIL reward -> append -> draws and bulk
samples -> upi updates. `ChunkGraphs` captures, once per updates-per-
iteration `upi`, two graphs of the trainer's own functions:

- the FRONT, `Trainer.act_and_step` at the step a device counter holds:
  it writes the iteration's rewards and dones into its row of the chunk's
  two buffers, and its batches, expert batches and draws into static
  buffers;
- one UNIT of updates, `Trainer.update_unit` (a per-update body, or one
  K-blocked launch): it gathers its slice of those static buffers through a
  device-side index, then advances the index.

A chunk is then a host loop of replays with no host read; the rewards and
dones (n_iters, N) come back in one copy. Nothing else runs: a path that
cannot be captured raises.

A graph replays the addresses it saw at capture, so everything an iteration
updates is updated in place (`Trainer.state_tensors`: the ring and its
scalars, the SAC and discriminator states, AdRIL's flip, GMMIL's carry,
PWIL's pools, and the env state); `run` checks after each chunk that none
was rebound. The step the iteration sees comes from a device counter that
the front advances, as a 0-d int64 tensor (the ring's step column and
AdRIL's float32 ceil(step / update_freq) read it). The trainer's generator
is registered with every graph, so a replay draws what the same calls would
draw eagerly and advances the generator as they would.

Capture follows `torch.cuda.graph`'s rules: the first chunk with a given
upi runs its first `WARMUP` iterations eagerly on the capture's side stream
(the autograd paths allocate, the kernels cache their launch configuration
then), and captures after them with the sync debug mode set to "error";
later chunks only replay; under data parallel the update graph holds the
NCCL all-reduces (the mesh made the communicator before any capture), and
under the tensor-parallel layout the front and update graphs hold their
works' all-gathers and block copies, the whole temporaries in the graphs'
private pools (`iltpu_torch/parallel/tensor.py`). The
kernel wrappers' launch counters (and the all-reduce's) count Python
calls, so the launches counted while capturing are taken out again, and
each replay adds the launches its graph holds.
"""

from typing import Dict, NamedTuple, Optional

import torch

WARMUP = 1


def wrappers():
    """Every kernel wrapper with a launch counter, the data-parallel
    gradient all-reduce and the tensor-parallel layout's all-gather with
    their counts of collectives."""
    from iltpu_torch.ops.gail_update import gail_update
    from iltpu_torch.ops.gaussian_rowsum import gaussian_rowsum, gmmil_witness_reward
    from iltpu_torch.ops.kblock_update import kblock_update
    from iltpu_torch.ops.pwil_transport import pwil_transport
    from iltpu_torch.ops.sac_update import sac_update
    from iltpu_torch.parallel.data import allreduce_mean_
    from iltpu_torch.parallel.tensor import allgather_blocks

    return (sac_update, gail_update, kblock_update, gaussian_rowsum, gmmil_witness_reward,
            pwil_transport, allreduce_mean_, allgather_blocks)


def launch_counts() -> Dict[str, int]:
    return {f.__name__: f.launches for f in wrappers()}


class Captured(NamedTuple):
    """Two graphs and the tensors they read and write, held for as long as
    the graphs replay."""
    front: torch.cuda.CUDAGraph
    update: Optional[torch.cuda.CUDAGraph]
    units: int  # update replays an iteration
    uidx: Optional[torch.Tensor]  # the update unit's rows of the static buffers
    uidx0: Optional[torch.Tensor]  # their first unit's rows
    statics: tuple  # the front's batches, expert batches and draws
    launches: Dict[str, int]  # kernel launches an iteration's replays make
    aux: Dict[str, torch.Tensor]  # the last replays' aux


class ChunkGraphs:
    def __init__(self, trainer, capacity: int):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise NotImplementedError(
                "training.on_device_loop on the card needs CUDAGraph.register_generator_state "
                f"(the trainer's own generator in a graph); torch {torch.__version__} lacks it")
        self.t = trainer
        dev = trainer.device
        N = trainer.cfg.num_envs
        self.rewards = torch.zeros(capacity, N, device=dev)
        self.dones = torch.zeros(capacity, N, dtype=torch.bool, device=dev)
        self.it = torch.zeros(1, dtype=torch.int64, device=dev)
        self.step = torch.zeros((), dtype=torch.int64, device=dev)
        self.next_step = torch.zeros((), dtype=torch.int64, device=dev)
        self.stream = torch.cuda.Stream(dev)
        self.captured: Dict[int, Captured] = {}
        self.addresses: Optional[Dict[str, int]] = None

    def _state(self, env_state) -> Dict[str, torch.Tensor]:
        out = dict(self.t.state_tensors())
        out.update({f"env.inner.{k}": v for k, v in env_state["inner"].items()})
        out.update({"env.t": env_state["t"], "env.obs": env_state["obs"]})
        return out

    def run(self, env_state: Dict, step: int, n_iters: int, upi: int):
        """n_iters iterations of upi updates from env step `step`:
        (rewards (n_iters, N), dones, the last aux) on the device, the
        first two views of the chunk's buffers."""
        t, N = self.t, self.t.cfg.num_envs
        cap, i, aux = self.captured.get(upi), 0, {}
        if cap is None:
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                for i in range(min(WARMUP, n_iters)):
                    out, aux = t.iteration(env_state, step + i * N, upi)
                    self.rewards[i].copy_(out["reward"])
                    self.dones[i].copy_(out["done"])
                i += 1
            torch.cuda.current_stream().wait_stream(self.stream)
            if i < n_iters:
                cap = self.captured[upi] = self._capture(env_state, upi)
        if i < n_iters:
            self.next_step.fill_(step + i * N)
            self.it.fill_(i)
            for _ in range(i, n_iters):
                cap.front.replay()
                for _ in range(cap.units):
                    cap.update.replay()
            for f in wrappers():
                f.launches += cap.launches[f.__name__] * (n_iters - i)
            aux = cap.aux
            self._check_in_place(env_state)
        return self.rewards[:n_iters], self.dones[:n_iters], aux

    def _check_in_place(self, env_state) -> None:
        now = {k: v.data_ptr() for k, v in self._state(env_state).items()}
        if now != self.addresses:
            moved = sorted(k for k in now if now[k] != self.addresses.get(k))
            raise RuntimeError(f"state rebound since the graphs were captured: {moved[:8]}")

    def _front(self, env_state, upi):
        """The front's body: the iteration up to its updates at the device
        step, its rewards and dones into the chunk's buffers."""
        t = self.t
        self.step.copy_(self.next_step)
        self.next_step.add_(t.cfg.num_envs)
        out, (aux, batches, expert_batches, draws) = t.act_and_step(env_state, self.step, upi)
        self.rewards.index_copy_(0, self.it, out["reward"][None])
        self.dones.index_copy_(0, self.it, out["done"][None])
        self.it.add_(1)
        return aux, (batches, expert_batches, draws)

    def _unit(self, statics, uidx, u):
        """The update graph's body: a unit of updates on its rows."""
        pick = lambda d: {k: v.index_select(0, uidx) for k, v in d.items()}
        aux = self.t.update_unit(self.step, *(pick(d) for d in statics))
        uidx.add_(u)
        return aux

    def _record(self, graph, body, *args):
        """Capture `body(*args)` into `graph`, with the generator registered
        and host synchronisation an error; returns what it returned and the
        launches it made."""
        graph.register_generator_state(self.t.gen)
        before = launch_counts()
        with torch.cuda.graph(graph, stream=self.stream):
            torch.cuda.set_sync_debug_mode("error")
            try:
                result = body(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        after = launch_counts()
        for f in wrappers():  # a capture launches nothing
            f.launches = before[f.__name__]
        return result, {k: after[k] - before[k] for k in after}

    def _capture(self, env_state, upi: int) -> Captured:
        t = self.t
        front = torch.cuda.CUDAGraph()
        u = t.unit(upi) if upi else 0
        uidx = uidx0 = update = None
        if upi:
            uidx0 = torch.arange(u, device=t.device)
            uidx = uidx0.clone()

        def front_body():
            out = self._front(env_state, upi)
            if upi:
                uidx.copy_(uidx0)
            return out

        (aux, statics), launches = self._record(front, front_body)
        aux = dict(aux)
        if upi:
            update = torch.cuda.CUDAGraph()
            unit_aux, unit_launches = self._record(update, self._unit, statics, uidx, u)
            aux.update(unit_aux)
            launches = {k: v + (upi // u) * unit_launches[k] for k, v in launches.items()}
        self.addresses = {k: v.data_ptr() for k, v in self._state(env_state).items()}
        return Captured(front, update, upi // u if u else 0, uidx, uidx0, statics, launches, aux)
