"""Host-side (numpy) policy inference: the port of
`iltpu/models/host_inference.py`, with the pinned copies it rests on.

- `host_greedy_fn`: the deterministic tanh(mean) in numpy, from one copy of
  the actor's parameters.
- `HostActor`: tanh-Gaussian acting in numpy for the training loop's
  `training.host_acting`, in iltpu's protocol: `start_sync` copies the
  actor's parameters device -> host without blocking (pinned buffers and an
  event on the card), `refresh` waits for the last sync and takes numpy
  copies, `sample` draws from a numpy generator. The trainer refreshes and
  syncs after issuing an iteration's updates, so the actions read params
  one iteration stale, as iltpu's. Its forward is iltpu's, float32 numpy op
  for op, so on equal parameters, observations and generator state its
  actions equal iltpu's.
- `HostReads`: the trainer's device -> host reads of an iteration's
  outputs: non-blocking copies into two sets of pinned buffers, used in
  turn, and an event, so that the host waits for those outputs and not for
  the work queued after them. On the CPU, plain copies. `spans`, the
  trainer's span recorder when it is on (`utils.spans`), takes each wait
  on an event as a `wait` span.

The parameters are the actor MLP's leaves [W1, b1, W2, b2, ...] (W as
(in, out)); the actor has no spectral norm and no dropout when acting.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iltpu_torch.models.distributions import LOG_STD_MAX, LOG_STD_MIN
from iltpu_torch.utils.spans import WAIT_READS

_ACTIVATIONS = {
    "relu": lambda x: np.maximum(x, 0.0),
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "tanh": np.tanh,
}


def _forward(layers, act, obs) -> np.ndarray:
    h = np.asarray(obs, np.float32)
    for i, (w, b) in enumerate(layers):
        h = h @ w + b
        if i < len(layers) - 1:
            h = act(h)
    return h


def _pairs(leaves: Sequence[np.ndarray]) -> List[Tuple[np.ndarray, np.ndarray]]:
    return [(np.asarray(leaves[i], np.float32), np.asarray(leaves[i + 1], np.float32))
            for i in range(0, len(leaves), 2)]


def host_greedy_fn(actor, params: Sequence[torch.Tensor]) -> Callable[[np.ndarray], np.ndarray]:
    """`obs (B, S) or (S,) -> greedy actions` in numpy, from one copy of the
    parameter leaves `params`."""
    layers = _pairs([p.detach().to("cpu", copy=True).numpy() for p in params])
    act, A = _ACTIVATIONS[actor.net.activation], actor.action_size

    def greedy(obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        out = np.tanh(_forward(layers, act, obs[None] if obs.ndim == 1 else obs)[:, :A])
        return out[0] if obs.ndim == 1 else out

    return greedy


class HostReads:
    """Device -> host copies that the host reads later."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.buffers = {}  # (turn, shapes) -> pinned tensors
        self.turn = 0
        self.spans = None

    def _pinned(self, key, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if key not in self.buffers:
            self.buffers[key] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in like]
        return self.buffers[key]

    def start(self, tensors: Sequence[torch.Tensor]):
        """Begin copying `tensors` to the host; returns what `wait` takes.
        At most two starts of one layout are read at a time."""
        if not self.cuda:
            return [t.clone() for t in tensors], None
        key = (self.turn, tuple((tuple(t.shape), t.dtype) for t in tensors))
        self.turn ^= 1
        bufs = self._pinned(key, tensors)
        for b, t in zip(bufs, tensors):
            b.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return bufs, event

    def wait(self, pending) -> List[np.ndarray]:
        """The copies as numpy arrays (views of the buffers: read them
        before the next-but-one `start`)."""
        bufs, event = pending
        if event is not None:
            sp = self.spans
            if sp is not None:
                sp.begin("wait", WAIT_READS)
            event.synchronize()
            if sp is not None:
                sp.end()
        return [b.numpy() for b in bufs]

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the device, through a pinned buffer."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if not self.cuda:
            return t
        buf = self._pinned((self.turn, "h2d", t.shape, t.dtype), [t])[0]
        buf.copy_(t)
        return buf.to(self.device, non_blocking=True)


class HostActor:
    """Numpy tanh-Gaussian sampler over asynchronously synced parameters.

    Protocol an iteration, after its updates are issued:

        host_actor.refresh()           # the parameters of the last sync
        host_actor.start_sync(params)  # copy the updated ones, no wait
        actions = host_actor.sample(obs, rng)
    """

    def __init__(self, actor, params: Sequence[torch.Tensor]):
        self.act = _ACTIVATIONS[actor.net.activation]
        self.action_size = actor.action_size
        self.layers: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
        self._bufs: Optional[List[torch.Tensor]] = None
        self._event = None
        self.start_sync(params)
        self.refresh()

    def start_sync(self, params: Sequence[torch.Tensor]) -> None:
        """Begin a device -> host copy of the parameter leaves."""
        if params[0].device.type != "cuda":
            self._bufs = [p.detach().clone() for p in params]
            return
        if self._bufs is None:
            self._bufs = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in params]
        for b, p in zip(self._bufs, params):
            b.copy_(p, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def refresh(self) -> None:
        """Take numpy copies of the parameters the last `start_sync` began
        copying."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        self.layers = _pairs([b.numpy().copy() for b in self._bufs])

    def _forward(self, obs):
        h = _forward(self.layers, self.act, obs)
        mean = h[:, : self.action_size]
        log_std = np.clip(h[:, self.action_size :], LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std

    def sample(self, obs, rng: np.random.Generator) -> np.ndarray:
        """tanh(mean + eps * std), eps from the numpy generator `rng`."""
        mean, log_std = self._forward(obs)
        z = mean + rng.standard_normal(mean.shape, np.float32) * np.exp(log_std)
        return np.tanh(z)

    def greedy(self, obs) -> np.ndarray:
        return np.tanh(self._forward(obs)[0])
