"""The tensor-parallel layout over `torch.distributed`: the port of iltpu's
`parallel.shard_params` (`iltpu/trainer.py:384-393`).

iltpu puts its whole train state on the mesh with `param_shardings`
(`jax.device_put`), and GSPMD gathers a sharded operand wherever a
computation needs it whole. The port keeps that contract with one process
(a rank) a device:

- **The state of record.** Each leaf of `convert.train_state_tree` (iltpu's
  `Trainer.state` layout) that `param_shardings` shards is held by this rank
  as its column block only, a tensor of the block's shape. A leaf's path
  names the port's tensor (`port_name`): a name of `Trainer.state_tensors()`
  or a column of the expert ring. The port's own AdamW moments, shaped like
  the weights, are not leaves of that tree (iltpu's are flat) and stay
  whole.
- **Gather, compute, keep.** A piece of work that reads sharded leaves
  (`TensorLayout.work`) all-gathers them whole (ONE collective of one flat
  buffer of its blocks, `allgather_blocks`), runs the code data parallel
  runs, then copies its block of each updated whole leaf back. Every rank
  computed the same whole values (the kernels run replicated, the gradient
  steps all-reduce), so keeping needs no collective, and the numbers are
  the data-parallel run's bit for bit.
- **Parameters** stay the tensors that the modules, the update states and
  the kernels' operand lists share: between works their storage holds 0
  bytes, and a work allocates it again and fills it from the gather.
- **Ring columns** (the replay's and the expert buffer's, `actions` where
  the mesh divides the action width) are the block itself. An append
  writes the block's columns of the new rows (`keep`); a sample takes the
  block's columns of its rows, and `whole_rows` all-gathers the whole rows.
  A work that needs the whole column (a checkpoint, the pretraining
  statistics) puts the gathered column in the ring and the block back
  after.

Every rank joins every gather. Under a CUDA-graph capture the gathers, the
copies and the whole temporaries are captured with the rest of the work;
the temporaries then live in the graph's private pool.
"""

import contextlib
import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from iltpu_torch.parallel.data import DataMesh, param_shardings
from iltpu_torch.utils.checkpoint import flatten

_SAC = {"actor": "a", "critic": "c", "target_critic": "t"}


def port_name(path: str, disc=None) -> Optional[str]:
    """The port's tensor for the leaf of `convert.train_state_tree` at
    `path` (`utils.checkpoint.flatten`'s): `sac.a[i]`, `disc.p[i]`, ...,
    `replay.<column>[0]` or `expert.<column>[0]`; None for the leaves that
    no rule of iltpu shards (counts, scalars, flat moments). `disc` is
    GAIL's discriminator, for the index of its shaping head's leaves."""
    m = re.fullmatch(r"\['sac'\]\.(actor|critic|target_critic)_params\['layers'\]\[(\d+)\]\['([wb])'\]",
                     path)
    if m:
        return f"sac.{_SAC[m[1]]}[{2 * int(m[2]) + (m[3] == 'b')}]"
    m = re.fullmatch(r"\['(replay|expert)'\]\.(\w+)", path)
    if m:
        return f"{m[1]}.{m[2]}[0]"
    m = re.fullmatch(r"\['disc'\](?:\['(g|h)'\]|\.(predictor|target))?\['layers'\]\[(\d+)\]\['([wb])'\]",
                     path)
    if m:
        i = 2 * int(m[3]) + (m[4] == "b") + (disc.ng if m[1] == "h" else 0)
        return f"disc.{'target' if m[2] == 'target' else 'p'}[{i}]"
    if path == "['disc'].expert_weights":
        return "disc.expert_weights[0]"
    return None


def allgather_blocks(blocks: Sequence[torch.Tensor], mesh: DataMesh) -> List[torch.Tensor]:
    """Every rank's blocks (float32, the same shapes on every rank), through
    ONE all-gather of one flat buffer: for a block of shape (..., c), a view
    of shape (..., N, c) whose [..., r, :] is rank r's, so that a whole
    leaf of shape (..., N c) is `whole.view(...)`'s copy of it.
    `allgather_blocks.launches` counts the collectives."""
    local = torch.cat([b.reshape(-1) for b in blocks])
    n = mesh.world_size
    out = torch.empty(n * local.numel(), dtype=local.dtype, device=local.device)
    allgather_blocks.launches += 1
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, local, group=mesh.group)
    parts, views, off = out.view(n, -1), [], 0
    for b in blocks:
        views.append(parts[:, off:off + b.numel()].reshape(n, *b.shape).movedim(0, -2))
        off += b.numel()
    return views


allgather_blocks.launches = 0


class _Leaf:
    """One sharded leaf: its block (the state of record) and where the whole
    lives during a work: `whole`, a shared tensor, or the ring's attribute."""

    def __init__(self, name: str, tensor: torch.Tensor, cols: slice, ring=None, attr=None):
        self.name, self.cols, self.ring, self.attr = name, cols, ring, attr
        self.shape = tuple(tensor.shape)
        self.block = tensor[..., cols].clone(memory_format=torch.contiguous_format)
        self.whole = None if ring is not None else tensor
        self.open = False

    def gathered(self, view: torch.Tensor) -> None:
        if self.ring is None:
            self.whole.untyped_storage().resize_(self.whole.numel() * self.whole.element_size())
            dst = self.whole
        else:
            dst = torch.empty(self.shape, dtype=self.block.dtype, device=self.block.device)
            setattr(self.ring, self.attr, dst)
        dst.view(view.shape).copy_(view)
        self.open = True

    def kept(self, write: bool) -> None:
        whole = self.whole if self.ring is None else getattr(self.ring, self.attr)
        if write:
            self.block.copy_(whole[..., self.cols])
        if self.ring is None:
            self.whole.untyped_storage().resize_(0)
        else:
            setattr(self.ring, self.attr, self.block)
        self.open = False


class TensorLayout:
    """A trainer's state laid out by `param_shardings` on its mesh (made
    once the state exists; the trainer's whole tensors are released)."""

    def __init__(self, trainer, mesh: DataMesh):
        from iltpu_torch import convert

        self.mesh = mesh
        tree = convert.train_state_tree(trainer)
        leaves, paths = flatten(tree)
        specs = flatten(param_shardings(mesh, tree))[0]
        tensors = trainer.state_tensors()
        self.leaves: Dict[str, _Leaf] = {}
        for leaf, path, cols in zip(leaves, paths, specs):
            if cols is None:
                continue
            name = port_name(path, trainer.disc)
            ring, _, col = (name or "").partition(".")
            if ring in ("replay", "expert"):
                rs, attr = getattr(trainer, ring), col[:-len("[0]")]
                t = getattr(rs, attr)
                assert t.shape[1:] == leaf.shape[1:], (path, t.shape, leaf.shape)
                self.leaves[name] = _Leaf(name, t, cols, rs, attr)
                setattr(rs, attr, self.leaves[name].block)
                continue
            t = tensors.get(name)
            if t is None:
                raise NotImplementedError(f"{path} is sharded and the port has no tensor for it")
            assert tuple(t.shape) == tuple(leaf.shape), (path, t.shape, leaf.shape)
            if not t.is_contiguous() or t.storage_offset() or \
                    t.untyped_storage().nbytes() != t.numel() * t.element_size():
                raise ValueError(f"{name} does not own its storage: it cannot be released")
            self.leaves[name] = _Leaf(name, t, cols)
            t.untyped_storage().resize_(0)

    def blocks(self) -> Dict[str, torch.Tensor]:
        """The parameters' state of record by name (the ring columns' is the
        ring's own attribute)."""
        return {n: leaf.block for n, leaf in self.leaves.items() if leaf.ring is None}

    @contextlib.contextmanager
    def work(self, *prefixes: str, write: bool = True):
        """A piece of work on the whole leaves whose names start with one of
        `prefixes` (every leaf when none): gathered on entry, in one
        collective; on exit, with `write`, this rank's block kept from each
        whole leaf; the whole tensors released. Leaves already whole (an
        enclosing work) are left to that work."""
        leaves = [leaf for n, leaf in self.leaves.items()
                  if not leaf.open and (not prefixes or n.startswith(prefixes))]
        if leaves:
            for leaf, view in zip(leaves, allgather_blocks([x.block for x in leaves], self.mesh)):
                leaf.gathered(view)
        try:
            yield
        finally:
            for leaf in leaves:
                leaf.kept(write)

    def keep(self, rs) -> Dict[str, slice]:
        """The columns of ring `rs` that hold a block now, with its columns:
        `replay_append_batch`'s `keep`."""
        return {leaf.attr: leaf.cols for leaf in self.leaves.values()
                if leaf.ring is rs and not leaf.open}

    def whole_rows(self, batches: Sequence[Dict[str, torch.Tensor]], rings: Sequence) -> None:
        """In place: each batch sampled from its ring gets the whole rows of
        the columns that hold a block (ONE all-gather for them all); a
        sharded `states` column recomputes the absorbing flag."""
        parts = [(b, k, rs) for b, rs in zip(batches, rings) for k in self.keep(rs)]
        if not parts:
            return
        views = allgather_blocks([b[k] for b, k, _ in parts], self.mesh)
        for (b, k, rs), view in zip(parts, views):
            b[k] = view.reshape(*view.shape[:-2], -1).contiguous()
            if k == "states" and rs.absorbing:
                b["absorbing"] = b["states"][:, -1].contiguous()
