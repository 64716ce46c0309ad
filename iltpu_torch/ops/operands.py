"""Checks shared by the kernel wrappers: where the operands lie, and that
each is a contiguous float32 tensor of the shape its kernel takes; and the
launch table that lets a wrapper check and pack its state's operands once."""

import ctypes
from typing import Optional, Sequence

import torch

_data_ptr = torch.Tensor.data_ptr


def placement(name: str, ops: Sequence[torch.Tensor]) -> str:
    """'cpu' when every operand lies on the CPU (the plain version runs),
    'cuda' when all lie on one card (the kernel launches); raises for
    anything else, never moving a tensor."""
    kinds = {t.device.type for t in ops}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds != {"cuda"} or len({t.device for t in ops}) != 1:
        raise ValueError(f"{name} operands must share one device, got {kinds}")
    return "cuda"


def check(name: str, ops: Sequence[torch.Tensor], shapes: Sequence[tuple]) -> None:
    if len(ops) != len(shapes):
        raise ValueError(f"{name}: {len(ops)} operands, want {len(shapes)}")
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{name} operand {i}: want contiguous float32 {tuple(shape)}, "
                f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )


def stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream, as
    `torch.cuda.current_stream(device).cuda_stream` gives it, without
    building a Stream object (7.2 against 0.13 us a call on an H100's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


class Table:
    """A C entry's pointer array whose head, a kernel's state, is checked
    and packed once (`bind`) and whose tail, the call's own operands and
    outputs, is written on every call (`fill`).

    The state is updated in place, so its pointers hold from call to call.
    The key is the state leaves' data pointers, as a tuple: a leaf swapped
    for another tensor (a checkpoint loaded into new tensors, a layout's
    gathered blocks) changes it, and the wrapper checks and binds again.
    `sig` is what else the state's check rested on (the batch's widths)."""

    def __init__(self):
        self.key = self.sig = self.device = self.ptrs = None
        self.head = 0

    def holds(self, state: Sequence[torch.Tensor], sig, tail: Sequence[torch.Tensor],
              shapes: Sequence[tuple]) -> bool:
        """Whether `state` is the state last bound, checked under the same
        `sig`, and each tail operand a contiguous float32 tensor of its
        shape on the bound device: then the call needs no other check."""
        if sig != self.sig or tuple(map(_data_ptr, state)) != self.key:
            return False
        dev, f32 = self.device, torch.float32
        for t, shape in zip(tail, shapes):
            if t.device != dev or t.dtype != f32 or t.shape != shape or not t.is_contiguous():
                return False
        return True

    def bind(self, state: Sequence[torch.Tensor], ptrs: Sequence[int], sig, size: int) -> None:
        """Pack a checked state: `ptrs` its pointers in the C entry's order
        (nulls included), `size` the whole array's length."""
        self.key = tuple(map(_data_ptr, state))
        self.sig, self.device, self.head = sig, state[0].device, len(ptrs)
        self.ptrs = (ctypes.c_void_p * size)(*ptrs)

    def fill(self, tensors: Sequence[Optional[torch.Tensor]]):
        """The array with the data pointers of `tensors`, the tail's operands
        and outputs (None a null pointer), written after the state's."""
        self.ptrs[self.head:] = [0 if t is None else t.data_ptr() for t in tensors]
        return self.ptrs
