"""Checks shared by the kernel wrappers: where the operands lie, and that
each is a contiguous float32 tensor of the shape its kernel takes."""

from typing import Sequence

import torch


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
