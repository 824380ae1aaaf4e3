"""Arithmetic at a named precision: the reference's float64 and the
controls' step below the configuration's float32.

``"float64"``: every operation in float64. ``"tf32"``: float32 with each
product's operands rounded to TF32's 10 stored mantissa bits (what a
float32 matmul gives with TF32 on), elementwise math in float32.
``"bfloat16"``: every operation in bfloat16, for the float32 arithmetic
that has no product (the weights, the likelihood's sums, the accept step).
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32", "bfloat16")


def dtype_of(prec: str) -> torch.dtype:
    if prec not in PRECISIONS:
        raise ValueError(f"unknown precision {prec!r}; one of {PRECISIONS}")
    return {"float64": torch.float64, "tf32": torch.float32,
            "bfloat16": torch.bfloat16}[prec]


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with TF32 operands, its backward's products too (what a
    float32 matmul and its gradient give with TF32 on)."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b at ``prec`` (operands already in its dtype)."""
    if prec == "tf32":
        return _TF32MatMul.apply(a, b)
    return a @ b


def cast(a, prec: str):
    """A tensor (or None) in the dtype of ``prec``."""
    return None if a is None else a.to(dtype_of(prec))
