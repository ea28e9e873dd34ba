"""The precision of the reference's matrix products.

The reference computes in whatever dtype its tensors hold; every product of
a field with an element operator goes through ``mm`` or ``emm``. Inside
``tf32_products()`` both factors of each product are first rounded to
TF32 (10 explicit mantissa bits, round to nearest even), which is what a
float32 product on the tensor cores reads: the reference so run is the
benchmark's control, one precision below the float32 that the
configurations state.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_TF32 = contextvars.ContextVar("tf32_products", default=False)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    if x.dtype != torch.float32:
        raise TypeError("TF32 rounding takes float32 tensors")
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def tf32_products():
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


class _TF32Product(torch.autograd.Function):
    """``f @ op`` (``op`` a constant operator) with both factors rounded to
    TF32, and its backward ``g @ op^T`` likewise: a product on the tensor
    cores both ways."""

    @staticmethod
    def forward(ctx, f, op):
        ctx.op = round_tf32(op)
        return round_tf32(f) @ ctx.op

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g) @ ctx.op.transpose(-1, -2), None


class _TF32ElementProduct(torch.autograd.Function):
    """Per-element operators (K, Np, Np) on fields (..., K, Np), TF32 both
    ways, as ``_TF32Product``."""

    @staticmethod
    def forward(ctx, M, f):
        ctx.M = round_tf32(M)
        return torch.einsum("kij,...kj->...ki", ctx.M, round_tf32(f))

    @staticmethod
    def backward(ctx, g):
        return None, torch.einsum("kij,...ki->...kj", ctx.M, round_tf32(g))


def _constant(op: torch.Tensor) -> torch.Tensor:
    if op.requires_grad:
        raise ValueError("the reference's operators take no gradient")
    return op


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A field (..., n) times a constant operator (n, m)."""
    if _TF32.get():
        return _TF32Product.apply(a, _constant(b))
    return a @ b


def emm(M: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Per-element operators (K, Np, Np) applied to fields (..., K, Np)."""
    if _TF32.get():
        return _TF32ElementProduct.apply(_constant(M), f)
    return torch.einsum("kij,...kj->...ki", M, f)
