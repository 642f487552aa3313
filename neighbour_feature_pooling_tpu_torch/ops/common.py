"""Shared helpers for the op modules."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dequant_epilogue", "safe_sqrt"]


class _SafeSqrt(torch.autograd.Function):
    """``sqrt`` whose derivative is ``0.5 / sqrt(s)`` where ``s > 0`` and 0 at
    ``s == 0`` (the JAX custom JVP, ops/common.py:11-38)."""

    @staticmethod
    def forward(ctx, s):
        y = torch.sqrt(s)
        ctx.save_for_backward(s, y)
        return y

    @staticmethod
    def backward(ctx, g):
        s, y = ctx.saved_tensors
        pos = s > 0
        deriv = torch.where(pos, 0.5 / torch.where(pos, y, torch.ones_like(y)),
                            torch.zeros_like(y))
        return deriv * g


def safe_sqrt(s: torch.Tensor) -> torch.Tensor:
    """``sqrt`` with a zero derivative at exactly 0 (torch's norm
    subgradient convention, which the JAX version restores with a custom
    JVP).

    The plain derivative ``0.5/sqrt(s)`` is inf at 0, and any later masking
    (``clamp(norm, eps)``) multiplies that inf by a zero cotangent into NaN:
    an all-zero feature channel would poison a whole training step. The
    forward is exactly ``torch.sqrt``.
    """
    return _SafeSqrt.apply(s)


def dequant_epilogue(acc: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor], out_dtype: torch.dtype,
                     relu: bool) -> torch.Tensor:
    """The int8 kernels' epilogue in plain PyTorch (JAX common.py:44).

    ``acc.float() * scale + bias`` as two separately rounded fp32 ops
    (``scale`` and ``bias`` broadcast along the last axis), then
    ``max(·, 0)`` when ``relu``, then for an int8 ``out_dtype`` a
    saturating round to ``[-127, 127]`` (``torch.round`` rounds half to
    even, as ``jnp.round`` does). The CUDA kernels compute the same ops in
    the same order (``csrc/int8_epilogue.cuh``), so the two agree bit for
    bit.
    """
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_dtype == torch.int8:
        y = torch.clamp(torch.round(y), -127.0, 127.0)
    return y.to(out_dtype)
