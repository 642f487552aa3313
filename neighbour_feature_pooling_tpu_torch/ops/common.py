"""Shared helpers for the op modules."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["dequant_epilogue", "safe_sqrt"]


def safe_sqrt(s: torch.Tensor) -> torch.Tensor:
    """``sqrt``; the JAX version also pins the derivative at 0 to 0.

    Only the forward is ported: it is exactly ``torch.sqrt``. The zero
    subgradient at 0 (torch's norm convention, which the JAX version
    restores with a custom JVP) comes with the training slice.
    """
    return torch.sqrt(s)


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
