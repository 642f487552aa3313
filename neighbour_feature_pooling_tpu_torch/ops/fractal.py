"""Fractal (differential box-counting) pooling op (counterpart of
``neighbour_feature_pooling_tpu/ops/fractal.py``).

Five VALID max-pools (kernel k = i+2, stride max(k//2, 1), i = 0..4), the
spatial sum of each, ``log2(relu(y) + 1)``, and the closed-form
least-squares slope of those five values against −log2(k): one fractal
dimension per channel. The JAX package runs it as XLA ops
(``lax.reduce_window``), outside any Pallas kernel, so the port runs stock
PyTorch ops on whatever device the input is on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["gdcb_fractal_dim", "NLV_BCD"]

#: number of box-counting levels + 1 (``NLV_BCD − 1`` max-pool scales)
NLV_BCD = 6


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """``jnp.promote_types(dtype, float32)`` for floating dtypes."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def gdcb_fractal_dim(x: torch.Tensor, nlv_bcd: int = NLV_BCD) -> torch.Tensor:
    """Differential-box-count fractal dimension per channel.

    Args:
      x: NHWC feature map ``(B, H, W, C)``.
      nlv_bcd: number of levels + 1; ``nlv_bcd − 1`` max-pool scales are used.

    Returns:
      ``(B, C)`` fractal-dimension estimates in ``x``'s dtype, computed in
      fp32 (fp64 for fp64 input).
    """
    if x.ndim != 4:
        raise ValueError(f"gdcb_fractal_dim expects NHWC, got shape {tuple(x.shape)}")
    min_side = min(x.shape[1], x.shape[2])
    if min_side < nlv_bcd:
        raise ValueError(
            f"gdcb_fractal_dim needs a feature map of at least "
            f"{nlv_bcd}x{nlv_bcd}, got {x.shape[1]}x{x.shape[2]} "
            f"(increase input_size: the final CNN map is input_size/32)")
    dtype = _compute_dtype(x.dtype)
    xc = x.to(dtype).permute(0, 3, 1, 2)  # the NCHW view of the NHWC map
    sums = []
    for i in range(nlv_bcd - 1):
        k = i + 2
        pooled = F.max_pool2d(xc, k, stride=max(k // 2, 1))
        sums.append(pooled.sum(dim=(2, 3)))                  # (B, C)
    y = torch.log2(torch.relu(torch.stack(sums, dim=-1)) + 1.0)  # (B, C, L)
    xs = torch.tensor([-math.log2(i + 2) for i in range(nlv_bcd - 1)], dtype=dtype,
                      device=x.device)
    xc_ = xs - xs.mean()
    yc = y - y.mean(dim=-1, keepdim=True)
    slope = (yc * xc_).sum(dim=-1) / (xc_ * xc_).sum()
    return slope.to(x.dtype)
