"""Lacunarity pooling op (counterpart of
``neighbour_feature_pooling_tpu/ops/lacunarity.py``).

Features are mapped to ``[0, 255]`` and the normalized second moment

    L = (n² · E[x²]) / ((n · E[x])² + eps) − 1

is taken over the whole map (``kernel=None``) or over VALID windows
(``kernel``/``stride``). ``n`` counts the spatial points of the *input*
map, with the JAX package's per-rank quirks kept exactly. XLA ops in the
JAX package, stock PyTorch ops here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .fractal import _compute_dtype

__all__ = ["base_lacunarity"]

_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _avg_pool(x: torch.Tensor, kernel: Tuple[int, ...], stride: Tuple[int, ...]) -> torch.Tensor:
    """VALID average pool over the spatial axes (1..ndim-2) of a
    channels-last tensor."""
    nd = x.ndim - 2
    if len(kernel) != nd or len(stride) != nd:
        raise ValueError(f"kernel {kernel} and stride {stride} need {nd} spatial axes")
    perm = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
    back = (0,) + tuple(range(2, x.ndim)) + (1,)
    pooled = _AVG_POOL[nd](x.permute(perm), tuple(kernel), tuple(stride))
    return pooled.permute(back)


def base_lacunarity(
    x: torch.Tensor,
    kernel: Optional[Tuple[int, ...]] = None,
    stride: Optional[Tuple[int, ...]] = None,
    eps: float = 1e-6,
    keep_spatial: bool = False,
) -> torch.Tensor:
    """Lacunarity of a channels-last feature map.

    Args:
      x: ``(B, *spatial, C)`` with 1, 2 or 3 spatial axes.
      kernel/stride: local windowed variant; ``None`` = global.
      eps: stability constant.
      keep_spatial: if True return the windowed map ``(B, *spatial', C)``;
        otherwise the windowed values are averaged to ``(B, C)``.

    Returns:
      Lacunarity values in ``x``'s dtype, ``(B, C)`` for the global variant.
    """
    if not 3 <= x.ndim <= 5:
        raise ValueError(f"expected (B, *spatial, C) with 1-3 spatial axes, got shape "
                         f"{tuple(x.shape)}")
    spatial_axes = tuple(range(1, x.ndim - 1))
    xf = x.to(_compute_dtype(x.dtype))

    # (tanh(x)+1)/2 as the identical sigmoid(2x): at negative saturation
    # tanh(x)+1 cancels in fp32, sigmoid does not
    xn = torch.sigmoid(2.0 * xf) * 255.0

    # n as the JAX package counts it: (B, L, C) → L·C, (B, D, H, W, C) →
    # H·W, (B, H, W, C) → H·W (the reference's np.prod(shape[-2:]) of its
    # channels-first tensor)
    if x.ndim == 3:
        n_pts = float(x.shape[1] * x.shape[2])
    elif x.ndim == 5:
        n_pts = float(x.shape[2] * x.shape[3])
    else:
        n_pts = float(x.shape[1] * x.shape[2])

    if kernel is None:
        ex = xn.mean(dim=spatial_axes)
        ex2 = (xn * xn).mean(dim=spatial_axes)
    else:
        stride = stride if stride is not None else kernel
        ex = _avg_pool(xn, kernel, stride)
        ex2 = _avg_pool(xn * xn, kernel, stride)

    lac = (n_pts ** 2 * ex2) / ((n_pts * ex) ** 2 + eps) - 1.0
    if kernel is not None and not keep_spatial:
        lac = lac.mean(dim=spatial_axes)
    return lac.to(x.dtype)
