"""Texture-pooling heads (counterpart of ``neighbour_feature_pooling_tpu/
models/heads.py``).

Every head maps an NHWC feature map ``(B, H, W, C)`` to a pooled vector
``(B, F)``, as in the JAX package; the classification ``fc`` lives in the
model (``zoo.py``). Ported so far: ``gap2d``, ``NFPPoolingHead`` and, for
``nfp_insert``, ``NFPProject`` (which maps a map to a map).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import nfp, num_neighbors
from .batchnorm import BatchNorm2d

__all__ = ["gap2d", "NFPPoolingHead", "NFPProject"]


def gap2d(x: torch.Tensor) -> torch.Tensor:
    """Global average pool an NHWC map to (B, C)."""
    return torch.mean(x, dim=(1, 2))


class NFPPoolingHead(nn.Module):
    """``GAP(x) ⊙ Linear_{N→C}(GAP(NFP(x)))``.

    The NFP+GAP composite is one fused kernel launch (``fuse_gap=True``), so
    the (B, N, H, W) texture map is never materialized. ``padding``
    defaults to ``radius`` ("same" output size).
    """

    def __init__(self, feature_dim: int, radius: int = 1,
                 measure: str = "cosine", padding: Optional[int] = None):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.padding = radius if padding is None else padding
        self.nfp_proj = nn.Linear(num_neighbors(radius), feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_avg = gap2d(x)
        x_nfp = nfp(x, self.radius, self.measure, padding=self.padding,
                    fuse_gap=True)
        return x_avg * self.nfp_proj(x_nfp)


class _ConvBNReLU(nn.Module):
    """1×1 conv (no bias) + BN + ReLU on an NHWC map."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn = BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)  # NHWC bytes seen as channels_last NCHW
        return torch.relu(self.bn(self.conv(y))).permute(0, 2, 3, 1)


class NFPProject(nn.Module):
    """``nfp_insert`` projection: the in-backbone NFP map (N channels,
    not pooled) is projected back to the block's channel count with a
    1×1 conv + BN + ReLU so the remaining stages can consume it."""

    def __init__(self, out_channels: int, radius: int = 1,
                 measure: str = "cosine", padding: int = 0):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.padding = padding
        self.nfp_proj = _ConvBNReLU(num_neighbors(radius), out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nfp_proj(nfp(x, self.radius, self.measure, padding=self.padding))
