"""Texture-pooling heads (counterpart of ``neighbour_feature_pooling_tpu/
models/heads.py``).

Every head maps an NHWC feature map ``(B, H, W, C)`` to a pooled vector
``(B, F)``, as in the JAX package; the classification ``fc`` lives in the
model (``zoo.py``). Ported so far: ``gap2d`` and ``NFPPoolingHead``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import nfp, num_neighbors

__all__ = ["gap2d", "NFPPoolingHead"]


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
