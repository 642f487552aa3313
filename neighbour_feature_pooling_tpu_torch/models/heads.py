"""Texture-pooling heads (counterpart of ``neighbour_feature_pooling_tpu/
models/heads.py``).

Every head maps an NHWC feature map ``(B, H, W, C)`` to a pooled vector
``(B, F)``, as in the JAX package; the classification ``fc`` lives in the
model (``zoo.py``). ``NFPProject`` (``nfp_insert``) and ``NFPBottleneck``
map a map to a map, and ``AttentionFusion`` fuses two vectors.

torch layers need their input widths, which flax infers, so the heads take
``in_channels`` (or the widths they fuse) besides the JAX fields. Submodule
names are the flax module names, so ``models.from_jax`` maps their weights
by name; the fractal head's conv and BatchNorm sit in ``conv1`` as the
reference's ``Sequential(Conv2d, Dropout2d, BatchNorm2d)`` (keys
``conv1.0.*`` and ``conv1.2.*``).

Each head's ``forward`` takes ``generator``, the ``torch.Generator`` its
dropout draws from in train mode (``models.dropout``); heads without
dropout ignore it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nfp, num_neighbors
from ..ops.deepten import deepten_encode
from ..ops.fractal import gdcb_fractal_dim
from ..ops.lacunarity import base_lacunarity
from ..ops.radam import positional_encoding_2d, radam_alphas, radam_pool
from .batchnorm import BatchNorm2d
from .dropout import Dropout

__all__ = [
    "gap2d",
    "NFPPoolingHead",
    "FractalPoolingHead",
    "LacunarityPoolingHead",
    "DeepTENHead",
    "RADAMHead",
    "GAPMLPHead",
    "NFPConvOnlyHead",
    "NFPConvMLPHead",
    "GAPNFPConcatHead",
    "NFPHeadMLP",
    "NFPHeadNoConv",
    "MultiRadiusNFPHead",
    "SEGateHead",
    "SimilarityAwarePooling",
    "AttentionFusion",
    "AdaptiveFusionNFP",
    "PositionalEncoding2D",
    "NFPBottleneck",
    "NFPProject",
]

Generator = Optional[torch.Generator]


def gap2d(x: torch.Tensor) -> torch.Tensor:
    """Global average pool an NHWC map to (B, C)."""
    return torch.mean(x, dim=(1, 2))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)  # NHWC bytes seen as channels_last NCHW


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _ConvBNReLU(nn.Module):
    """1×1 conv (no bias) + BN + ReLU on an NHWC map."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(torch.relu(self.bn(self.conv(_nchw(x)))))


def _gate(gate1: nn.Linear, gate2: nn.Linear, v: torch.Tensor) -> torch.Tensor:
    """``sigmoid(gate2(relu(gate1(v))))``."""
    return torch.sigmoid(gate2(torch.relu(gate1(v))))


# ---------------------------------------------------------------------------
# the active texture heads (texture_* variants)
# ---------------------------------------------------------------------------


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

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        x_avg = gap2d(x)
        x_nfp = nfp(x, self.radius, self.measure, padding=self.padding,
                    fuse_gap=True)
        return x_avg * self.nfp_proj(x_nfp)


class FractalPoolingHead(nn.Module):
    """``texture_fractal``: ``out = sigmoid(BN(Dropout2d(conv1x1(x)))) −
    sigmoid(x)``, then ``GAP(out) ⊙ GDCB(out)``. The map must be at least
    6×6 (``ops.fractal``); ``feature_dim`` equals ``in_channels`` for the
    residual."""

    def __init__(self, in_channels: int, feature_dim: int, dropout_ratio: float = 0.6):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(in_channels, feature_dim, 1),
                                   Dropout(dropout_ratio, channels=True),
                                   BatchNorm2d(feature_dim))

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        conv, drop, bn = self.conv1
        identity = torch.sigmoid(x)
        out = conv(_nchw(x))
        if drop.training:  # in eval the BN reads the conv's own output: int8 folds it
            out = _nchw(drop(_nhwc(out), generator))
        out = torch.sigmoid(_nhwc(bn(out))) - identity
        return gap2d(out) * gdcb_fractal_dim(out)


class LacunarityPoolingHead(nn.Module):
    """``texture_lacunarity``: ``L(x) ⊙ GAP(x)``, no learned tensors."""

    def __init__(self, eps: float = 1e-6):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        return base_lacunarity(x, eps=self.eps) * gap2d(x)


class DeepTENHead(nn.Module):
    """``texture_deepten``'s encoding: ``(B, H, W, D) → (B, K·D)`` with the
    learned ``codewords`` (K, D) and ``scale`` (K,). The BatchNorm1d that
    the JAX head applies next lives in the model, at the reference's
    top-level key ``bn`` (``zoo.TextureModel``)."""

    def __init__(self, num_codes: int, in_channels: int):
        super().__init__()
        self.codewords = nn.Parameter(torch.zeros(num_codes, in_channels))
        self.scale = nn.Parameter(torch.zeros(num_codes))

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        b, h, w, c = x.shape
        return deepten_encode(x.reshape(b, h * w, c), self.codewords, self.scale)


class RADAMHead(nn.Module):
    """``texture_radam``: frozen randomized-autoencoder aggregation →
    (B, C). The encoder weights and positional encoding are constants
    (``ops.radam``), held in buffers that the state_dict leaves out, as the
    reference keeps its RAEs outside the parameter tree."""

    def __init__(self, spatial_size: int, in_channels: int, m: int = 4,
                 pos_encoding: bool = True):
        super().__init__()
        self.spatial_size = spatial_size
        self.register_buffer("alphas", torch.from_numpy(radam_alphas(m, in_channels)),
                             persistent=False)
        pe = None
        if pos_encoding:
            pe = torch.from_numpy(positional_encoding_2d(in_channels, spatial_size, spatial_size)
                                  .reshape(in_channels, spatial_size ** 2))
        self.register_buffer("pos_encoding", pe, persistent=False)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        pooled = radam_pool(x, self.alphas, self.pos_encoding, spatial_size=self.spatial_size)
        return pooled[:, 0, :]


# ---------------------------------------------------------------------------
# the legacy ablation-grid heads
# ---------------------------------------------------------------------------


class GAPMLPHead(nn.Module):
    """``gap_mlp``: GAP gated by a sigmoid MLP, then dropout."""

    def __init__(self, feature_dim: int, dropout_p: float = 0.2):
        super().__init__()
        self.mlp1 = nn.Linear(feature_dim, feature_dim // 2)
        self.mlp2 = nn.Linear(feature_dim // 2, feature_dim)
        self.dropout = Dropout(dropout_p)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        g = gap2d(x)
        return self.dropout(g * _gate(self.mlp1, self.mlp2, g), generator)


class NFPConvOnlyHead(nn.Module):
    """``nfp_conv_only`` and ``nfp_at_layer``: the NFP map (not pooled) →
    1×1 conv + BN + ReLU to ``bottleneck_dim`` channels → GAP. ``padding``
    defaults to ``radius``; the zoo passes its ``nfp_padding`` (default 0)."""

    def __init__(self, bottleneck_dim: int = 512, radius: int = 1, measure: str = "cosine",
                 padding: Optional[int] = None, stride: int = 1):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.padding = radius if padding is None else padding
        self.stride = stride
        self.compress = _ConvBNReLU(num_neighbors(radius), bottleneck_dim)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        m = nfp(x, self.radius, self.measure, padding=self.padding, stride=self.stride)
        return gap2d(self.compress(m))


class NFPConvMLPHead(NFPConvOnlyHead):
    """``nfp_conv_mlp``: ``NFPConvOnlyHead``'s vector gated by a sigmoid MLP,
    then dropout."""

    def __init__(self, bottleneck_dim: int = 512, radius: int = 1, measure: str = "cosine",
                 padding: Optional[int] = None, stride: int = 1, dropout_p: float = 0.2):
        super().__init__(bottleneck_dim, radius, measure, padding, stride)
        self.mlp1 = nn.Linear(bottleneck_dim, bottleneck_dim // 2)
        self.mlp2 = nn.Linear(bottleneck_dim // 2, bottleneck_dim)
        self.dropout = Dropout(dropout_p)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        v = super().forward(x)
        return self.dropout(v * _gate(self.mlp1, self.mlp2, v), generator)


class GAPNFPConcatHead(nn.Module):
    """The four ``gap_nfp_{conv,noconv}_{mlp,nomlp}_concat`` variants: GAP ∥
    pooled NFP map (1×1-conv-compressed to ``bottleneck_dim`` with
    ``use_conv``), gated by a sigmoid MLP with ``use_mlp``, then dropout.
    Output width ``C + bottleneck_dim`` (conv) or ``C + N`` (noconv)."""

    def __init__(self, in_channels: int, use_conv: bool, use_mlp: bool,
                 bottleneck_dim: int = 512, radius: int = 1, measure: str = "cosine",
                 padding: Optional[int] = None, dropout_p: float = 0.2):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.padding = radius if padding is None else padding
        n = num_neighbors(radius)
        self.nfp_conv = _ConvBNReLU(n, bottleneck_dim) if use_conv else None
        self.out_dim = in_channels + (bottleneck_dim if use_conv else n)
        if use_mlp:
            self.mlp1 = nn.Linear(self.out_dim, 256)
            self.mlp2 = nn.Linear(256, self.out_dim)
        self.use_mlp = use_mlp
        self.dropout = Dropout(dropout_p)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        m = nfp(x, self.radius, self.measure, padding=self.padding)
        if self.nfp_conv is not None:
            m = self.nfp_conv(m)
        fused = torch.cat([gap2d(x), gap2d(m)], dim=1)
        if self.use_mlp:
            fused = fused * _gate(self.mlp1, self.mlp2, fused)
        return self.dropout(fused, generator)


class NFPHeadMLP(nn.Module):
    """``nfp_head``: GAP ∥ compressed NFP fused by a two-layer MLP →
    (B, bottleneck_dim). The zoo names it ``nfp_head``, which the freeze
    schedule keys on."""

    def __init__(self, in_channels: int, bottleneck_dim: int = 512, radius: int = 1,
                 measure: str = "cosine"):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.compress = _ConvBNReLU(num_neighbors(radius), bottleneck_dim)
        self.fusion_mlp1 = nn.Linear(in_channels + bottleneck_dim, bottleneck_dim)
        self.fusion_mlp2 = nn.Linear(bottleneck_dim, bottleneck_dim)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        m = self.compress(nfp(x, self.radius, self.measure, padding=self.radius))
        fused = torch.cat([gap2d(x), gap2d(m)], dim=1)
        return self.fusion_mlp2(torch.relu(self.fusion_mlp1(fused)))


class NFPHeadNoConv(nn.Module):
    """``NFPHead_NoConv``: GAP ∥ GAP(NFP) (one fused launch) → two-layer
    MLP. The MLP's input is ``C + N``: the reference's ``C + C`` assumes the
    NFP map has C channels."""

    def __init__(self, in_channels: int, out_dim: int = 512, radius: int = 1,
                 measure: str = "cosine"):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.fusion_mlp1 = nn.Linear(in_channels + num_neighbors(radius), out_dim)
        self.fusion_mlp2 = nn.Linear(out_dim, out_dim)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        nfp_vec = nfp(x, self.radius, self.measure, padding=self.radius, fuse_gap=True)
        fused = torch.cat([gap2d(x), nfp_vec], dim=1)
        return self.fusion_mlp2(torch.relu(self.fusion_mlp1(fused)))


class MultiRadiusNFPHead(nn.Module):
    """``multi_radius_nfp``: NFP maps at each radius (padding = radius)
    concatenated → 1×1 conv + BN + ReLU → GAP, fused with GAP(x) as
    ``gap + α·nfp`` by an SE gate α (``bottleneck_dim`` equals C)."""

    def __init__(self, in_channels: int, bottleneck_dim: int = 512,
                 radii: Sequence[int] = (1, 2), measure: str = "cosine"):
        super().__init__()
        self.radii = tuple(radii)
        self.measure = measure
        self.compress = _ConvBNReLU(sum(num_neighbors(r) for r in self.radii), bottleneck_dim)
        se_in = in_channels + bottleneck_dim
        self.se_gate1 = nn.Linear(se_in, se_in // 2)
        self.se_gate2 = nn.Linear(se_in // 2, 1)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        gap_vec = gap2d(x)
        cat = torch.cat([nfp(x, r, self.measure, padding=r) for r in self.radii], dim=-1)
        nfp_vec = gap2d(self.compress(cat))
        alpha = _gate(self.se_gate1, self.se_gate2, torch.cat([gap_vec, nfp_vec], dim=1))
        return gap_vec + alpha * nfp_vec


class SEGateHead(nn.Module):
    """``se_gate``: ``NFPHeadMLP`` and GAP fused as ``(1−α)·gap + α·nfp`` by
    an SE gate α, then dropout (``bottleneck_dim`` equals C)."""

    def __init__(self, in_channels: int, bottleneck_dim: int = 512, radius: int = 1,
                 measure: str = "cosine", dropout_p: float = 0.2):
        super().__init__()
        self.nfp_head = NFPHeadMLP(in_channels, bottleneck_dim, radius, measure)
        self.se_gate1 = nn.Linear(in_channels + bottleneck_dim, 256)
        self.se_gate2 = nn.Linear(256, 1)
        self.dropout = Dropout(dropout_p)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        gap_feat = gap2d(x)
        nfp_feat = self.nfp_head(x)
        alpha = _gate(self.se_gate1, self.se_gate2, torch.cat([gap_feat, nfp_feat], dim=1))
        return self.dropout((1.0 - alpha) * gap_feat + alpha * nfp_feat, generator)


class SimilarityAwarePooling(nn.Module):
    """``similarity_aware_pooling``: NFP map → 1×1-conv attention logits →
    softmax over the positions → the map's weighted sum → (B, N)."""

    def __init__(self, radius: int = 1, measure: str = "cosine", padding: int = 0):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.padding = padding
        self.att_proj = nn.Conv2d(num_neighbors(radius), 1, 1)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        m = nfp(x, self.radius, self.measure, padding=self.padding)
        b, h, w, n = m.shape
        att = torch.softmax(self.att_proj(_nchw(m)).reshape(b, h * w, 1), dim=1)
        return (m.reshape(b, h * w, n) * att).sum(dim=1)


class AttentionFusion(nn.Module):
    """``AttentionFusion``: project both vectors to ``fusion_dim``, softmax a
    2-way gate over them, convex-combine."""

    def __init__(self, gap_dim: int, nfp_dim: int, fusion_dim: int = 512):
        super().__init__()
        self.gap_proj = nn.Linear(gap_dim, fusion_dim)
        self.nfp_proj = nn.Linear(nfp_dim, fusion_dim)
        self.gate1 = nn.Linear(2 * fusion_dim, 128)
        self.gate2 = nn.Linear(128, 2)

    def forward(self, gap_vec: torch.Tensor, nfp_vec: torch.Tensor) -> torch.Tensor:
        gp, np_ = self.gap_proj(gap_vec), self.nfp_proj(nfp_vec)
        w = torch.softmax(self.gate2(torch.relu(self.gate1(torch.cat([gp, np_], dim=1)))), dim=1)
        return w[:, :1] * gp + w[:, 1:] * np_


class AdaptiveFusionNFP(nn.Module):
    """``adaptive_fusion_nfp``: GAP and compressed NFP fused as
    ``gap + α·nfp`` by an SE-style gate, then dropout (``bottleneck_dim``
    equals C)."""

    def __init__(self, in_channels: int, bottleneck_dim: int = 512, radius: int = 1,
                 measure: str = "cosine", dropout_p: float = 0.2):
        super().__init__()
        self.radius = radius
        self.measure = measure
        self.compress = _ConvBNReLU(num_neighbors(radius), bottleneck_dim)
        fusion_in = in_channels + bottleneck_dim
        self.fusion_gate1 = nn.Linear(fusion_in, fusion_in // 2)
        self.fusion_gate2 = nn.Linear(fusion_in // 2, 1)
        self.dropout = Dropout(dropout_p)

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        gap_feat = gap2d(x)
        nfp_feat = gap2d(self.compress(nfp(x, self.radius, self.measure, padding=self.radius)))
        alpha = _gate(self.fusion_gate1, self.fusion_gate2,
                      torch.cat([gap_feat, nfp_feat], dim=1))
        return self.dropout(gap_feat + alpha * nfp_feat, generator)


class PositionalEncoding2D(nn.Module):
    """Additive 2-D sin/cos positional encoding of an NHWC map: even
    channels sin over rows, odd channels cos over columns (a layout other
    than RADAM's in ``ops.radam``). Built in numpy from the map's shape, as
    the JAX module builds it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, c = x.shape
        pe = np.zeros((h, w, c), np.float32)
        y_pos = np.arange(h, dtype=np.float32)[:, None]
        x_pos = np.arange(w, dtype=np.float32)[None, :]
        div = np.exp(np.arange(0, c, 2, dtype=np.float32) * (-np.log(10000.0) / c))
        pe[:, :, 0::2] = np.sin(y_pos[..., None] * div)
        pe[:, :, 1::2] = np.cos(x_pos[..., None] * div[: c // 2])
        return x + torch.from_numpy(pe).to(device=x.device, dtype=x.dtype)[None]


class NFPBottleneck(nn.Module):
    """Residual bottleneck with NFP inside: 1×1 reduce (stride) + BN + ReLU
    → NFP (padding 0, the map shrinks by 2R) → 1×1 expand + BN; the identity
    VALID-average-pooled to the new size and, when the widths differ,
    1×1-projected + BN (``downsample``); ReLU of the sum."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1, radius: int = 1,
                 measure: str = "cosine"):
        super().__init__()
        mid = out_channels // 4
        self.radius = radius
        self.measure = measure
        self.conv1 = nn.Conv2d(in_channels, mid, 1, stride=stride, bias=False)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(num_neighbors(radius), out_channels, 1, bias=False)
        self.bn2 = BatchNorm2d(out_channels)
        self.downsample = None
        if in_channels != out_channels:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, bias=False), BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, generator: Generator = None) -> torch.Tensor:
        y = _nhwc(torch.relu(self.bn1(self.conv1(_nchw(x)))))
        y = nfp(y, self.radius, self.measure, padding=0)
        y = self.bn2(self.conv2(_nchw(y)))                    # NCHW
        identity = _nchw(x)
        if identity.shape[2] != y.shape[2]:
            k = identity.shape[2] - y.shape[2] + 1
            identity = F.avg_pool2d(identity, k, stride=1)
        if self.downsample is not None:
            identity = self.downsample(identity)
        return _nhwc(torch.relu(y + identity))


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
