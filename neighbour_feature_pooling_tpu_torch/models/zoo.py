"""Model zoo: backbone × texture-head composition (counterpart of
``neighbour_feature_pooling_tpu/models/zoo.py``).

Every (type, variant) pair of the JAX registry (``MODEL_VARIANTS``) is
built; ``vittiny``'s tokens become a map (``tokens_to_map``) before the
head, and ``mobilenetv3``'s standard map is the 960-channel one before
``conv_head``:

========================  ==================================================
gap_only                  backbone → GAP → fc
texture_nfp               backbone → NFPPoolingHead → fc
texture_fractal           backbone → FractalPoolingHead → fc (≥ 6×6 map)
texture_lacunarity        backbone → LacunarityPoolingHead → fc
texture_deepten           backbone → DeepTENHead → BatchNorm1d → fc(K·D)
texture_radam             backbone → RADAMHead (7², ViT 14²) → fc
texture_nfp_intermediate  stem→blocks[0..i] tap → NFPPoolingHead → fc
mid_nfp                   features tap i → NFP→GAP→Linear(1280);
                          ⊙ GAP(conv_head(last)) → fc
multi_stage_nfp           NFP on all 5 taps → concat(B,40) → Linear(1280);
                          ⊙ GAP(conv_head(last)) → fc
nfp_insert                blocks[0..i] → NFP map → 1×1 conv/BN/ReLU →
                          blocks[i+1..] → conv_head → GAP → fc
nfp_at_layer              resnet18 layer{i+1} map → NFP map (padding
                          ``nfp_padding``) → 1×1 conv/BN/ReLU → GAP → fc
gap_mlp … adaptive_fusion_nfp, se_gate
                          the legacy grid: backbone → its head → fc
========================  ==================================================

Submodule names give the reference/timm ``state_dict`` keys
(``backbone.*``, ``pool.nfp_proj.*``, ``pool.conv1.{0,2}.*``,
``encoding.{codewords,scale}``, ``bn.*``, ``nfp_proj.*``,
``nfp_mid_proj.*``, ``nfp_insert.nfp_proj.{conv,bn}.*``,
``nfp_at_layer.compress.{conv,bn}.*``, ``fc.*``) and, for the legacy grid,
the flax module names (``head.*``, ``nfp_head.*``).

The model runs in ``self.training``'s mode; in train mode the heads'
dropout draws from the ``generator`` passed to ``forward``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import nfp, num_neighbors
from ..ops.deepten import deepten_init
from .backbones.mobilenetv3 import BLOCK_OUT_CHANNELS, MobileNetV3Large
from .backbones.resnet import resnet18, resnet50
from .backbones.vit import ViT, tokens_to_map, vit_tiny_patch16_224
from .batchnorm import BatchNorm1d
from .heads import (
    AdaptiveFusionNFP,
    DeepTENHead,
    FractalPoolingHead,
    GAPMLPHead,
    GAPNFPConcatHead,
    LacunarityPoolingHead,
    MultiRadiusNFPHead,
    NFPConvMLPHead,
    NFPConvOnlyHead,
    NFPHeadMLP,
    NFPPoolingHead,
    NFPProject,
    RADAMHead,
    SEGateHead,
    SimilarityAwarePooling,
    gap2d,
)

__all__ = ["TextureModel", "get_model", "init_params", "MODEL_VARIANTS",
           "NUM_FTRS", "canonical_model_type", "check_ported"]

#: feature dims per backbone
NUM_FTRS = {
    "resnet18": 512,
    "resnet50": 2048,
    "mobilenetv3": 960,
    "vittiny": 192,
}

_MODEL_TYPE_ALIASES = {
    "mobilenetv3_large_100": "mobilenetv3",
    "vit_tiny_patch16_224": "vittiny",
}

_COMMON_VARIANTS = (
    "gap_only", "texture_fractal", "texture_nfp", "texture_lacunarity",
    "texture_deepten", "texture_radam",
)
_LEGACY_GRID = (
    "gap_mlp", "nfp_conv_only", "nfp_conv_mlp",
    "gap_nfp_conv_nomlp_concat", "gap_nfp_noconv_nomlp_concat",
    "gap_nfp_conv_mlp_concat", "gap_nfp_noconv_mlp_concat",
    "nfp_head", "multi_radius_nfp", "similarity_aware_pooling",
    "adaptive_fusion_nfp",
)

#: the JAX registry: allowed variants per model type
MODEL_VARIANTS: Dict[str, Tuple[str, ...]] = {
    "resnet18": _COMMON_VARIANTS + _LEGACY_GRID + ("nfp_at_layer", "se_gate"),
    "resnet50": _COMMON_VARIANTS,
    "mobilenetv3": _COMMON_VARIANTS + _LEGACY_GRID + (
        "nfp_insert", "texture_nfp_intermediate", "mid_nfp", "multi_stage_nfp"),
    "vittiny": _COMMON_VARIANTS + _LEGACY_GRID,
}

#: mobilenetv3 variants that read conv_head's map
_MNV3_HEAD_VARIANTS = ("mid_nfp", "multi_stage_nfp", "nfp_insert")


def canonical_model_type(model_type: str) -> str:
    mt = model_type.lower()
    return _MODEL_TYPE_ALIASES.get(mt, mt)


def check_ported(mt: str, variant: str) -> None:
    """Raise ValueError unless (``mt``, ``variant``) is a pair of the JAX
    registry, which ``get_model`` builds."""
    if mt not in MODEL_VARIANTS:
        raise ValueError(f"Unknown model_type: {mt}")
    if variant not in MODEL_VARIANTS[mt]:
        raise ValueError(f"Unknown model_variant {variant!r} for {mt}; "
                         f"allowed: {MODEL_VARIANTS[mt]}")


def _standard_head(variant: str, mt: str, c: int, radius: int, measure: str, padding: int,
                   stride: int, num_codes: int, radam_m: int) -> Tuple[str, nn.Module, int]:
    """(attribute name, head, fc input width) of a variant that reads the
    backbone's standard map of ``c`` channels (JAX zoo.py:257-330)."""
    if variant == "texture_nfp":
        return "pool", NFPPoolingHead(c, radius, measure), c
    if variant == "texture_fractal":
        return "pool", FractalPoolingHead(c, c), c
    if variant == "texture_lacunarity":
        return "pool", LacunarityPoolingHead(), c
    if variant == "texture_deepten":
        return "encoding", DeepTENHead(num_codes, c), num_codes * c
    if variant == "texture_radam":  # spatial size 7 (CNNs) / 14 (ViT)
        return "pool", RADAMHead(14 if mt == "vittiny" else 7, c, radam_m), c
    if variant == "gap_mlp":
        return "head", GAPMLPHead(c), c
    if variant == "nfp_conv_only":
        return "head", NFPConvOnlyHead(512, radius, measure, padding, stride), 512
    if variant == "nfp_conv_mlp":
        return "head", NFPConvMLPHead(512, radius, measure, padding, stride), 512
    if variant.startswith("gap_nfp_"):
        head = GAPNFPConcatHead(c, use_conv="noconv" not in variant,
                                use_mlp="nomlp" not in variant, radius=radius, measure=measure)
        return "head", head, head.out_dim
    if variant == "se_gate":
        return "head", SEGateHead(c, 512, radius, measure), c
    if variant == "nfp_head":  # the name the freeze schedule keys on
        return "nfp_head", NFPHeadMLP(c, 512, radius, measure), 512
    if variant == "multi_radius_nfp":  # the bottleneck is C, for gap + α·nfp
        return "head", MultiRadiusNFPHead(c, c, measure=measure), c
    if variant == "similarity_aware_pooling":
        return "head", SimilarityAwarePooling(radius, measure, padding), num_neighbors(radius)
    if variant == "adaptive_fusion_nfp":  # the bottleneck is C, for gap + α·nfp
        return "head", AdaptiveFusionNFP(c, c, radius, measure), c
    raise ValueError(f"Unhandled variant {variant!r}")


class TextureModel(nn.Module):
    """Backbone × texture-pooling-head classifier: NHWC images in, logits
    ``(B, num_classes)`` out. The keyword arguments are the JAX
    ``TextureModel``'s fields of the same names."""

    def __init__(self, model_type: str, model_variant: str, num_classes: int,
                 num_input_channels: int = 3, measure: str = "cosine",
                 nfp_radius: int = 1, nfp_padding: int = 0, nfp_stride: int = 1,
                 nfp_layer_idx: int = 3, nfp_insert_idx: int = 1,
                 nfp_intermediate_layer_idx: Optional[int] = 1,
                 nfp_mid_layer_idx: int = 1, num_codes: int = 32, radam_m: int = 4,
                 stem_s2d: bool = False):
        super().__init__()
        mt = canonical_model_type(model_type)
        variant = model_variant.lower()
        check_ported(mt, variant)
        self.model_type = mt
        self.model_variant = variant
        self.nfp_layer_idx = nfp_layer_idx
        self.nfp_insert_idx = nfp_insert_idx
        self.nfp_intermediate_layer_idx = nfp_intermediate_layer_idx
        self.nfp_mid_layer_idx = nfp_mid_layer_idx
        self.head_name = None  # the attribute of a standard-map head
        feat_dim = NUM_FTRS[mt]
        if mt == "resnet18":
            self.backbone = resnet18(in_chans=num_input_channels, stem_s2d=stem_s2d)
        elif mt == "resnet50":
            self.backbone = resnet50(in_chans=num_input_channels, stem_s2d=stem_s2d)
        elif mt == "vittiny":
            self.backbone = vit_tiny_patch16_224(in_chans=num_input_channels)
        elif variant == "texture_nfp_intermediate" and nfp_intermediate_layer_idx is not None:
            # the flax module stops at the tap, so later stages have no weights
            self.backbone = MobileNetV3Large(num_input_channels,
                                             last_block=nfp_intermediate_layer_idx)
            feat_dim = BLOCK_OUT_CHANNELS[nfp_intermediate_layer_idx]
        else:
            self.backbone = MobileNetV3Large(num_input_channels,
                                             head=variant in _MNV3_HEAD_VARIANTS)
        if variant in _MNV3_HEAD_VARIANTS:
            feat_dim = self.backbone.head_features
        if variant == "texture_nfp_intermediate":
            self.pool = NFPPoolingHead(feat_dim, nfp_radius, measure)
        elif variant == "mid_nfp":  # R=1 cosine: 8 values from one tap
            self.nfp_mid_proj = nn.Linear(8, feat_dim)
        elif variant == "multi_stage_nfp":  # 8 values from each of 5 taps
            self.nfp_proj = nn.Linear(40, feat_dim)
        elif variant == "nfp_insert":
            self.nfp_insert = NFPProject(BLOCK_OUT_CHANNELS[nfp_insert_idx],
                                         nfp_radius, measure, padding=nfp_padding)
        elif variant == "nfp_at_layer":  # the tap's width: 64·2^i
            feat_dim = 64 * 2 ** nfp_layer_idx
            self.nfp_at_layer = NFPConvOnlyHead(feat_dim, nfp_radius, measure, nfp_padding)
        elif variant != "gap_only":
            self.head_name, head, feat_dim = _standard_head(
                variant, mt, feat_dim, nfp_radius, measure, nfp_padding, nfp_stride,
                num_codes, radam_m)
            setattr(self, self.head_name, head)
            if variant == "texture_deepten":  # the reference's top-level key `bn`
                self.bn = BatchNorm1d(feat_dim)
        self.fc = nn.Linear(feat_dim, num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits of NHWC images; ``generator`` feeds the heads' dropout in
        train mode."""
        v = self.model_variant
        if v == "texture_nfp_intermediate":
            return self.fc(self.pool(self.backbone(
                x, stop_after_block=self.nfp_intermediate_layer_idx)))
        if v in ("mid_nfp", "multi_stage_nfp"):
            # both hard-code R=1, cosine, padding 1, whatever `measure` says
            feats, head = self.backbone(x, mode="features+head")
            if v == "mid_nfp":
                taps = [feats[self.nfp_mid_layer_idx]]
                proj = self.nfp_mid_proj
            else:
                taps, proj = feats, self.nfp_proj
            sims = torch.cat([nfp(f, 1, "cosine", padding=1, fuse_gap=True)
                              for f in taps], dim=1)
            return self.fc(gap2d(head) * proj(sims))
        if v == "nfp_insert":
            # the same backbone twice, sharing its parameters
            fmap = self.backbone(x, stop_after_block=self.nfp_insert_idx)
            fmap = self.backbone(self.nfp_insert(fmap), mode="head",
                                 start_at_block=self.nfp_insert_idx + 1)
            return self.fc(gap2d(fmap))
        if v == "nfp_at_layer":
            tap = self.backbone(x, return_stages=True)[self.nfp_layer_idx]
            return self.fc(self.nfp_at_layer(tap))
        fmap = self.backbone(x)
        if self.model_type == "vittiny":
            fmap = tokens_to_map(fmap)
        if v == "gap_only":
            return self.fc(gap2d(fmap))
        pooled = getattr(self, self.head_name)(fmap, generator)
        if v == "texture_deepten":
            pooled = self.bn(pooled)
        return self.fc(pooled)


def get_model(model_type: str, model_variant: str, num_classes: int,
              **kwargs) -> TextureModel:
    """Registry lookup, as the JAX ``get_model``."""
    return TextureModel(model_type, model_variant, num_classes, **kwargs)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization on the CPU at the JAX package's scales: conv
    and linear weights normal with std 1/sqrt(fan_in) (flax's LeCun-normal
    draws the truncated form; each third of ViT's fused qkv has fan-in D
    as each flax projection has), biases 0, BatchNorm and LayerNorm scale
    1 and shift 0, BatchNorm running mean 0 and variance 1, ViT's
    ``cls_token`` 0 and ``pos_embed`` normal with std 0.02, DeepTEN's
    codewords uniform(−1/√(K·D), 1/√(K·D)) and scale uniform(−1, 0). The
    draws differ from JAX's."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)):
            module.reset_parameters()
        elif isinstance(module, ViT):
            module.cls_token.zero_()
            module.pos_embed.copy_(0.02 * torch.randn(module.pos_embed.shape,
                                                      generator=generator))
        elif isinstance(module, DeepTENHead):
            codewords, scale = deepten_init(*module.codewords.shape, generator)
            module.codewords.copy_(codewords)
            module.scale.copy_(scale)
    return model
