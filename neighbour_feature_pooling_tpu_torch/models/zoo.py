"""Model zoo: backbone × texture-head composition (counterpart of
``neighbour_feature_pooling_tpu/models/zoo.py``).

Ported so far: ``resnet18`` × {``gap_only``, ``texture_nfp``}:

=============  ==========================================
gap_only       backbone → GAP → fc
texture_nfp    backbone → NFPPoolingHead → fc
=============  ==========================================

Every other (type, variant) of the JAX registry raises
``NotImplementedError`` naming its ``ROADMAP.md`` item. Submodule names
give the reference/timm ``state_dict`` keys (``backbone.*``,
``pool.nfp_proj.*``, ``fc.*``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from .backbones.resnet import resnet18
from .heads import NFPPoolingHead, gap2d

__all__ = ["TextureModel", "get_model", "init_params", "MODEL_VARIANTS",
           "NUM_FTRS", "canonical_model_type"]

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

_PORTED = {"resnet18": ("gap_only", "texture_nfp")}


def canonical_model_type(model_type: str) -> str:
    mt = model_type.lower()
    return _MODEL_TYPE_ALIASES.get(mt, mt)


def _check_ported(mt: str, variant: str) -> None:
    if mt not in MODEL_VARIANTS:
        raise ValueError(f"Unknown model_type: {mt}")
    if variant not in MODEL_VARIANTS[mt]:
        raise ValueError(f"Unknown model_variant {variant!r} for {mt}; "
                         f"allowed: {MODEL_VARIANTS[mt]}")
    if variant in _PORTED.get(mt, ()):
        return
    if mt != "resnet18":
        item = "Queue 1 item 3 (backbones, with the large-map NFP kernel K2)"
    else:
        item = "Queue 1 item 4 (other texture heads and the legacy grid)"
    raise NotImplementedError(f"{mt}/{variant} is not ported yet: ROADMAP.md {item}")


class TextureModel(nn.Module):
    """Backbone × texture-pooling-head classifier: NHWC images in, logits
    ``(B, num_classes)`` out."""

    def __init__(self, model_type: str, model_variant: str, num_classes: int,
                 num_input_channels: int = 3, measure: str = "cosine",
                 nfp_radius: int = 1, stem_s2d: bool = False):
        super().__init__()
        mt = canonical_model_type(model_type)
        variant = model_variant.lower()
        _check_ported(mt, variant)
        self.model_type = mt
        self.model_variant = variant
        feat_dim = NUM_FTRS[mt]
        self.backbone = resnet18(in_chans=num_input_channels, stem_s2d=stem_s2d)
        if variant == "texture_nfp":
            self.pool = NFPPoolingHead(feat_dim, nfp_radius, measure)
        self.fc = nn.Linear(feat_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fmap = self.backbone(x)
        if self.model_variant == "gap_only":
            return self.fc(gap2d(fmap))
        return self.fc(self.pool(fmap))


def get_model(model_type: str, model_variant: str, num_classes: int,
              **kwargs) -> TextureModel:
    """Registry lookup, as the JAX ``get_model``."""
    return TextureModel(model_type, model_variant, num_classes, **kwargs)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization on the CPU at the JAX package's scales: conv
    and linear weights normal with std 1/sqrt(fan_in) (flax's LeCun-normal
    draws the truncated form), biases 0, BatchNorm scale 1, shift 0,
    running mean 0 and variance 1. The draws differ from JAX's."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return model
