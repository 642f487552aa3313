"""MobileNetV3-Large-100 backbone (counterpart of ``neighbour_feature_pooling_tpu/
models/backbones/mobilenetv3.py``; the timm ``mobilenetv3_large_100``
geometry).

3×3/2 stem → BN/hard-swish → six inverted-residual stages → the 1×1
ConvBnAct to 960 (``blocks.6``) → ``(B, H/32, W/32, 960)``. ``forward``
takes the JAX module's options:

* ``mode='full'``: the 960-channel map;
* ``mode='features'``: the taps after stages 0, 1, 2 and 4 and after
  ``blocks.6`` (reductions 2, 4, 8, 16, 32; channels 16, 24, 40, 112, 960);
* ``mode='head'``: ``conv_head`` (1×1 960→1280, bias) + hard-swish;
* ``mode='features+head'``: ``(taps, head map)``;
* ``stop_after_block=i``: the output of ``blocks[i]``;
* ``start_at_block=i``: skip the stem and ``blocks[:i]`` (the input is
  then a feature map, as ``nfp_insert`` feeds it).

The constructor builds only what the model runs, as flax creates only the
parameters a call reaches: ``last_block`` is the last stage built (a
``stop_after_block`` tap), ``head`` adds ``conv_head``. Submodule names
are timm's (``conv_stem``, ``bn1``, ``blocks.{s}.{b}.*``, stage-0 blocks
``conv_dw/bn1/conv_pw/bn2``, ``blocks.6.0.conv``/``.bn1``, ``conv_head``),
so reference and timm ``state_dict`` keys load with no key map.

NHWC in and out, as in the JAX package; inside, tensors are NCHW in
``channels_last`` memory (the same bytes), so each tap reaches the NFP
kernels as a contiguous NHWC tensor with no copy.

Not ported: the JAX module's ``NFP_TPU_DW_SHIFTED`` depthwise conv (a
retired TPU experiment, off by default there) and ``remat``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..batchnorm import BatchNorm2d

__all__ = ["MobileNetV3Large", "BLOCK_OUT_CHANNELS", "hard_swish", "hard_sigmoid"]


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


class BlockCfg(NamedTuple):
    kernel: int
    stride: int
    exp_ch: int
    out_ch: int
    use_se: bool
    act: str  # 're' | 'hs'


# mobilenetv3_large_100 block stages (paper Table 1 / timm arch_def); the
# final 1x1 ConvBnAct(960, hard-swish) is stage 6
_STAGES: Tuple[Tuple[BlockCfg, ...], ...] = (
    (BlockCfg(3, 1, 16, 16, False, "re"),),
    (BlockCfg(3, 2, 64, 24, False, "re"),
     BlockCfg(3, 1, 72, 24, False, "re")),
    (BlockCfg(5, 2, 72, 40, True, "re"),
     BlockCfg(5, 1, 120, 40, True, "re"),
     BlockCfg(5, 1, 120, 40, True, "re")),
    (BlockCfg(3, 2, 240, 80, False, "hs"),
     BlockCfg(3, 1, 200, 80, False, "hs"),
     BlockCfg(3, 1, 184, 80, False, "hs"),
     BlockCfg(3, 1, 184, 80, False, "hs")),
    (BlockCfg(3, 1, 480, 112, True, "hs"),
     BlockCfg(3, 1, 672, 112, True, "hs")),
    (BlockCfg(5, 2, 672, 160, True, "hs"),
     BlockCfg(5, 1, 960, 160, True, "hs"),
     BlockCfg(5, 1, 960, 160, True, "hs")),
)

#: output channels after each of the 7 block stages
BLOCK_OUT_CHANNELS = (16, 24, 40, 80, 112, 160, 960)

#: stages whose output is a features tap (blocks.6 is the fifth)
_TAP_STAGES = (0, 1, 2, 4, 6)


def _bn(channels: int) -> BatchNorm2d:
    # flax momentum 0.9 (weight of the old running value) = torch 0.1
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _act(name: str):
    return torch.relu if name == "re" else hard_swish


def _dw_conv(channels: int, cfg: BlockCfg) -> nn.Conv2d:
    # flax padding=k//2 is symmetric at stride 2 too, as torch's is
    return nn.Conv2d(channels, channels, cfg.kernel, stride=cfg.stride,
                     padding=cfg.kernel // 2, groups=channels, bias=False)


class SqueezeExcite(nn.Module):
    """Channel gate: GAP → 1×1 conv (bias) → ReLU → 1×1 conv (bias) →
    hard-sigmoid, times the input."""

    def __init__(self, channels: int, rd_ch: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, rd_ch, 1)
        self.conv_expand = nn.Conv2d(rd_ch, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        s = self.conv_expand(torch.relu(self.conv_reduce(s)))
        return x * hard_sigmoid(s)


class DepthwiseSeparableConv(nn.Module):
    """Stage-0 block (no expansion): depthwise conv/BN/act, then the
    pointwise projection/BN, with the identity shortcut. The JAX module
    names these ``conv_dw, bn2, conv_pwl, bn3``; timm ``conv_dw, bn1,
    conv_pw, bn2``."""

    def __init__(self, in_ch: int, cfg: BlockCfg):
        super().__init__()
        self.act = _act(cfg.act)
        self.conv_dw = _dw_conv(in_ch, cfg)
        self.bn1 = _bn(in_ch)
        self.conv_pw = nn.Conv2d(in_ch, cfg.out_ch, 1, bias=False)
        self.bn2 = _bn(cfg.out_ch)
        self.has_skip = cfg.stride == 1 and in_ch == cfg.out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv_dw(x)))
        y = self.bn2(self.conv_pw(y))
        return y + x if self.has_skip else y


class InvertedResidual(nn.Module):
    """1×1 expansion/BN/act → k×k depthwise/BN/act → optional SE → 1×1
    projection/BN, with the identity shortcut at stride 1 and equal
    widths."""

    def __init__(self, in_ch: int, cfg: BlockCfg):
        super().__init__()
        self.act = _act(cfg.act)
        self.conv_pw = nn.Conv2d(in_ch, cfg.exp_ch, 1, bias=False)
        self.bn1 = _bn(cfg.exp_ch)
        self.conv_dw = _dw_conv(cfg.exp_ch, cfg)
        self.bn2 = _bn(cfg.exp_ch)
        # SE reduction from the expanded width, divisible by 8
        self.se = (SqueezeExcite(cfg.exp_ch, _make_divisible(cfg.exp_ch / 4))
                   if cfg.use_se else None)
        self.conv_pwl = nn.Conv2d(cfg.exp_ch, cfg.out_ch, 1, bias=False)
        self.bn3 = _bn(cfg.out_ch)
        self.has_skip = cfg.stride == 1 and in_ch == cfg.out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.bn1(self.conv_pw(x)))
        y = self.act(self.bn2(self.conv_dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


class ConvBnAct(nn.Module):
    """``blocks.6.0``: 1×1 conv to 960, BN, hard-swish."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn1 = _bn(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hard_swish(self.bn1(self.conv(x)))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class MobileNetV3Large(nn.Module):
    """MobileNetV3-Large feature extractor with stage taps (see the module
    docstring)."""

    head_features = 1280

    def __init__(self, in_chans: int = 3, last_block: int = 6, head: bool = False):
        super().__init__()
        if not 0 <= last_block <= 6:
            raise ValueError(f"last_block must be in 0..6, got {last_block}")
        self.conv_stem = nn.Conv2d(in_chans, 16, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(16)
        stages, in_ch = [], 16
        for si, stage in enumerate(_STAGES[:last_block + 1]):
            blocks = []
            for cfg in stage:
                block = DepthwiseSeparableConv if si == 0 else InvertedResidual
                blocks.append(block(in_ch, cfg))
                in_ch = cfg.out_ch
            stages.append(nn.Sequential(*blocks))
        if last_block == 6:
            stages.append(nn.Sequential(ConvBnAct(in_ch, BLOCK_OUT_CHANNELS[6])))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = (nn.Conv2d(BLOCK_OUT_CHANNELS[6], self.head_features, 1)
                          if head else None)

    def forward(self, x: torch.Tensor, mode: str = "full",
                stop_after_block: Optional[int] = None,
                start_at_block: Optional[int] = None):
        x = _nchw(x)
        if start_at_block is None:
            x = hard_swish(self.bn1(self.conv_stem(x)))
        feats: List[torch.Tensor] = []
        for si, stage in enumerate(self.blocks):
            if start_at_block is not None and si < start_at_block:
                continue
            x = stage(x)
            if si in _TAP_STAGES:
                feats.append(x)
            if si == stop_after_block:
                return _nhwc(x)
        if stop_after_block is not None:
            raise ValueError(f"stop_after_block={stop_after_block} is past the "
                             f"{len(self.blocks)} stages built")
        if mode == "full":
            return _nhwc(x)
        if mode == "features":
            return [_nhwc(f) for f in feats]
        if mode not in ("head", "features+head"):
            raise ValueError(f"unknown mode {mode!r}")
        if self.conv_head is None:
            raise ValueError(f"mode={mode!r} needs a backbone built with head=True")
        head = _nhwc(hard_swish(self.conv_head(x)))
        if mode == "head":
            return head
        return [_nhwc(f) for f in feats], head
