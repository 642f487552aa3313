"""ResNet backbone (counterpart of ``neighbour_feature_pooling_tpu/models/
backbones/resnet.py``; timm geometry).

7×7/2 stem → BN/ReLU → 3×3/2 max-pool → 4 stages → ``(B, H/32, W/32, C)``.
Submodule names are timm's (``conv1``, ``bn1``, ``layer2.0.downsample.0``),
so reference and timm ``state_dict`` keys load with no key map.

The public layout is the JAX package's, NHWC in and out; inside, tensors
are NCHW in ``channels_last`` memory, which is the same bytes, so the
permutes at either end copy nothing and the head reads the final map as a
contiguous NHWC tensor. ResNet18 (BasicBlock ×[2,2,2,2], 512 channels
out) and ResNet50 (Bottleneck ×[3,4,6,3], 2048 channels out).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch
from torch import nn

from ..batchnorm import BatchNorm2d

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet50"]


def _bn(channels: int) -> BatchNorm2d:
    # flax momentum 0.9 (weight of the old running value) = torch 0.1
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            # flax's 1×1 "SAME" conv pads 0 at any size and stride
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                _bn(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (with the stride, timm's ResNet-B) → 1×1 to 4× the
    width, each followed by BN; ReLU after bn1, bn2 and the residual sum."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.downsample = None
        if stride != 1 or inplanes != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out_ch, 1, stride=stride, bias=False),
                _bn(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """Feature-extractor ResNet: NHWC images in, the final NHWC map out
    (or, with ``return_stages=True``, the four stages' NHWC maps).

    ``stem_s2d`` is accepted for parity with the JAX constructor, whose
    space-to-depth stem is a TPU layout rewrite of the same 7×7/2 conv with
    the same parameter; the direct conv is computed either way.
    """

    def __init__(self, block: str = "basic", layers: Sequence[int] = (2, 2, 2, 2),
                 in_chans: int = 3, stem_s2d: bool = False):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"ResNet block {block!r}: expected 'basic' or 'bottleneck'")
        blk = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(in_chans, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for i, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(blk(inplanes, planes, stride))
                inplanes = planes * blk.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor, return_stages: bool = False
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        stages = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            stages.append(x.permute(0, 2, 3, 1))
        return stages if return_stages else stages[-1]


def resnet18(in_chans: int = 3, stem_s2d: bool = False) -> ResNet:
    return ResNet(block="basic", layers=(2, 2, 2, 2), in_chans=in_chans,
                  stem_s2d=stem_s2d)


def resnet50(in_chans: int = 3, stem_s2d: bool = False) -> ResNet:
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), in_chans=in_chans,
                  stem_s2d=stem_s2d)
