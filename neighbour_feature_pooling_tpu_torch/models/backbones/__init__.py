"""PyTorch backbones with timm-compatible geometry (NHWC in and out)."""

from .resnet import BasicBlock, ResNet, resnet18  # noqa: F401
