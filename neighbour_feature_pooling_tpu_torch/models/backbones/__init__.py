"""PyTorch backbones with timm-compatible geometry (NHWC in and out)."""

from .mobilenetv3 import BLOCK_OUT_CHANNELS, MobileNetV3Large  # noqa: F401
from .resnet import BasicBlock, ResNet, resnet18  # noqa: F401
