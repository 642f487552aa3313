"""PyTorch backbones with timm-compatible geometry (NHWC in)."""

from .mobilenetv3 import BLOCK_OUT_CHANNELS, MobileNetV3Large  # noqa: F401
from .resnet import BasicBlock, Bottleneck, ResNet, resnet18, resnet50  # noqa: F401
from .vit import ViT, tokens_to_map, vit_tiny_patch16_224  # noqa: F401
