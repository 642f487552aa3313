"""Host-side image transforms (numpy/PIL), eval path.

A copy of the eval path of ``neighbour_feature_pooling_tpu/data/
transforms.py`` (Resize → CenterCrop → Normalize), kept here so this package
imports nothing of the JAX package; the output is bit-identical to it.
Everything operates on float32 HWC numpy arrays in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["TransformConfig", "eval_transform", "to_float01",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float01(img: np.ndarray) -> np.ndarray:
    """Decoded image (uint8 [0,255] or float [0,1]) -> float32 [0,1]."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    resize_size: int = 256
    input_size: int = 224
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD
    hflip: bool = True
    scale_range: Tuple[float, float] = (0.8, 1.0)


def _resize_to(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear (antialiased, PIL) resize to an exact (nh, nw)."""
    from PIL import Image

    if (nh, nw) == img.shape[:2]:
        return img
    chans = []
    for c in range(img.shape[2]):
        pil = Image.fromarray(img[:, :, c], mode="F")
        chans.append(np.asarray(pil.resize((nw, nh), Image.BILINEAR)))
    return np.stack(chans, axis=2)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of an HWC float array so the short side == size; the
    long side truncates (``int(size * long / short)``), as torchvision's."""
    h, w = img.shape[:2]
    if h == w:
        nh = nw = size
    elif h < w:
        nh, nw = size, int(size * w / h)
    else:
        nh, nw = int(size * h / w), size
    return _resize_to(img, nh, nw)


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return img[top: top + size, left: left + size]


def _normalize(img: np.ndarray, cfg: TransformConfig) -> np.ndarray:
    c = img.shape[2]
    mean = np.asarray(cfg.mean, np.float32)
    std = np.asarray(cfg.std, np.float32)
    if mean.size != c:  # broadcast single stat to all bands (13-band EuroSAT)
        mean = np.full((c,), float(mean.mean()), np.float32)
        std = np.full((c,), float(std.mean()), np.float32)
    return (img - mean) / std


def eval_transform(img: np.ndarray, cfg: TransformConfig) -> np.ndarray:
    """Resize → CenterCrop → Normalize, always emitting input_size².

    When ``input_size > resize_size`` the centered crop covers the whole
    short side and is upscaled."""
    img = _resize(to_float01(img), cfg.resize_size)
    if cfg.input_size > min(img.shape[:2]):
        img = _center_crop(img, min(img.shape[:2]))
        img = _resize_to(img, cfg.input_size, cfg.input_size)
    else:
        img = _center_crop(img, cfg.input_size)
    return _normalize(img, cfg)
