"""Host-side image transforms (numpy/PIL).

A copy of ``neighbour_feature_pooling_tpu/data/transforms.py``, kept here
so this package imports nothing of the JAX package: the train path
(Resize → RandomResizedCrop → HFlip → Normalize, and its crop plan
``plan_train``) draws from the numpy ``Generator`` in the same calls and
order, and the eval path (Resize → CenterCrop → Normalize) is the same
arithmetic, so both give the JAX package's pixels bit for bit. Everything
operates on float32 HWC numpy arrays in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["TransformConfig", "eval_transform", "train_transform", "plan_train",
           "to_float01", "IMAGENET_MEAN", "IMAGENET_STD"]

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


def train_transform(img: np.ndarray, cfg: TransformConfig,
                    rng: np.random.Generator) -> np.ndarray:
    """Resize → RandomResizedCrop → HFlip → Normalize.

    The sampled crop box is stretched to (input_size, input_size), as
    torchvision's RandomResizedCrop does, not short-side-resized and
    re-cropped.
    """
    img = _resize(to_float01(img), cfg.resize_size)
    h, w = img.shape[:2]
    # RandomResizedCrop: sample area scale, aspect ~U(3/4, 4/3)
    for _ in range(10):
        scale = rng.uniform(*cfg.scale_range)
        ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        area = scale * h * w
        cw = int(round(np.sqrt(area * ratio)))
        ch = int(round(np.sqrt(area / ratio)))
        if cw <= w and ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            img = img[top: top + ch, left: left + cw]
            break
    else:
        img = _center_crop(img, min(h, w))
    img = _resize_to(img, cfg.input_size, cfg.input_size)
    if cfg.hflip and rng.random() < 0.5:
        img = img[:, ::-1]
    return _normalize(np.ascontiguousarray(img), cfg)


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


def plan_train(shape: Tuple[int, int], cfg: TransformConfig,
               rng: np.random.Generator) -> Tuple[Tuple[int, int, int, int], int]:
    """Source crop and flip equivalent to Resize(R)+RandomResizedCrop+HFlip,
    drawn from ``rng`` in the same calls as ``train_transform``."""
    h, w = shape
    short = min(h, w)
    s = short / cfg.resize_size  # resized -> source scale
    # truncation for the long side, matching _resize/torchvision
    rh, rw = ((cfg.resize_size, int(cfg.resize_size * w / h)) if h <= w
              else (int(cfg.resize_size * h / w), cfg.resize_size))
    for _ in range(10):
        scale = rng.uniform(*cfg.scale_range)
        ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
        area = scale * rh * rw
        cw = int(round(np.sqrt(area * ratio)))
        ch = int(round(np.sqrt(area / ratio)))
        if cw <= rw and ch <= rh:
            top = int(rng.integers(0, rh - ch + 1))
            left = int(rng.integers(0, rw - cw + 1))
            break
    else:
        ch = cw = min(rh, rw)
        top = (rh - ch) // 2
        left = (rw - cw) // 2
    # back to source coordinates, clamped
    box = (min(int(round(top * s)), h - 1), min(int(round(left * s)), w - 1),
           max(int(round(ch * s)), 1), max(int(round(cw * s)), 1))
    box = (box[0], box[1], min(box[2], h - box[0]), min(box[3], w - box[1]))
    flip = int(cfg.hflip and rng.random() < 0.5)
    return box, flip
