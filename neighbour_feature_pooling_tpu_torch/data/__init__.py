"""Host-side input transforms (eval path)."""

from .transforms import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    TransformConfig,
    eval_transform,
    to_float01,
)
