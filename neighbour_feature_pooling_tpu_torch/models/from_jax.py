"""Flax variables → this package's ``state_dict``.

Turns the JAX package's ``{"params", "batch_stats"}`` tree (numpy arrays)
into the ``state_dict`` of the equivalent ``TextureModel``, so a model
trained or initialized in JAX runs here with the same weights. It is the
inverse of the JAX package's own import (``timm_port.port_resnet`` and
``timm_port.port_mobilenetv3`` with ``import_torch._head_map``):

* conv kernels HWIO → OIHW (a depthwise ``(k, k, 1, C)`` becomes
  ``(C, 1, k, k)``), Dense kernels transposed;
* BatchNorm ``scale/bias`` → ``weight/bias`` and ``mean/var`` →
  ``running_mean/running_var``, with ``num_batches_tracked`` = 0;
* flax module names → timm/reference keys: ResNet ``layer2_0`` →
  ``layer2.0``, ``downsample_conv``/``downsample_bn`` →
  ``downsample.0``/``.1``; MobileNetV3 ``blocks_2_1`` → ``blocks.2.1``,
  ``blocks_6_0_conv``/``blocks_6_0_bn`` → ``blocks.6.0.conv``/``.bn1``, and
  inside the stage-0 blocks (timm's DepthwiseSeparableConv) ``bn2`` →
  ``bn1``, ``conv_pwl`` → ``conv_pw``, ``bn3`` → ``bn2``. Head names
  (``pool.nfp_proj``, ``nfp_proj``, ``nfp_mid_proj``,
  ``nfp_insert.nfp_proj.{conv,bn}``) are the same on both sides.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "torch_module_name"]

_PARAM_LEAVES = {"scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_RENAMES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
            "blocks_6_0_conv": "blocks.6.0.conv", "blocks_6_0_bn": "blocks.6.0.bn1"}
#: MobileNetV3 stage-0 block: the JAX InvertedResidual names → timm's
#: DepthwiseSeparableConv names (one lookup each; never chained)
_STAGE0 = {"conv_dw": "conv_dw", "bn2": "bn1", "conv_pwl": "conv_pw", "bn3": "bn2"}


def _module_key(path: Tuple[str, ...]) -> str:
    parts = []
    for i, p in enumerate(path):
        if i and re.fullmatch(r"blocks_0_\d+", path[i - 1]):
            p = _STAGE0[p]
        elif p in _RENAMES:
            p = _RENAMES[p]
        else:
            p = re.sub(r"^layer(\d+)_(\d+)$", r"layer\1.\2", p)
            p = re.sub(r"^blocks_(\d+)_(\d+)$", r"blocks.\1.\2", p)
        parts.append(p)
    return ".".join(parts)


def torch_module_name(path: Tuple[str, ...]) -> str:
    """The port's module name of a JAX layer path, e.g. ``("backbone",
    "layer2_0", "downsample_conv")`` → ``"backbone.layer2.0.downsample.0"``
    (the keys of the JAX ``quant`` dicts → the port's)."""
    return _module_key(tuple(path))


def _param(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:
            return "weight", np.transpose(value, (3, 2, 0, 1))  # HWIO → OIHW
        return "weight", np.transpose(value, (1, 0))  # Dense (in, out) → (out, in)
    return _PARAM_LEAVES[name], value


def state_dict_from_flax(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Convert ``{"params": ..., "batch_stats": ...}`` to a ``state_dict``."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    for path, value in _leaves(variables["params"]):
        name, arr = _param(path[-1], np.asarray(value))
        sd[f"{_module_key(path[:-1])}.{name}"] = torch.tensor(arr, dtype=torch.float32)
    for path, value in _leaves(variables.get("batch_stats", {})):
        module = _module_key(path[:-1])
        sd[f"{module}.{_STAT_LEAVES[path[-1]]}"] = torch.tensor(
            np.asarray(value), dtype=torch.float32)
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
