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
  ``bn1``, ``conv_pwl`` → ``conv_pw``, ``bn3`` → ``bn2``; ViT ``block_3``
  → ``blocks.3``, ``patch_embed`` → ``patch_embed.proj``, and in
  ``attn`` the ``query``/``key``/``value`` projections (kernels ``(D, H,
  Dh)``, biases ``(H, Dh)``) → one ``qkv`` Linear ``(3D, D)``, queries
  first, and ``out`` (kernel ``(H, Dh, D)``) → ``proj``; the leaves
  ``cls_token`` and ``pos_embed`` keep their names;
* the heads: the fractal head's ``pool/conv1`` and ``pool/bn`` →
  ``pool.conv1.0`` and ``pool.conv1.2`` (the reference's ``Sequential(Conv2d,
  Dropout2d, BatchNorm2d)``), DeepTEN's ``encoding/bn`` → the top-level
  ``bn`` and its ``encoding/{codewords,scale}`` leaves keep their names
  (the JAX importer's table, import_torch.py:18-29). Every other head name
  (``pool.nfp_proj``, ``nfp_proj``, ``nfp_mid_proj``,
  ``nfp_insert.nfp_proj.{conv,bn}``, ``nfp_at_layer.compress.{conv,bn}``,
  the legacy grid's ``head.*`` and ``nfp_head.*``) is the same on both
  sides.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "torch_module_name", "flax_module_path"]

_PARAM_LEAVES = {"scale": "weight", "bias": "bias", "cls_token": "cls_token",
                 "pos_embed": "pos_embed"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_RENAMES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1",
            "blocks_6_0_conv": "blocks.6.0.conv", "blocks_6_0_bn": "blocks.6.0.bn1",
            "patch_embed": "patch_embed.proj"}
#: ViT attention: the flax projections (and the JAX int8 keys of the two
#: matmuls, ``proj_qkv`` and ``proj_out``) → timm's fused Linears
_QKV = ("query", "key", "value")
_ATTN = {"query": "qkv", "key": "qkv", "value": "qkv", "proj_qkv": "qkv",
         "out": "proj", "proj_out": "proj"}
#: MobileNetV3 stage-0 block: the JAX InvertedResidual names → timm's
#: DepthwiseSeparableConv names (one lookup each; never chained)
_STAGE0 = {"conv_dw": "conv_dw", "bn2": "bn1", "conv_pwl": "conv_pw", "bn3": "bn2"}
#: whole head module paths whose port names are the reference's keys
_HEADS = {("pool", "conv1"): "pool.conv1.0", ("pool", "bn"): "pool.conv1.2",
          ("encoding", "bn"): "bn"}
#: DeepTEN's own parameters, whose leaf names stay
_ENCODING = ("encoding",)


def _module_key(path: Tuple[str, ...]) -> str:
    if path in _HEADS:
        return _HEADS[path]
    parts = []
    for i, p in enumerate(path):
        if i and re.fullmatch(r"blocks_0_\d+", path[i - 1]):
            p = _STAGE0[p]
        elif i and path[i - 1] == "attn":
            p = _ATTN[p]
        elif p in _RENAMES:
            p = _RENAMES[p]
        else:
            p = re.sub(r"^layer(\d+)_(\d+)$", r"layer\1.\2", p)
            p = re.sub(r"^blocks_(\d+)_(\d+)$", r"blocks.\1.\2", p)
            p = re.sub(r"^block_(\d+)$", r"blocks.\1", p)
        parts.append(p)
    return ".".join(parts)


def torch_module_name(path: Tuple[str, ...]) -> str:
    """The port's module name of a JAX layer path, e.g. ``("backbone",
    "layer2_0", "downsample_conv")`` → ``"backbone.layer2.0.downsample.0"``
    (the keys of the JAX ``quant`` dicts → the port's)."""
    return _module_key(tuple(path))


_UNRENAMES = {v: k for k, v in _RENAMES.items()}
_UNSTAGE0 = {v: k for k, v in _STAGE0.items()}
#: no one flax module holds the fused qkv: its path names the JAX int8 key
_UNATTN = {"qkv": "proj_qkv", "proj": "out"}
_UNHEADS = {v: k for k, v in _HEADS.items()}


def flax_module_path(name: str) -> Tuple[str, ...]:
    """The JAX layer path of a port module name, the inverse of
    ``torch_module_name``: ``"backbone.layer2.0.downsample.0"`` →
    ``("backbone", "layer2_0", "downsample_conv")``. ViT's fused
    ``attn.qkv`` maps to ``("attn", "proj_qkv")``, the JAX int8 key of
    the matmul it is."""
    if name in _UNHEADS:
        return _UNHEADS[name]
    parts, path, i = name.split("."), [], 0
    while i < len(parts):
        for n in (4, 2):  # the renamed keys span 4 ("blocks.6.0.conv") or 2 parts
            key = ".".join(parts[i:i + n])
            if key in _UNRENAMES:
                path.append(_UNRENAMES[key])
                i += n
                break
        else:
            p = parts[i]
            if re.fullmatch(r"layer\d+", p) and i + 1 < len(parts) and parts[i + 1].isdigit():
                path.append(f"{p}_{parts[i + 1]}")
                i += 2
            elif p == "blocks" and i + 2 < len(parts) and not parts[i + 2].isdigit():
                path.append(f"block_{parts[i + 1]}")  # ViT: blocks.3.attn
                i += 2
            elif path and path[-1] == "attn" and p in _UNATTN:
                path.append(_UNATTN[p])
                i += 1
            elif p == "blocks" and i + 2 < len(parts):
                path.append(f"blocks_{parts[i + 1]}_{parts[i + 2]}")
                i += 3
                if parts[i - 2] == "0" and i < len(parts):  # a stage-0 block's child
                    path.append(_UNSTAGE0[parts[i]])
                    i += 1
            else:
                path.append(p)
                i += 1
    return tuple(path)


def _param(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 4:
            return "weight", np.transpose(value, (3, 2, 0, 1))  # HWIO → OIHW
        if value.ndim == 3:  # ViT attention out (H, Dh, D): a Dense from H·Dh
            value = value.reshape(-1, value.shape[-1])
        return "weight", np.transpose(value, (1, 0))  # Dense (in, out) → (out, in)
    return _PARAM_LEAVES[name], value


def _fused_qkv(leaves: Mapping[str, np.ndarray], name: str) -> Tuple[str, np.ndarray]:
    """The flax ``query``/``key``/``value`` leaves ``name`` (kernels ``(D, H,
    Dh)``, biases ``(H, Dh)``) as timm's fused ``qkv`` Linear's."""
    d = leaves["query"].shape[0] if name == "kernel" else leaves["query"].size
    parts = [leaves[k].reshape(d, -1) if name == "kernel" else leaves[k].reshape(-1)
             for k in _QKV]
    if name == "kernel":  # (D, 3D) as (in, out) → (3D, D)
        return "weight", np.transpose(np.concatenate(parts, axis=1), (1, 0))
    return "bias", np.concatenate(parts)


def state_dict_from_flax(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Convert ``{"params": ..., "batch_stats": ...}`` to a ``state_dict``."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    qkv: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for path, value in _leaves(variables["params"]):
        if len(path) > 2 and path[-2] in _QKV and path[-3] == "attn":
            group = qkv.setdefault(path[:-2] + (path[-1],), {})
            group[path[-2]] = np.asarray(value)
            if len(group) < len(_QKV):
                continue
            name, arr = _fused_qkv(group, path[-1])
        elif path[:-1] == _ENCODING:
            name, arr = path[-1], np.asarray(value)
        else:
            name, arr = _param(path[-1], np.asarray(value))
        module = _module_key(path[:-1])
        sd[f"{module}.{name}" if module else name] = torch.tensor(arr, dtype=torch.float32)
    for path, value in _leaves(variables.get("batch_stats", {})):
        module = _module_key(path[:-1])
        sd[f"{module}.{_STAT_LEAVES[path[-1]]}"] = torch.tensor(
            np.asarray(value), dtype=torch.float32)
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
