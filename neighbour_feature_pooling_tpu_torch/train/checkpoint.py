"""Checkpoints (counterpart of ``neighbour_feature_pooling_tpu/train/
checkpoint.py``), in the port's own format.

A checkpoint at ``path`` is one file, ``<path>.pt``: a ``torch.save`` of
the model's ``state_dict``, the optimizer's, the step counters and, in the
middle of a ``grad_accum`` window, the gradients accumulated so far. It is
written to a temporary name in the same directory and moved into place with
``os.replace``, so a crash mid-write leaves the previous checkpoint whole.
``<path>.meta.json`` (the epoch and the val metrics) is written after the
data it describes. Saves block; the JAX package's background saves
(``async_ckpt``) are not ported.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "checkpoint_exists", "restore_checkpoint",
           "restore_for_inference"]


def _data_path(path: str) -> str:
    return os.path.abspath(path) + ".pt"


def _meta_path(path: str) -> str:
    return os.path.abspath(path) + ".meta.json"


def save_checkpoint(path: str, state, metadata: Optional[Dict] = None) -> None:
    """Save ``state`` (a ``TrainState``) to ``<path>.pt``, then ``metadata``
    to ``<path>.meta.json``."""
    target = _data_path(path)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    payload: Dict[str, Any] = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "updates": state.updates,
    }
    if state.step % state.grad_accum:
        payload["accumulated_grads"] = {n: p.grad for n, p in state.model.named_parameters()}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(target),
                               prefix=os.path.basename(target) + ".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, target)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if metadata is not None:
        with open(_meta_path(path), "w") as f:
            json.dump(metadata, f)


def checkpoint_exists(path: str) -> bool:
    """True if ``path`` names a checkpoint written by :func:`save_checkpoint`."""
    return os.path.exists(_data_path(path))


def _load(path: str) -> Dict[str, Any]:
    return torch.load(_data_path(path), map_location="cpu", weights_only=True)


def _read_meta(path: str) -> Dict:
    meta_path = _meta_path(path)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def restore_checkpoint(path: str, state) -> Tuple[Any, Dict]:
    """Restore a checkpoint into ``state`` in place (model, optimizer,
    counters and any accumulated gradients, onto the model's device).
    Returns ``(state, metadata)``."""
    payload = _load(path)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.updates = int(payload["updates"])
    accumulated = payload.get("accumulated_grads")
    for name, p in state.model.named_parameters():
        p.grad = None if accumulated is None else accumulated[name].to(p.device)
    return state, _read_meta(path)


def restore_for_inference(path: str) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` alone, on the host, whatever optimizer or
    scheduler wrote the checkpoint."""
    return _load(path)["model"]
