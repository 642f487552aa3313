"""Background-thread batch prefetching (counterpart of
``neighbour_feature_pooling_tpu/data/prefetch.py``).

One producer thread keeps a small queue ahead of the train step, so the
host decode and augmentation of batch i+1 (and, with :func:`to_device`
mapped over the batches, its copy to the card from pinned memory) overlaps
the card's step on batch i.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, TypeVar

import numpy as np
import torch

T = TypeVar("T")

__all__ = ["prefetch", "to_device"]

_END = object()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: on a CUDA device each array
    is copied from pinned host memory with ``non_blocking=True`` (the copy
    is ordered on the current stream before the step that reads it)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch(it: Iterator[T], depth: int = 2) -> Iterator[T]:
    """Run ``it`` in a daemon thread, buffering up to ``depth`` items.

    The producer polls a stop flag while blocked on the bounded queue, so it
    exits promptly when the consumer stops iterating early (break, exception,
    generator close) instead of pinning the iterator and its buffers forever.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # surface in the consumer
            err.append(e)
        finally:
            _put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
