"""Dropout drawn from an explicit ``torch.Generator``.

Flax's ``nn.Dropout`` draws its mask from the ``dropout`` rng the caller
passes to ``apply``; ``torch.nn.Dropout`` draws from the global generator
and cannot take one. ``Dropout`` here takes the generator as an argument
of ``forward``, so a train step's masks are a function of the run's seed
and the step (``train.engine``). The mask is drawn on the generator's
device, which is the input's in a train step. A kept element is scaled by
1/(1−p), as flax does (``where(mask, x / keep, 0)``); eval mode and
``p == 0`` return the input.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Dropout"]


class Dropout(nn.Module):
    """Dropout of rate ``p`` on an NHWC map or a (B, F) vector; with
    ``channels=True``, of whole channels of an NHWC map (flax
    ``broadcast_dims=(1, 2)``, torch's ``Dropout2d``)."""

    def __init__(self, p: float, channels: bool = False):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout rate {p} is outside [0, 1]")
        self.p = p
        self.channels = channels

    def extra_repr(self) -> str:
        return f"p={self.p}, channels={self.channels}"

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("Dropout in train mode needs a torch.Generator: pass "
                             "generator= to the model (train.engine.train_step does)")
        shape = (x.shape[0], 1, 1, x.shape[-1]) if self.channels else x.shape
        keep = 1.0 - self.p
        # drawn on the generator's device: one seed gives one mask there
        mask = torch.empty(shape, device=generator.device).bernoulli_(keep, generator=generator)
        return torch.where(mask.to(x.device, torch.bool), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))
