"""Shared helpers for the op modules."""

from __future__ import annotations

import torch

__all__ = ["safe_sqrt"]


def safe_sqrt(s: torch.Tensor) -> torch.Tensor:
    """``sqrt``; the JAX version also pins the derivative at 0 to 0.

    Only the forward is ported: it is exactly ``torch.sqrt``. The zero
    subgradient at 0 (torch's norm convention, which the JAX version
    restores with a custom JVP) comes with the training slice.
    """
    return torch.sqrt(s)
