"""BatchNorm with flax's running statistics.

Flax's ``nn.BatchNorm`` (momentum 0.9) folds the *biased* batch variance
into its running ``var``; ``torch.nn.BatchNorm2d`` folds in the unbiased
one (× n/(n−1)). ``BatchNorm2d`` and ``BatchNorm1d`` here keep torch's
modules, parameters, buffers and eval path, and in train mode normalise
with the batch statistics and update ``running_var`` with the biased
variance, so a port model trains the running statistics the JAX package
trains.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["BatchNorm1d", "BatchNorm2d"]


class _FlaxRunningVariance:
    """The train-mode forward of a torch BatchNorm whose update of
    ``running_var`` uses the biased batch variance (flax ``nn.BatchNorm``).
    Defaults are the JAX package's: eps 1e-5, flax momentum 0.9 (= torch
    momentum 0.1)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            # invstd = 1/sqrt(var + eps), var the biased batch variance
            var = (invstd.double().pow(-2) - self.eps).clamp_min(0).to(self.running_var.dtype)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm2d(_FlaxRunningVariance, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running variance."""


class BatchNorm1d(_FlaxRunningVariance, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running variance (DeepTEN's, on the
    (B, K·D) encoding)."""
