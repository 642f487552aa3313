"""DeepTEN encoding op (counterpart of
``neighbour_feature_pooling_tpu/ops/deepten.py``).

Soft-assign residual encoding: ``a = softmax_k(−s_k · ‖x_n − c_k‖²)`` and
``E_k = Σ_n a_nk (x_n − c_k) = AᵀX − (Σ_n a_nk) c_k``. The squared distances
come from exact residuals, a few codewords at a time, in the forward and
again in the backward: the ``‖x‖² − 2x·c + ‖c‖²`` expansion loses ~1e-3 of
relative accuracy to cancellation in fp32 (``torch.cdist`` takes it above
25 rows), and the (B, N, K, D) residual tensor is never held whole (1.6 GB
for ResNet50 at B=128), not even for autograd. The contraction ``AᵀX``
is a plain fp32 matmul: the JAX one runs at ``Precision.HIGHEST``, which
is PyTorch's default float32 matmul precision (a caller that enables TF32
gets TF32 here as in the backbone). XLA ops in the JAX package, stock
PyTorch ops here.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .fractal import _compute_dtype

__all__ = ["deepten_init", "deepten_encode"]

#: residual elements held at once by the distance pass (128 MiB in fp32)
_CHUNK_ELEMENTS = 1 << 25


def deepten_init(num_codes: int, in_channels: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codewords (K, D), scale (K,)) drawn as the JAX ``deepten_init``:
    codewords uniform(−1/√(K·D), 1/√(K·D)), scale uniform(−1, 0). The
    draws differ from JAX's."""
    std = 1.0 / math.sqrt(num_codes * in_channels)
    codewords = (torch.rand((num_codes, in_channels), generator=generator, dtype=dtype)
                 * (2 * std) - std)
    scale = torch.rand((num_codes,), generator=generator, dtype=dtype) - 1.0
    return codewords, scale


def _codeword_chunks(x: torch.Tensor, k: int):
    b, n, d = x.shape
    step = max(1, min(k, _CHUNK_ELEMENTS // max(1, b * n * d)))
    return [(i, min(i + step, k)) for i in range(0, k, step)]


class _SquaredDistances(torch.autograd.Function):
    """``dist[b, n, k] = Σ_d (x[b, n, d] − c[k, d])²`` from exact residuals,
    a chunk of codewords at a time; the backward recomputes the residuals
    chunk by chunk instead of saving them."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.save_for_backward(x, c)
        out = []
        for lo, hi in _codeword_chunks(x, c.shape[0]):
            r = x[:, :, None, :] - c[None, None, lo:hi, :]   # (B, N, kc, D)
            out.append((r * r).sum(dim=-1))
        return torch.cat(out, dim=-1)                          # (B, N, K)

    @staticmethod
    def backward(ctx, g):
        x, c = ctx.saved_tensors
        gx = torch.zeros_like(x) if ctx.needs_input_grad[0] else None
        gc = torch.empty_like(c) if ctx.needs_input_grad[1] else None
        for lo, hi in _codeword_chunks(x, c.shape[0]):
            r = x[:, :, None, :] - c[None, None, lo:hi, :]
            gr = 2.0 * g[:, :, lo:hi, None] * r                # (B, N, kc, D)
            if gx is not None:
                gx += gr.sum(dim=2)
            if gc is not None:
                gc[lo:hi] = -gr.sum(dim=(0, 1))
        return gx, gc


def deepten_encode(x: torch.Tensor, codewords: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Soft-assign residual encoding.

    Args:
      x: features ``(B, N, D)`` (N = flattened spatial positions).
      codewords: ``(K, D)`` learnable codebook.
      scale: ``(K,)`` learnable smoothing factors.

    Returns:
      ``(B, K·D)`` flattened residual encoding in ``x``'s dtype.
    """
    if x.ndim != 3:
        raise ValueError(f"deepten_encode expects (B, N, D), got {tuple(x.shape)}")
    dtype = _compute_dtype(x.dtype)
    xf, c, s = x.to(dtype), codewords.to(dtype), scale.to(dtype)
    b, _, d = xf.shape
    k = c.shape[0]
    dist = _SquaredDistances.apply(xf, c)                     # (B, N, K)
    a = torch.softmax(-s * dist, dim=2)
    ax = a.transpose(1, 2) @ xf                               # (B, K, D)
    e = ax - a.sum(dim=1)[..., None] * c[None]
    return e.reshape(b, k * d).to(x.dtype)
