"""RADAM pooling op, batched (counterpart of
``neighbour_feature_pooling_tpu/ops/radam.py``).

Each of M frozen randomized autoencoders with one hidden neuron encodes the
(C, N) feature stack, ``H = sigmoid(α X)``, and its least-squares decoder
has the closed form ``β = (H Xᵀ) / (H Hᵀ)``; the pooled vector is the sum of
the M β's. Two fp32 contractions (the JAX ones at ``Precision.HIGHEST``,
PyTorch's default float32 matmul precision) and a sigmoid, batched over B
and M.

The frozen constants are built in numpy exactly as the JAX package builds
them, so they are the same bits: the reference's LCG stream
``V[0]=1, V[t] = (75·V[t−1] + 74) mod 65537`` (the shipped
``RAE_LCG_weights.pkl``), z-scored slices of it orthogonalized by numpy's
QR with the diagonal's signs fixed, and the 2-D sin/cos positional
encoding. XLA ops in the JAX package, stock PyTorch ops here.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import safe_sqrt
from .fractal import _compute_dtype

__all__ = [
    "lcg_sequence",
    "lcg_weights",
    "make_orthogonal",
    "positional_encoding_2d",
    "radam_alphas",
    "radam_pool",
    "lp_normalize_spatial",
]

_LCG_LEN = 262144  # length of the reference's shipped sequence


@functools.lru_cache(maxsize=2)
def lcg_sequence(length: int = _LCG_LEN) -> np.ndarray:
    """The reference's LCG stream: V[0]=1, V[t]=(75·V[t−1]+74) mod 65537,
    as float32."""
    v = np.empty(length, dtype=np.int64)
    v[0] = 1
    a, b, c = 75, 74, (1 << 16) + 1
    for t in range(1, length):
        v[t] = (a * v[t - 1] + b) % c
    return v.astype(np.float32)


def lcg_weights(m: int, n: int, seed: int) -> np.ndarray:
    """Z-scored (m, n) slice of the LCG stream starting at ``seed``, with
    the unbiased std (ddof=1, ``torch.std``'s default)."""
    length = m * n
    if length == 1:
        return np.ones((1, 1), dtype=np.float32)
    v = lcg_sequence(max(_LCG_LEN, seed + length))[seed: seed + length]
    v = (v - v.mean()) / v.std(ddof=1)
    return v.reshape(m, n).astype(np.float32)


def make_orthogonal(t: np.ndarray) -> np.ndarray:
    """Orthogonalize rows or columns by numpy's QR, the signs of R's
    diagonal moved into Q."""
    rows = t.shape[0]
    cols = t.size // rows
    flat = t.reshape(rows, cols)
    transposed = rows < cols
    if transposed:
        flat = flat.T
    q, r = np.linalg.qr(flat)
    q = q * np.sign(np.diag(r))
    if transposed:
        q = q.T
    return q.astype(np.float32)


def positional_encoding_2d(d_model: int, height: int, width: int) -> np.ndarray:
    """2-D sin/cos positional encoding ``(d_model, height, width)``:
    the first half of the channels encodes the column, the second the row.
    ``d_model`` is bumped by 2 when it is not a multiple of 4 and the
    result sliced back (the reference's quirk)."""
    d_orig = d_model
    if d_model % 4 != 0:
        d_model = d_model + 2
    pe = np.zeros((d_model, height, width), dtype=np.float32)
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2) * -(math.log(10000.0) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    sin_w = np.sin(pos_w * div_term).T
    cos_w = np.cos(pos_w * div_term).T
    sin_h = np.sin(pos_h * div_term).T
    cos_h = np.cos(pos_h * div_term).T
    pe[0:half:2, :, :] = np.repeat(sin_w[:, None, :], height, axis=1)
    pe[1:half:2, :, :] = np.repeat(cos_w[:, None, :], height, axis=1)
    pe[half::2, :, :] = np.repeat(sin_h[:, :, None], width, axis=2)
    pe[half + 1::2, :, :] = np.repeat(cos_h[:, :, None], width, axis=2)
    return pe[:d_orig]


def radam_alphas(m: int, in_channels: int, q: int = 1) -> np.ndarray:
    """Frozen encoder weights of the M RAEs, ``(M, Q, P)``:
    ``alpha_i = make_orthogonal(lcg_weights(Q, P, seed=i·Q·P))``."""
    return np.stack([
        make_orthogonal(lcg_weights(q, in_channels, seed=i * (q * in_channels)))
        for i in range(m)
    ])


def lp_normalize_spatial(x: torch.Tensor, p: float = 2.0, eps: float = 1e-10) -> torch.Tensor:
    """Lp-normalize each channel of an NHWC map over (H, W)
    (``F.normalize(x, p, dim=(2, 3))`` on NCHW). p=2 takes the norm through
    ``safe_sqrt``, whose derivative at 0 is 0, so a dead (all-zero) channel
    gives a finite gradient instead of a NaN step."""
    if p == 2.0:
        norm = safe_sqrt((x * x).sum(dim=(1, 2), keepdim=True))
    elif p == 1.0:
        norm = x.abs().sum(dim=(1, 2), keepdim=True)
    else:
        norm = (x.abs() ** p).sum(dim=(1, 2), keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, eps)


def radam_pool(
    x: torch.Tensor,
    alphas: torch.Tensor,
    pos_encoding: Optional[torch.Tensor] = None,
    spatial_size: Optional[int] = None,
) -> torch.Tensor:
    """RADAM aggregation: ``(B, H, W, C) → (B, Q=1, C)``.

    Args:
      x: NHWC feature map.
      alphas: frozen encoder weights ``(M, Q, C)`` from :func:`radam_alphas`.
      pos_encoding: ``(C, N)`` additive positional encoding, or None.
      spatial_size: the side the map is resized to (bilinear with
        antialiasing, as ``jax.image.resize``) when it is not already that
        size.

    Returns:
      ``(B, Q, C)`` in ``x``'s dtype: the sum over the M RAEs of the
      closed-form decoder weights; an RAE whose hidden activations all
      underflow to 0 gives 0, with a finite gradient.
    """
    b, h, w, c = x.shape
    dtype = _compute_dtype(x.dtype)
    xf = lp_normalize_spatial(x.to(dtype))
    xs = xf.permute(0, 3, 1, 2)                           # (B, C, H, W)
    if spatial_size is not None and (h != spatial_size or w != spatial_size):
        xs = F.interpolate(xs, size=(spatial_size, spatial_size), mode="bilinear",
                           align_corners=False, antialias=True)
        h = w = spatial_size
    xs = xs.reshape(b, c, h * w)                          # (B, C, N)
    if pos_encoding is not None:
        xs = xs + pos_encoding.to(dtype)[None]

    al = alphas.to(dtype)
    m, q, _ = al.shape
    # H[b, m·q, n] = sigmoid(Σ_c α[m, q, c] X[b, c, n])
    hh = torch.sigmoid(al.reshape(m * q, c) @ xs)
    # β = (H Xᵀ) / (H Hᵀ), the least squares of one hidden neuron
    hx = hh @ xs.mT                                       # (B, M·Q, C)
    h2 = (hh * hh).sum(dim=-1, keepdim=True)              # (B, M·Q, 1)
    dead = h2 <= 0.0
    beta = torch.where(dead, torch.zeros_like(hx), hx / torch.where(dead, torch.ones_like(h2), h2))
    pooled = beta.reshape(b, m, q, c).sum(dim=1)          # (B, Q, C)
    return torch.nan_to_num(pooled).to(x.dtype)
