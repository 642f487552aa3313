"""Neighborhood Feature Pooling (NFP): the plain PyTorch version.

Counterpart of ``neighbour_feature_pooling_tpu/ops/neighborhood.py``. For
every spatial position, compare the center feature vector with each of its
k×k−1 neighbors (k = 2·radius+1) under a selectable measure, producing a
``(B, H', W', k²−1)`` texture map. The neighborhood is read as k²−1 strided
slices of one padded NHWC tensor; the (B, H, W, N, C) neighbor tensor is
never materialized.

This is the semantics oracle: the CUDA kernels (``csrc/nfp_small.cu``,
``csrc/nfp_large.cu``, ``csrc/nfp_strip.cu``) are held against it, and the
CPU path runs it.

* neighbor ordering: row-major kernel taps minus the center;
* padding: applied symmetrically before extraction, default ``reflect``,
  with ``jnp.pad``'s semantics (see ``pad_index``);
* output size: ``(H + 2·padding − dilation·(k−1) − 1)//stride + 1``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .measures import MeasureConfig, get_measure

__all__ = [
    "nfp_reference",
    "nfp_output_size",
    "neighbor_offsets",
    "pad_index",
    "pad_spatial",
    "num_neighbors",
    "PAD_MODES",
]

#: torch padding_mode names, in the order the CUDA kernel numbers them
PAD_MODES = ("zeros", "reflect", "replicate", "circular")


def num_neighbors(radius: int) -> int:
    """k²−1 for k = 2·radius+1."""
    k = 2 * radius + 1
    return k * k - 1


def neighbor_offsets(radius: int) -> List[Tuple[int, int]]:
    """Row-major k×k kernel taps excluding the center."""
    k = 2 * radius + 1
    return [(i, j) for i in range(k) for j in range(k) if not (i == radius and j == radius)]


def nfp_output_size(size: int, radius: int, stride: int, padding: int, dilation: int) -> int:
    """Conv output arithmetic."""
    k = 2 * radius + 1
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def pad_index(i: int, n: int, padding_mode: str) -> int:
    """Source index of (possibly out-of-range) position ``i`` on an axis of
    length ``n``, as ``jnp.pad`` fills it; -1 means a zero.

    ``reflect`` is ``jnp.pad(mode="reflect")``: a reflection with period
    2(n−1) that keeps reflecting when the pad exceeds the axis, and repeats
    a length-1 axis (``F.pad`` raises on both). ``replicate`` clamps,
    ``circular`` wraps, ``zeros`` gives -1. ``csrc/nfp_measures.cuh``
    applies the same rule in the kernels' loads.
    """
    if 0 <= i < n:
        return i
    if padding_mode == "zeros":
        return -1
    if padding_mode == "replicate":
        return 0 if i < 0 else n - 1
    if padding_mode == "circular":
        return i % n
    if padding_mode == "reflect":
        if n == 1:
            return 0
        period = 2 * (n - 1)
        m = i % period
        return period - m if m >= n else m
    raise ValueError(f"Unsupported padding_mode {padding_mode!r}; "
                     f"one of {sorted(PAD_MODES)}")


def pad_spatial(x: torch.Tensor, padding: int, padding_mode: str) -> torch.Tensor:
    """Pad H and W of an NHWC tensor (a gather on each axis)."""
    if padding == 0:
        return x
    if padding_mode not in PAD_MODES:
        raise ValueError(f"Unsupported padding_mode {padding_mode!r}; "
                         f"one of {sorted(PAD_MODES)}")
    if padding_mode == "zeros":
        b, h, w, c = x.shape
        out = x.new_zeros((b, h + 2 * padding, w + 2 * padding, c))
        out[:, padding:padding + h, padding:padding + w] = x
        return out
    for axis in (1, 2):
        n = x.shape[axis]
        idx = torch.tensor([pad_index(i, n, padding_mode)
                            for i in range(-padding, n + padding)],
                           dtype=torch.long, device=x.device)
        x = torch.index_select(x, axis, idx)
    return x


def _tap(xp: torch.Tensor, i: int, j: int, h_out: int, w_out: int,
         stride: int, dilation: int) -> torch.Tensor:
    """Strided slice selecting kernel tap (i, j) for every output position."""
    hi = i * dilation
    wj = j * dilation
    return xp[:, hi: hi + (h_out - 1) * stride + 1: stride,
              wj: wj + (w_out - 1) * stride + 1: stride, :]


def _to_nhwc(x: torch.Tensor, data_format: str) -> torch.Tensor:
    if data_format == "NHWC":
        return x
    if data_format == "NCHW":
        return x.permute(0, 2, 3, 1)
    raise ValueError(f"data_format must be NHWC or NCHW, got {data_format!r}")


def _measure_config(x_nhwc: torch.Tensor, measure_name: str, eps: float,
                    p: float, q_scs: float) -> MeasureConfig:
    inv_var = None
    if measure_name == "mahalanobis":
        # diagonal covariance over each sample's spatial positions
        var = torch.var(x_nhwc, dim=(1, 2), keepdim=True, correction=0)
        inv_var = 1.0 / (var + eps)
    return MeasureConfig(eps=eps, p=p, q_scs=q_scs, inv_var=inv_var)


def nfp_reference(
    x: torch.Tensor,
    radius: int = 1,
    measure: str = "cosine",
    *,
    similarity: bool = True,
    p: float = 1.0,
    eps: float = 1e-6,
    q_scs: float = 1e-6,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    padding_mode: str = "reflect",
    data_format: str = "NHWC",
    fuse_gap: bool = False,
) -> torch.Tensor:
    """Neighborhood Feature Pooling, plain PyTorch.

    Args:
      x: feature map, ``(B, H, W, C)`` (NHWC) or ``(B, C, H, W)``.
      radius: neighborhood radius R; kernel size k = 2R+1.
      measure: one of the registered measures or aliases.
      similarity: sign convention flag.
      p: norm order / SCS sharpening exponent.
      eps / q_scs: stability constants.
      stride / padding / dilation / padding_mode: extraction geometry.
      data_format: layout of ``x``; the output matches (NHWC →
        (B,H',W',N), NCHW → (B,N,H',W')).
      fuse_gap: mean-pool over space as well, returning ``(B, N)``.

    Returns:
      The texture map, or its spatial mean when ``fuse_gap``.
    """
    xh = _to_nhwc(x, data_format)
    if xh.ndim != 4:
        raise ValueError(f"nfp expects a 4-D feature map, got shape {tuple(x.shape)}")
    b, h, w, c = xh.shape
    m = get_measure(measure)
    cfg = _measure_config(xh, m.name, eps, p, q_scs)

    xp = pad_spatial(xh, padding, padding_mode)
    h_out = nfp_output_size(h, radius, stride, padding, dilation)
    w_out = nfp_output_size(w, radius, stride, padding, dilation)
    if h_out < 1 or w_out < 1:
        raise ValueError(
            f"NFP output size {h_out}x{w_out} invalid for input {h}x{w}, "
            f"R={radius}, stride={stride}, padding={padding}, dilation={dilation}"
        )

    compute_dtype = torch.promote_types(xh.dtype, torch.float32)
    center = _tap(xp, radius, radius, h_out, w_out, stride, dilation).to(compute_dtype)

    per_neighbor = []
    for (i, j) in neighbor_offsets(radius):
        nb = _tap(xp, i, j, h_out, w_out, stride, dilation).to(compute_dtype)
        per_neighbor.append(m.pairwise(center, nb, -1, cfg))
    out = torch.stack(per_neighbor, dim=-1)  # (B, H', W', N)

    if m.needs_softmax_over_neighbors:
        out = torch.softmax(out, dim=-1)
    out = m.finalize(out, similarity)
    out = out.to(xh.dtype)

    if fuse_gap:
        return torch.mean(out, dim=(1, 2))  # (B, N)
    if data_format == "NCHW":
        return out.permute(0, 3, 1, 2)  # (B, N, H', W')
    return out
