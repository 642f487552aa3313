"""K1's cut of the work (``ops/nfp_cuda.py::_k1_plan``), on the CPU.

The CUDA kernel ``csrc/nfp_small.cu`` runs only on the card, where
``chip_smoke.py`` holds it against the plain version. Here the plan is
checked at the main paths' shapes and for the budget it states, and a
torch emulation of the plan (row tiles, each staging its padded window,
channel chunks, per-tile partial sums reduced in tile order) is held
against the JAX ``nfp`` (the small-map Pallas kernel in interpret mode).

Tolerance: the repo's fp32 bar, 1e-4 (sums are taken in other orders).
"""

import numpy as np
import pytest
import torch
from test_torch_nfp import GEOMETRY

from neighbour_feature_pooling_tpu import ops as jops
from neighbour_feature_pooling_tpu_torch.ops import nfp_cuda
from neighbour_feature_pooling_tpu_torch.ops.measures import get_measure
from neighbour_feature_pooling_tpu_torch.ops.neighborhood import (
    nfp_output_size, nfp_reference, pad_index)
from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import (
    _K1_MAX_TILES, _K1_SMEM_BUDGET, _k1_plan)
from test_torch_model import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _plan(shape, radius=1, padding=1, dilation=1, dtype=torch.float32):
    b, h, w, c = shape
    ho = nfp_output_size(h, radius, 1, padding, dilation)
    wo = nfp_output_size(w, radius, 1, padding, dilation)
    return _k1_plan(b, h, w, c, ho, wo, radius, dilation, dtype), ho


#: (B, H, W, C) -> (rows, n_tiles): the ResNet18 head and the MobileNetV3
#: 14² and 7² taps; as many tiles as the cap of 8 allows, at every B
MAIN_PLANS = {
    (b, s, s, c): ((1, 7) if s == 7 else (2, 7))
    for b in (1, 32, 128) for s, c in ((7, 512), (14, 112), (7, 960))
}


@pytest.mark.parametrize("shape", sorted(MAIN_PLANS))
def test_k1_plan_main_shapes(shape):
    plan, _ = _plan(shape)
    assert (plan.rows, plan.n_tiles) == MAIN_PLANS[shape]
    # whole channels; 4 lanes per pair, which takes a block's pairs in one
    # round at 7² (56 pairs) and in four at 14² (224)
    assert plan.chunk == shape[3] and plan.group == 4


def _geometry_shapes():
    """Every GEOMETRY map in NHWC at its own C and at 2048 and 768, R=2
    cases at their dilation and padding, stride taken as 1."""
    out = []
    for name, (shape, kw) in sorted(GEOMETRY.items()):
        b, h, w, c = ((shape[0], shape[2], shape[3], shape[1])
                      if kw.get("data_format") == "NCHW" else shape)
        for cc in (c, 2048, 768):
            out.append((f"{name}-C{cc}", (b, h, w, cc), kw["radius"], kw["padding"],
                        kw.get("dilation", 1)))
    return out


def test_k1_plan_lanes_follow_pairs():
    """A block with few pairs spreads its lanes: 8 pairs of a 1×1 map take
    32 lanes each, 16 pairs of a 2-wide row 16."""
    assert _plan((32, 1, 1, 512))[0].group == 32
    assert _plan((32, 2, 2, 512))[0].group == 16
    assert _plan((4, 1, 1, 12))[0].group == 4  # 3 vectors a pixel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_plan_budget_and_exact_chunks(dtype):
    vec = 4 if dtype == torch.float32 else 8
    for name, shape, radius, padding, dilation in _geometry_shapes():
        plan, ho = _plan(shape, radius, padding, dilation, dtype)
        c = shape[3]
        assert plan.smem_bytes <= _K1_SMEM_BUDGET, name
        assert 1 <= plan.n_tiles <= _K1_MAX_TILES, name
        assert plan.n_tiles == -(-ho // plan.rows), name
        assert c % plan.chunk == 0, name
        assert c % vec or plan.chunk % vec == 0, name
        assert plan.group in (4, 8, 16, 32), name


def _window(x, oh0, rows, wc, padding, padding_mode):
    """The padded window a K1 block stages: rows oh0 - padding on, all
    wc padded columns, through pad_index; zeros where it gives -1."""
    _, h, w, _ = x.shape
    src_r = [pad_index(oh0 + u - padding, h, padding_mode) for u in range(rows)]
    src_c = [pad_index(v - padding, w, padding_mode) for v in range(wc)]
    win = x[:, [max(i, 0) for i in src_r]][:, :, [max(j, 0) for j in src_c]].clone()
    win[:, [u for u, i in enumerate(src_r) if i < 0]] = 0
    win[:, :, [v for v, j in enumerate(src_c) if j < 0]] = 0
    return win


def _pearson_chunked(win, radius, dilation, chunk, similarity, eps):
    """pearson on a staged window as K1 takes it: each pixel's mean from
    its chunk sums in chunk order, then the centred sums in chunk order."""
    _, wr, wc, c = win.shape
    span, r = 2 * radius * dilation, radius * dilation
    rows, wo = wr - span, wc - span
    sums = sum(win[..., c0:c0 + chunk].sum(-1) for c0 in range(0, c, chunk))
    centred = win - (sums / c)[..., None]
    k = 2 * radius + 1
    taps = [(i, j) for i in range(k) for j in range(k) if (i, j) != (radius, radius)]
    cen = centred[:, r:r + rows, r:r + wo]
    vals = []
    for i, j in taps:
        nb = centred[:, i * dilation:i * dilation + rows, j * dilation:j * dilation + wo]
        s0, s1, s2 = (sum(t[..., c0:c0 + chunk].sum(-1) for c0 in range(0, c, chunk))
                      for t in (cen * nb, cen * cen, nb * nb))
        vals.append(s0 / torch.sqrt(s1 * s2 + eps))
    return get_measure("pearson").finalize(torch.stack(vals, -1), similarity)


def _emulate_k1(x, radius, measure, *, padding, dilation, padding_mode, fuse_gap,
                similarity=True, eps=1e-6):
    """K1's plan in torch: per row tile, stage the padded window, take the
    pair values on it at padding 0, sum them per tile, reduce in tile order."""
    b, h, w, c = x.shape
    ho = nfp_output_size(h, radius, 1, padding, dilation)
    wo = nfp_output_size(w, radius, 1, padding, dilation)
    plan = _k1_plan(b, h, w, c, ho, wo, radius, dilation, x.dtype)
    span = 2 * radius * dilation
    tiles = []
    for t in range(plan.n_tiles):
        oh0 = t * plan.rows
        rows = min(plan.rows, ho - oh0)
        win = _window(x, oh0, rows + span, wo + span, padding, padding_mode)
        if measure == "pearson":
            vals = _pearson_chunked(win, radius, dilation, plan.chunk, similarity, eps)
        else:
            vals = nfp_reference(win, radius, measure, similarity=similarity, eps=eps,
                                 dilation=dilation)
        assert vals.shape[1:3] == (rows, wo)
        tiles.append(vals.flatten(1, 2).sum(1) if fuse_gap else vals)
    if not fuse_gap:
        return torch.cat(tiles, dim=1), plan
    total = tiles[0]
    for part in tiles[1:]:
        total = total + part
    return total / (ho * wo), plan


EMULATION_CASES = {
    "1x1_reflect": ((2, 1, 1, 16), "cosine", dict(radius=1, padding=1, fuse_gap=True)),
    "2x2_zeros": ((2, 2, 2, 16), "cosine", dict(radius=1, padding=1,
                                                padding_mode="zeros")),
    "7x7_circular_pad2": ((2, 7, 7, 16), "cosine", dict(radius=1, padding=2,
                                                        padding_mode="circular",
                                                        fuse_gap=True)),
    "14x14_r2_dil2": ((2, 14, 14, 16), "cosine", dict(radius=2, padding=4, dilation=2)),
    "13x11_ragged_last_tile": ((2, 13, 11, 16), "norm", dict(radius=1, padding=2,
                                                             padding_mode="zeros",
                                                             fuse_gap=True)),
    "pearson_chunked_C": ((2, 7, 7, 64), "pearson", dict(radius=1, padding=1,
                                                        fuse_gap=True)),
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_k1_plan_emulation_matches_jax(case, monkeypatch):
    shape, measure, kw = EMULATION_CASES[case]
    kw = dict(dict(dilation=1, padding_mode="reflect", fuse_gap=False), **kw)
    radius = kw.pop("radius")
    if case == "pearson_chunked_C":  # a budget that makes the plan chunk C
        monkeypatch.setattr(nfp_cuda, "_K1_SMEM_BUDGET", 4096)
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    got, plan = _emulate_k1(torch.from_numpy(x), radius, measure, **kw)
    if case == "pearson_chunked_C":
        assert plan.chunk < shape[3]
    if case == "13x11_ragged_last_tile":
        assert 15 % plan.rows and plan.n_tiles > 1
    want = np.asarray(jops.nfp(x, radius, measure, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
