"""K2's cut of the work (``ops/nfp_cuda.py::_k2_plan``), on the CPU.

The CUDA kernel ``csrc/nfp_large.cu`` runs only on the card, where
``chip_smoke.py`` holds it against the plain version. Here the plan is
checked at the main paths' shapes and for the budget it states, and a
torch emulation of the plan (strips and column tiles, each staging its
padded window through ``pad_index``, channel chunks, per-pixel sums, pair
sums added chunk by chunk, per-strip partial sums reduced in strip order)
is held against the JAX ``nfp_pallas`` in interpret mode, which runs the
channels-first TPU body ``_nfp_kernel_chw`` on these maps (separable
measures, more than 256 output positions).

Tolerance: the repo's fp32 bar, 1e-4 (sums are taken in other orders).
"""

import importlib

import numpy as np
import pytest
import torch
from test_torch_nfp import GEOMETRY

from neighbour_feature_pooling_tpu_torch.ops import nfp_cuda
from neighbour_feature_pooling_tpu_torch.ops.measures import (
    MeasureConfig, get_measure, get_separable)
from neighbour_feature_pooling_tpu_torch.ops.neighborhood import nfp_output_size, pad_index
from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import (
    _K2_LANE_FLOATS, _K2_MIN_BLOCKS, _K2_SMEM_BUDGET, _k2_plan)
from test_torch_model import one_torch_thread  # noqa: F401

JAX_NFP = importlib.import_module("neighbour_feature_pooling_tpu.ops.nfp_pallas")
TOL = dict(rtol=1e-4, atol=1e-4)


def _plan(shape, radius=1, padding=1, dilation=1, dtype=torch.float32, measure="cosine"):
    b, h, w, c = shape
    ho = nfp_output_size(h, radius, 1, padding, dilation)
    wo = nfp_output_size(w, radius, 1, padding, dilation)
    return _k2_plan(b, h, w, c, ho, wo, radius, dilation, dtype, measure), ho, wo


#: (B, H, W, C, padding) -> (rows, step, G): the MobileNetV3 stage taps and
#: the nfp_insert map (padding 0, 54² out), fp32. The fewest lanes whose 16
#: floats hold a pixel: 1 at C=16, 2 at C=24, 4 at C=40. Steps of 4 rows,
#: whose positions fill 1.5 rounds of lane groups, and as many steps a block
#: (up to 4) as keep 1.5 blocks per SM: 16, 8 and 4 rows at B=32 (224
#: blocks), 16 at B=128; one row at B=1, where no plan gives that many
MAIN_PLANS = {
    (1, 112, 112, 16, 1): (1, 1, 1), (1, 56, 56, 24, 1): (1, 1, 2),
    (1, 28, 28, 40, 1): (1, 1, 4), (1, 56, 56, 24, 0): (1, 1, 2),
    (32, 112, 112, 16, 1): (16, 4, 1), (32, 56, 56, 24, 1): (8, 4, 2),
    (32, 28, 28, 40, 1): (4, 4, 4), (32, 56, 56, 24, 0): (8, 4, 2),
    (128, 112, 112, 16, 1): (16, 4, 1), (128, 56, 56, 24, 1): (16, 4, 2),
    (128, 28, 28, 40, 1): (16, 4, 4), (128, 56, 56, 24, 0): (16, 4, 2),
}


@pytest.mark.parametrize("key", sorted(MAIN_PLANS))
def test_k2_plan_main_shapes(key):
    *shape, padding = key
    plan, ho, wo = _plan(tuple(shape), padding=padding)
    assert (plan.rows, plan.step, plan.group) == MAIN_PLANS[key]
    # whole channels, full-width strips
    assert plan.chunk == shape[3] and (plan.cols, plan.n_cols) == (wo, 1)
    assert plan.n_strips == -(-ho // plan.rows)
    if shape[0] == 32:  # at least 1.5 blocks per SM of the H100's 132
        assert plan.n_strips * plan.n_cols * 32 >= _K2_MIN_BLOCKS >= 1.5 * 132


def check_plan_rules(dtype, measure="cosine"):
    """Across the GEOMETRY maps, each at its own C and at 96, 128 and 256:
    shared memory within the budget, whole chunks (of whole 16-byte vectors
    where C has them), a lane's share of a pixel within its 16 floats, and a
    staged pixel stride that keeps a quarter-warp's reads on distinct banks."""
    vec = 4 if dtype == torch.float32 else 8
    for name, (shape, kw) in sorted(GEOMETRY.items()):
        b, h, w, c0 = ((shape[0], shape[2], shape[3], shape[1])
                       if kw.get("data_format") == "NCHW" else shape)
        for c in (c0, 96, 128, 256):
            plan, ho, wo = _plan((b, h, w, c), kw["radius"], kw["padding"],
                                 kw.get("dilation", 1), dtype, measure)
            label = f"{name} C={c}"
            units = -(-plan.chunk // vec)
            assert plan.smem_bytes <= _K2_SMEM_BUDGET, label
            assert c % plan.chunk == 0 and (c % vec or plan.chunk % vec == 0), label
            assert plan.group in (1, 2, 4, 8, 16, 32), label
            assert -(-units // plan.group) <= _K2_LANE_FLOATS // vec, label
            assert plan.stride >= units, label
            if plan.group < 8:  # group times an odd number of vectors
                assert plan.stride % plan.group == 0 and (plan.stride // plan.group) % 2, label
            assert plan.n_strips == -(-ho // plan.rows), label
            assert plan.n_cols == -(-wo // plan.cols), label
            assert plan.rows % plan.step == 0 or plan.rows == ho, label
            assert plan.chunk == c or plan.rows == plan.step, label  # a pass per chunk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_plan_budget_registers_and_banks(dtype):
    check_plan_rules(dtype)


def test_k2_plan_chunks_wide_channels():
    """C=256 at 56² does not fit a one-row strip whole: it is staged in 2
    chunks of 128, one step of one row a block; C=96 fits whole with 8
    lanes per position."""
    plan, _, _ = _plan((8, 56, 56, 256))
    assert (plan.chunk, plan.group, plan.rows, plan.step) == (128, 8, 1, 1)
    plan, _, _ = _plan((32, 56, 56, 96))
    assert (plan.chunk, plan.group) == (96, 8)


def window(x, oh0, ow0, rows, cols, padding, padding_mode):
    """The padded window a K2 block stages: rows oh0 - padding on and
    columns ow0 - padding on, through pad_index; zeros where it gives -1."""
    _, h, w, _ = x.shape
    src_r = [pad_index(oh0 + u - padding, h, padding_mode) for u in range(rows)]
    src_c = [pad_index(ow0 + v - padding, w, padding_mode) for v in range(cols)]
    win = x[:, [max(i, 0) for i in src_r]][:, :, [max(j, 0) for j in src_c]].clone()
    win[:, [u for u, i in enumerate(src_r) if i < 0]] = 0
    win[:, :, [v for v, j in enumerate(src_c) if j < 0]] = 0
    return win


def _block_values(win, radius, dilation, measure, chunk, cfg, similarity):
    """One block's finalized values (B, rows, cols, N) on its staged window:
    per-pixel sums and pair sums, each taken chunk by chunk in chunk order."""
    sep = get_separable(measure)
    _, wr, wc, c = win.shape
    span, r = 2 * radius * dilation, radius * dilation
    rows, cols = wr - span, wc - span
    chunks = [win[..., c0:c0 + chunk] for c0 in range(0, c, chunk)]
    if sep.n_acc == 3:  # each pixel's own sum (of squares, or of |x|)
        pix = sum(sep.map_terms(part, part, cfg)[1].sum(-1) for part in chunks)
    k = 2 * radius + 1
    vals = []
    for i in range(k):
        for j in range(k):
            if (i, j) == (radius, radius):
                continue
            ys, xs = slice(i * dilation, i * dilation + rows), slice(j * dilation, j * dilation + cols)
            cen, nb = (slice(r, r + rows), slice(r, r + cols)), (ys, xs)
            s0 = sum(sep.map_terms(part[:, cen[0], cen[1]], part[:, nb[0], nb[1]], cfg)[0].sum(-1)
                     for part in chunks)
            sums = (s0,) if sep.n_acc == 1 else (s0, pix[:, cen[0], cen[1]], pix[:, nb[0], nb[1]])
            vals.append(sep.finalize_sums(sums, c, cfg))
    return get_measure(measure).finalize(torch.stack(vals, -1), similarity)


def emulate_k2(x, radius, measure, *, padding, dilation, padding_mode, fuse_gap,
               similarity=True, p=1.0, eps=1e-6, q_scs=1e-6, block_values=_block_values):
    """K2's plan in torch (K3's with ``block_values`` for pearson): per
    (strip, column tile) block and per step of rows in it, stage the padded
    window, take its values and sum them; add a block's step sums in step
    order, and the blocks' in block order."""
    b, h, w, c = x.shape
    ho = nfp_output_size(h, radius, 1, padding, dilation)
    wo = nfp_output_size(w, radius, 1, padding, dilation)
    plan = _k2_plan(b, h, w, c, ho, wo, radius, dilation, x.dtype, measure)
    cfg = MeasureConfig(eps=eps, p=p, q_scs=q_scs)
    span = 2 * radius * dilation
    out = torch.empty((b, ho, wo, (2 * radius + 1) ** 2 - 1))
    partials = []
    for s in range(plan.n_strips):
        for t in range(plan.n_cols):
            oh0, ow0 = s * plan.rows, t * plan.cols
            rows, cols = min(plan.rows, ho - oh0), min(plan.cols, wo - ow0)
            block = None
            for h0 in range(oh0, oh0 + rows, plan.step):
                st = min(plan.step, oh0 + rows - h0)
                win = window(x, h0, ow0, st + span, cols + span, padding, padding_mode)
                vals = block_values(win, radius, dilation, measure, plan.chunk, cfg,
                                    similarity)
                assert vals.shape[1:3] == (st, cols)
                out[:, h0:h0 + st, ow0:ow0 + cols] = vals
                step_sum = vals.flatten(1, 2).sum(1)
                block = step_sum if block is None else block + step_sum
            partials.append(block)
    if not fuse_gap:
        return out, plan
    total = partials[0]
    for part in partials[1:]:
        total = total + part
    return total / (ho * wo), plan


#: shape, measure, kwargs, plan constants patched (a shared-memory budget
#: that makes the plan chunk C or cut columns; a block target that lets a
#: small batch take taller, ragged strips)
EMULATION_CASES = {
    "20x20_cosine_gap": ((2, 20, 20, 16), "cosine", dict(radius=1, padding=1, fuse_gap=True),
                         {}),
    "17x19_smith_map": ((1, 17, 19, 24), "smith", dict(radius=1, padding=1),
                        {"_K2_MIN_BLOCKS": 4}),
    "steps_cosine_gap": ((2, 22, 20, 40), "cosine", dict(radius=1, padding=1, fuse_gap=True),
                         {"_K2_MIN_BLOCKS": 4}),
    "r2_dilation2_map": ((2, 20, 20, 16), "cosine", dict(radius=2, padding=4, dilation=2),
                         {}),
    "valid_gfc_gap": ((2, 20, 20, 16), "gfc", dict(radius=1, padding=0, fuse_gap=True), {}),
    "chunked_scs_zeros": ((2, 20, 20, 32), "scs", dict(radius=1, padding=1, p=2.0,
                                                       padding_mode="zeros", fuse_gap=True),
                          {"_K2_SMEM_BUDGET": 6144}),
    "column_tiles_norm_circular": ((1, 20, 24, 8), "norm", dict(radius=1, padding=2, p=3.0,
                                                                padding_mode="circular"),
                                   {"_K2_SMEM_BUDGET": 2048}),
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_k2_plan_emulation_matches_jax(case, monkeypatch):
    shape, measure, kw, patch = EMULATION_CASES[case]
    kw = dict(dict(dilation=1, padding_mode="reflect", fuse_gap=False), **kw)
    radius = kw.pop("radius")
    for name, value in patch.items():
        monkeypatch.setattr(nfp_cuda, name, value)
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    got, plan = emulate_k2(torch.from_numpy(x), radius, measure, **kw)
    if case == "chunked_scs_zeros":
        assert plan.chunk < shape[3]
    if case == "column_tiles_norm_circular":
        assert plan.n_cols > 1
    if case == "17x19_smith_map":
        assert 17 % plan.rows and plan.n_strips > 1  # a ragged last strip
    if case == "steps_cosine_gap":
        assert plan.rows > plan.step and 22 % plan.step  # a ragged last step
    want = np.asarray(JAX_NFP.nfp_pallas(x, radius, measure, interpret=True, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
