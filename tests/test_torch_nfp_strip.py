"""The port's direct kernel entry ``nfp_kernel`` and its K3 route against
the JAX ``nfp_pallas``, on the CPU.

Both sides get the same numpy inputs. The JAX side is ``nfp_pallas`` in
interpret mode, which runs the strip-mined TPU body ``_nfp_kernel`` (K3)
for ``pearson`` on maps above 256 positions; the port's ``nfp_kernel`` on a
CPU tensor runs its plain version. The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it against the plain version there). Which body
``nfp_pallas`` picks is read by tracing it with the three bodies wrapped.
K3 is K2's kernel template cut by ``_k2_plan``: the plan is checked for
``pearson`` here, and a torch emulation of K3's cut for ``pearson`` (strips,
steps, column tiles, channel chunks, each pixel's mean and centred sum of
squares taken chunk by chunk) is held against ``nfp_pallas``.

Tolerance: ``test_nfp_parity.py``'s kernel bar, atol 2e-5 / rtol 1e-5
(sums are taken in other orders); bf16 within one bf16 ulp.
"""

import importlib
import json

import jax
import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu_torch.ops import (
    nfp_kernel,
    nfp_large_cuda,
    nfp_reference,
    nfp_small_cuda,
    nfp_strip_cuda,
)
from neighbour_feature_pooling_tpu_torch.ops import nfp_cuda
from neighbour_feature_pooling_tpu_torch.ops.measures import get_measure
from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import (
    _K2_SMEM_BUDGET, _k2_plan, _k2_smem_bytes, _kernel_route)
from neighbour_feature_pooling_tpu_torch.tools import bench_nfp_kernel, sweep_nfp_kernel
from test_torch_nfp_large import check_plan_rules, emulate_k2
from test_torch_model import one_torch_thread  # noqa: F401

JAX_NFP = importlib.import_module("neighbour_feature_pooling_tpu.ops.nfp_pallas")
TOL = dict(atol=2e-5, rtol=1e-5)
FLAGS = [(fuse_gap, sim) for fuse_gap in (False, True) for sim in (True, False)]


def _x(shape, seed=0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) + offset).astype(np.float32)


def _jax(x, radius, measure, **kw):
    return np.asarray(JAX_NFP.nfp_pallas(x, radius, measure, interpret=True, **kw))


def _port(x, radius, measure, **kw):
    return nfp_kernel(torch.from_numpy(x), radius, measure, **kw).numpy()


@pytest.mark.parametrize("fuse_gap,similarity", FLAGS)
@pytest.mark.parametrize("channels", [8, 24])
def test_pearson_large_map_matches_jax_k3(channels, fuse_gap, similarity):
    """(2,20,20,C), R=1, reflect padding 1: 400 positions, so both sides
    take K3; the C=24 map with fuse_gap off and similarity on is offset by
    +3, which a one-pass Σxy − ΣxΣy/C form would get wrong."""
    shape = (2, 20, 20, channels)
    assert _kernel_route(shape, 1, "pearson", 1, 1) == "k3"
    offset = 3.0 if (channels, fuse_gap, similarity) == (24, False, True) else 0.0
    x = _x(shape, seed=channels, offset=offset)
    kw = dict(similarity=similarity, padding=1, fuse_gap=fuse_gap)
    want = _jax(x, 1, "pearson", **kw)
    got = _port(x, 1, "pearson", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


K3_GEOMETRY = {
    "r2_pad2": ((2, 20, 20, 8), dict(radius=2, padding=2)),
    "dilation2": ((2, 20, 20, 8), dict(radius=1, padding=2, dilation=2, fuse_gap=True)),
    "odd_21x17_circular": ((2, 21, 17, 8), dict(radius=1, padding=1, padding_mode="circular")),
    "zeros": ((2, 20, 20, 8), dict(radius=1, padding=1, padding_mode="zeros")),
    "replicate_gap": ((2, 20, 20, 8), dict(radius=1, padding=1, padding_mode="replicate",
                                           fuse_gap=True)),
    "padding0": ((2, 20, 20, 8), dict(radius=1, padding=0)),
}


@pytest.mark.parametrize("case", sorted(K3_GEOMETRY))
def test_pearson_geometry_matches_jax_k3(case):
    shape, kw = K3_GEOMETRY[case]
    kw = dict(kw)
    radius = kw.pop("radius")
    assert _kernel_route(shape, radius, "pearson", kw["padding"], kw.get("dilation", 1)) == "k3"
    x = _x(shape, seed=7)
    want = _jax(x, radius, "pearson", **kw)
    got = _port(x, radius, "pearson", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_pearson_bf16_map_within_one_ulp_of_jax_k3():
    x = _x((2, 20, 20, 8), seed=9)
    want = JAX_NFP.nfp_pallas(jax.numpy.asarray(x, jax.numpy.bfloat16), 1, "pearson",
                              padding=1, interpret=True)
    assert want.dtype == jax.numpy.bfloat16
    got = nfp_kernel(torch.from_numpy(x).to(torch.bfloat16), 1, "pearson", padding=1)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    _, exp = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    ulp = np.maximum(np.ldexp(1.0, exp - 8), 1e-5)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


# which body nfp_pallas traces: each of the three is wrapped to note its
# name, and nfp_pallas is traced (not run) once its jit caches are cleared
BODIES = {"_nfp_kernel_unrolled": "k1", "_nfp_kernel_chw": "k2", "_nfp_kernel": "k3"}


@pytest.fixture
def jax_body(monkeypatch):
    seen = []
    for name, route in BODIES.items():
        body = getattr(JAX_NFP, name)

        def spy(*args, _body=body, _route=route, **kw):
            seen.append(_route)
            return _body(*args, **kw)

        monkeypatch.setattr(JAX_NFP, name, spy)
    jax.clear_caches()

    def traced(shape, radius, measure, **kw):
        seen.clear()
        jax.eval_shape(lambda x: JAX_NFP.nfp_pallas(x, radius, measure, interpret=True, **kw),
                       jax.ShapeDtypeStruct(shape, jax.numpy.float32))
        assert len(set(seen)) == 1, seen
        return seen[0]

    yield traced
    jax.clear_caches()


ROUTE_GRID = [(shape, radius, padding, measure)
              for shape, radius, padding in (((1, 16, 16, 8), 1, 1), ((1, 17, 16, 8), 1, 1),
                                             ((1, 18, 18, 8), 1, 0), ((1, 19, 18, 8), 1, 0),
                                             ((1, 20, 20, 8), 2, 2))
              for measure in ("cosine", "pearson", "attention")]
ROUTE_GRID.append(((1, 17, 16, 96), 1, 1, "cosine"))


@pytest.mark.parametrize("shape,radius,padding,measure", ROUTE_GRID)
def test_kernel_route_matches_jax_body(jax_body, shape, radius, padding, measure):
    assert _kernel_route(shape, radius, measure, padding, 1) == jax_body(
        shape, radius, measure, padding=padding)


def _jax_raises(shape, measure, **kw):
    try:
        jax.eval_shape(lambda x: JAX_NFP.nfp_pallas(x, 1, measure, interpret=True, **kw),
                       jax.ShapeDtypeStruct(shape, jax.numpy.float32))
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("shape,measure,raises", [
    ((1, 16, 16, 8), "cosine", False),    # K1 takes any string
    ((1, 17, 16, 8), "cosine", True),     # the K2 branch checks it
    ((1, 17, 16, 8), "attention", True),  # attention runs dot on K2
    ((1, 17, 16, 8), "pearson", False),   # K3 does not look at it
])
def test_bad_chw_body_raises_only_where_jax_does(shape, measure, raises):
    assert _jax_raises(shape, measure, padding=1, chw_body="bogus") == raises
    x = torch.from_numpy(_x(shape))
    if raises:
        with pytest.raises(ValueError, match="unknown chw_body"):
            nfp_kernel(x, 1, measure, padding=1, chw_body="bogus")
    else:
        nfp_kernel(x, 1, measure, padding=1, chw_body="bogus")


@pytest.mark.parametrize("shape", [(1, 7, 7, 8), (1, 20, 20, 8)])
def test_mahalanobis_raises_as_in_jax(shape):
    assert _jax_raises(shape, "mahalanobis", padding=1)
    x = torch.from_numpy(_x(shape))
    with pytest.raises(ValueError):
        nfp_kernel(x, 1, "mahalanobis", padding=1)
    with pytest.raises(ValueError):
        nfp_strip_cuda(x, 1, "mahalanobis", padding=1)


def _counts():
    return nfp_small_cuda.launches, nfp_large_cuda.launches, nfp_strip_cuda.launches


@pytest.mark.parametrize("measure", ["pearson", "cosine", "smith", "attention"])
@pytest.mark.parametrize("fuse_gap", [True, False])
def test_cpu_runs_the_plain_version_and_never_launches(measure, fuse_gap):
    before = _counts()
    kw = dict(padding=1, fuse_gap=fuse_gap)
    for shape in ((2, 20, 20, 8), (2, 7, 7, 8)):
        x = torch.from_numpy(_x(shape, seed=11))
        want = nfp_reference(x, 1, measure, **kw)
        torch.testing.assert_close(nfp_strip_cuda(x, 1, measure, **kw), want, rtol=0, atol=0)
        torch.testing.assert_close(nfp_kernel(x, 1, measure, **kw), want, rtol=0, atol=0)
    assert _counts() == before


def test_sweep_tool_writes_a_record_on_cpu(tmp_path):
    out = tmp_path / "sweep.jsonl"
    sweep_nfp_kernel.main(["--device", "cpu", "--configs", "pearson_odd_w_large", "r2_head",
                           "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["config"] for r in recs] == ["r2_head", "pearson_odd_w_large"]
    assert [r["route"] for r in recs] == ["k1", "k3"]
    for r in recs:
        assert r["device"] == "cpu" and r["kernel_ms"] is None and r["plain_ms"] is None
        assert r["max_err"] == 0.0  # fp32: nfp_kernel runs the plain version on the CPU
        assert {"shape", "radius", "dilation", "padding", "dtype", "measure", "fuse_gap",
                "max_rel_err", "kind", "smi"} <= set(r)


def test_bench_tool_writes_records_on_cpu(tmp_path):
    out = tmp_path / "bench.jsonl"
    bench_nfp_kernel.main(["--device", "cpu", "--measure", "pearson", "--shapes", "mnv3_stage3",
                           "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["shape"], r["fuse_gap"], r["route"]) for r in recs] == [
        ("mnv3_stage3", True, "k3"), ("mnv3_stage3", False, "k3")]
    assert all(r["kernel_ms"] is None and r["max_err"] == 0.0 for r in recs)


def test_k3_plan_counts_the_means(monkeypatch):
    """Pearson keeps a mean beside each staged pixel's tail: at the first
    MobileNetV3 tap (B=32) its block takes one float more per ring pixel
    than cosine's, and still gets cosine's 16-row strips within the
    two-block budget; with 1 KB less it drops to 4-row blocks."""
    b, s, c = 32, 112, 16
    cos = _k2_plan(b, s, s, c, s, s, 1, 1, torch.float32, "cosine")
    pea = _k2_plan(b, s, s, c, s, s, 1, 1, torch.float32, "pearson")
    assert (pea.rows, pea.step, pea.group, pea.chunk) == (cos.rows, cos.step, cos.group, c)
    assert (pea.rows, pea.step) == (16, 4)
    ring_pixels = (2 * pea.step + 2) * (s + 2)
    assert pea.smem_bytes == cos.smem_bytes + ring_pixels * 4
    assert pea.smem_bytes == _k2_smem_bytes(16, 4, s, pea.stride, 1, 1, pixel_floats=2)
    assert cos.smem_bytes <= _K2_SMEM_BUDGET - 1024 < pea.smem_bytes <= _K2_SMEM_BUDGET
    monkeypatch.setattr(nfp_cuda, "_K2_SMEM_BUDGET", _K2_SMEM_BUDGET - 1024)
    assert _k2_plan(b, s, s, c, s, s, 1, 1, torch.float32, "cosine") == cos
    assert _k2_plan(b, s, s, c, s, s, 1, 1, torch.float32, "pearson").rows == 4


def test_k3_plan_chunks_wide_channels():
    """C=256 at 56² is staged in 2 chunks of 128 for pearson as for cosine,
    one step of one row a block."""
    plan = _k2_plan(8, 56, 56, 256, 56, 56, 1, 1, torch.float32, "pearson")
    assert (plan.chunk, plan.group, plan.rows, plan.step) == (128, 8, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_plan_budget_registers_and_banks(dtype):
    check_plan_rules(dtype, "pearson")


def _pearson_block_values(win, radius, dilation, measure, chunk, cfg, similarity):
    """K3's pearson values (B, rows, cols, N) on one block's staged window:
    each pixel's channel sum (its mean), then its centred sum of squares
    (its tail), and each pair's centred products, every sum taken chunk by
    chunk in chunk order; the tail s0 / sqrt(tc * tn + eps)."""
    assert measure == "pearson"
    _, wr, wc, c = win.shape
    span, r = 2 * radius * dilation, radius * dilation
    rows, cols = wr - span, wc - span
    chunks = [win[..., c0:c0 + chunk] for c0 in range(0, c, chunk)]
    mean = (sum(part.sum(-1) for part in chunks) / c)[..., None]
    centred = [part - mean for part in chunks]
    tail = sum((part * part).sum(-1) for part in centred)
    k = 2 * radius + 1
    cen = (slice(None), slice(r, r + rows), slice(r, r + cols))
    vals = []
    for i in range(k):
        for j in range(k):
            if (i, j) == (radius, radius):
                continue
            nb = (slice(None), slice(i * dilation, i * dilation + rows),
                  slice(j * dilation, j * dilation + cols))
            s0 = sum((part[cen] * part[nb]).sum(-1) for part in centred)
            vals.append(s0 / torch.sqrt(tail[cen] * tail[nb] + cfg.eps))
    return get_measure(measure).finalize(torch.stack(vals, -1), similarity)


#: shape, kwargs, plan constants patched (a block target that lets a small
#: batch take taller, ragged strips and steps; a shared-memory budget that
#: makes the plan chunk C or cut columns)
K3_EMULATION_CASES = {
    "20x20_gap": ((2, 20, 20, 16), dict(radius=1, padding=1, fuse_gap=True), {}),
    "17x19_ragged_strip_map": ((1, 17, 19, 24), dict(radius=1, padding=1),
                               {"_K2_MIN_BLOCKS": 4}),
    "ragged_step_gap": ((2, 22, 20, 40), dict(radius=1, padding=1, fuse_gap=True),
                        {"_K2_MIN_BLOCKS": 4}),
    "r2_dilation2_map": ((2, 20, 20, 16), dict(radius=2, padding=4, dilation=2), {}),
    "chunked_zeros_gap": ((2, 20, 20, 32), dict(radius=1, padding=1, padding_mode="zeros",
                                                fuse_gap=True), {"_K2_SMEM_BUDGET": 6144}),
    "column_tiles_circular_map": ((1, 20, 24, 8), dict(radius=1, padding=2,
                                                       padding_mode="circular"),
                                  {"_K2_SMEM_BUDGET": 2048}),
    "offset3_map": ((2, 20, 20, 16), dict(radius=1, padding=1, offset=3.0), {}),
}


@pytest.mark.parametrize("case", sorted(K3_EMULATION_CASES))
def test_k3_pearson_emulation_matches_jax(case, monkeypatch):
    shape, kw, patch = K3_EMULATION_CASES[case]
    kw = dict(dict(dilation=1, padding_mode="reflect", fuse_gap=False), **kw)
    radius, offset = kw.pop("radius"), kw.pop("offset", 0.0)
    for name, value in patch.items():
        monkeypatch.setattr(nfp_cuda, name, value)
    x = _x(shape, seed=13, offset=offset)
    assert _kernel_route(shape, radius, "pearson", kw["padding"], kw["dilation"]) == "k3"
    got, plan = emulate_k2(torch.from_numpy(x), radius, "pearson",
                           block_values=_pearson_block_values, **kw)
    if case == "chunked_zeros_gap":
        assert plan.chunk < shape[3]
    if case == "column_tiles_circular_map":
        assert plan.n_cols > 1
    if case == "17x19_ragged_strip_map":
        assert 17 % plan.rows and plan.n_strips > 1  # a ragged last strip
    if case == "ragged_step_gap":
        assert plan.rows > plan.step and 22 % plan.step  # a ragged last step
    want = _jax(x, radius, "pearson", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
