"""The PyTorch port's NFP op against the JAX package's, on the CPU.

Both sides get the same numpy inputs. On the JAX side, ``ops.nfp`` runs
the Pallas kernels in interpret mode (this conftest's CPU backend) and
``ops.nfp_reference`` is the XLA oracle; the port's ``nfp`` on a CPU tensor
runs its plain version. The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there).

Tolerance: the repo's fp32 bar, 1e-4 (sums are taken in other orders).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu import ops as jops
from neighbour_feature_pooling_tpu.ops.measures import SEPARABLE as JAX_SEPARABLE
from neighbour_feature_pooling_tpu.ops.measures import MeasureConfig as JaxMeasureConfig
from neighbour_feature_pooling_tpu_torch.ops import (
    MEASURE_NAMES,
    SEPARABLE,
    MeasureConfig,
    nfp,
    nfp_large_cuda,
    nfp_reference,
    nfp_small_cuda,
    pad_spatial,
)
from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import _route
from test_torch_model import one_torch_thread  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)

ALL_MEASURES = MEASURE_NAMES + ["mahalanobis"]
FLAGS = [(fuse_gap, sim) for fuse_gap in (False, True) for sim in (True, False)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port(x, *args, **kw):
    return nfp(torch.from_numpy(x), *args, **kw).numpy()


@pytest.mark.parametrize("fuse_gap,similarity", FLAGS)
@pytest.mark.parametrize("measure", ALL_MEASURES)
def test_measure_grid_matches_jax_reference(measure, fuse_gap, similarity):
    """Every measure name × fuse_gap × similarity, 7×7 map, R=1, reflect
    padding 1 (the texture head's configuration)."""
    x = _x((2, 7, 7, 16))
    kw = dict(similarity=similarity, padding=1, fuse_gap=fuse_gap)
    with jax.disable_jit():  # eager: no compile per configuration
        want = np.asarray(jops.nfp_reference(x, 1, measure, **kw))
    got = _port(x, 1, measure, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("measure", ALL_MEASURES)
def test_measure_matches_jax_kernel_path(measure):
    """Each measure name through the JAX public ``nfp`` (the small-map
    Pallas kernel in interpret mode, or the oracle for mahalanobis), with
    (fuse_gap, similarity) cycling over the four combinations."""
    fuse_gap, similarity = FLAGS[ALL_MEASURES.index(measure) % len(FLAGS)]
    x = _x((2, 7, 7, 16), seed=1)
    kw = dict(similarity=similarity, padding=1, fuse_gap=fuse_gap)
    want = np.asarray(jops.nfp(x, 1, measure, **kw))
    np.testing.assert_allclose(_port(x, 1, measure, **kw), want, **TOL)


GEOMETRY = {
    "1x1_reflect": ((2, 1, 1, 16), dict(radius=1, padding=1, fuse_gap=True)),
    "1x1_reflect_r2": ((2, 1, 1, 16), dict(radius=2, padding=2)),
    "2x2_reflect": ((2, 2, 2, 16), dict(radius=1, padding=1)),
    "2x2_zeros": ((2, 2, 2, 16), dict(radius=1, padding=1, padding_mode="zeros")),
    "7x7_replicate": ((2, 7, 7, 16), dict(radius=1, padding=1, padding_mode="replicate")),
    "7x7_circular": ((2, 7, 7, 16), dict(radius=1, padding=2, padding_mode="circular",
                                         fuse_gap=True)),
    "7x7_zeros_pad_past_centre": ((2, 7, 7, 16), dict(radius=1, padding=3,
                                                      padding_mode="zeros")),
    "7x7_stride2": ((2, 7, 7, 16), dict(radius=1, padding=1, stride=2)),
    "7x7_nchw": ((2, 16, 7, 7), dict(radius=1, padding=1, data_format="NCHW")),
    "7x7_nchw_gap": ((2, 16, 7, 7), dict(radius=1, padding=1, data_format="NCHW",
                                         fuse_gap=True)),
    "14x14_r2_dil2": ((2, 14, 14, 16), dict(radius=2, padding=4, dilation=2)),
    "14x14_r2_gap": ((2, 14, 14, 16), dict(radius=2, padding=2, fuse_gap=True,
                                           measure="pearson")),
    "14x14_valid": ((2, 14, 14, 16), dict(radius=1, padding=0, measure="norm", p=3.0)),
    "20x20_large_map": ((2, 20, 20, 16), dict(radius=1, padding=1, fuse_gap=True)),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY))
def test_geometry_matches_jax(case):
    shape, kw = GEOMETRY[case]
    kw = dict(kw)
    radius = kw.pop("radius")
    measure = kw.pop("measure", "cosine")
    x = _x(shape, seed=2)
    got = _port(x, radius, measure, **kw)
    want_kernel = np.asarray(jops.nfp(x, radius, measure, **kw))
    want_ref = np.asarray(jops.nfp_reference(x, radius, measure, **kw))
    assert got.shape == want_ref.shape
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)


@pytest.mark.parametrize("mode", ["reflect", "zeros", "replicate", "circular"])
def test_pad_spatial_matches_jnp_pad(mode):
    """jnp.pad semantics, including a pad at least as wide as the axis
    (reflect keeps reflecting, a 1-wide axis repeats), where F.pad raises."""
    jmode = {"reflect": "reflect", "zeros": "constant", "replicate": "edge",
             "circular": "wrap"}[mode]
    for n in range(1, 5):
        for pad in range(1, 6):
            x = _x((1, n, n + 1, 2), seed=n)
            want = np.asarray(jnp.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                                      mode=jmode))
            got = pad_spatial(torch.from_numpy(x), pad, mode).numpy()
            np.testing.assert_array_equal(got, want)


def test_bf16_input_keeps_dtype():
    x = torch.from_numpy(_x((2, 7, 7, 16))).to(torch.bfloat16)
    out = nfp(x, 1, "cosine", padding=1, fuse_gap=True)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 8)
    want = nfp_reference(x.float(), 1, "cosine", padding=1, fuse_gap=True)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=2e-2)


def test_routes_follow_jax_dispatch():
    """Which path the JAX ``nfp`` takes (nfp_pallas.py ``_forward_value``)."""
    def route(shape, measure="cosine", stride=1, fuse_gap=True, fmt="NHWC"):
        return _route(shape, 1, measure, stride, 1, 1, fmt, fuse_gap)

    assert route((32, 7, 7, 512)) == "kernel"            # the serving head
    assert route((8, 14, 14, 192)) == "kernel"           # ViT head, 196 positions
    assert route((2, 512, 7, 7), fmt="NCHW") == "kernel"
    assert route((2, 7, 7, 512), measure="mahalanobis") == "reference"
    assert route((2, 7, 7, 512), stride=2) == "reference"
    assert route((2, 56, 56, 16)) == "k2"                # separable, few channels
    assert route((2, 56, 56, 64)) == "k2"                # fused GAP: C <= 64
    assert route((2, 56, 56, 64), fuse_gap=False) == "reference"  # map: C <= 48
    assert route((2, 56, 56, 16), measure="pearson") == "reference"
    assert route((2, 56, 56, 128)) == "reference"
    # the MobileNetV3 taps at 224 px: 112², 56², 28² to K2, 14², 7² to K1
    assert [route((32, s, s, c)) for s, c in ((112, 16), (56, 24), (28, 40),
                                               (14, 112), (7, 960))] == [
        "k2", "k2", "k2", "kernel", "kernel"]
    assert route((32, 56, 56, 24), fuse_gap=False) == "k2"  # nfp_insert


def test_wrapper_takes_plain_version_on_cpu_and_never_launches():
    before = nfp_small_cuda.launches
    x = torch.from_numpy(_x((2, 7, 7, 16)))
    for measure in ("cosine", "attention", "scs"):
        got = nfp_small_cuda(x, 1, measure, padding=1, fuse_gap=True)
        want = nfp_reference(x, 1, measure, padding=1, fuse_gap=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        nfp(x, 1, measure, padding=1)
    assert nfp_small_cuda.launches == before


@pytest.mark.parametrize("fuse_gap", [True, False])
def test_large_wrapper_takes_plain_version_on_cpu_and_never_launches(fuse_gap):
    before = nfp_large_cuda.launches, nfp_small_cuda.launches
    x = torch.from_numpy(_x((2, 20, 20, 24)))
    for measure in ("cosine", "attention", "norm", "pearson"):
        kw = dict(padding=1, fuse_gap=fuse_gap)
        got = nfp_large_cuda(x, 1, measure, **kw)
        torch.testing.assert_close(got, nfp_reference(x, 1, measure, **kw), rtol=0, atol=0)
        nfp(x, 1, measure, **kw)
    assert (nfp_large_cuda.launches, nfp_small_cuda.launches) == before


# K2: separable measures on maps above 256 positions, through the JAX
# public nfp, which runs the channels-first Pallas kernel in interpret mode
# (the per-channel "fori" body at C <= 48, the whole-C "vec" body for
# fused maps at 48 < C <= 64)
SEPARABLE_NAMES = sorted(JAX_SEPARABLE)
K2_CASES = ([(m, (2, 20, 20, 24), True) for m in SEPARABLE_NAMES]
            + [(m, (2, 20, 20, 24), False) for m in SEPARABLE_NAMES]
            + [(m, (2, 20, 20, 56), True) for m in SEPARABLE_NAMES])


@pytest.mark.parametrize("measure,shape,fuse_gap", K2_CASES)
def test_k2_route_matches_jax_kernel(measure, shape, fuse_gap):
    similarity = SEPARABLE_NAMES.index(measure) % 2 == 0
    kw = dict(similarity=similarity, padding=1, fuse_gap=fuse_gap,
              p=2.0 if measure in ("norm", "scs") else 1.0)
    assert _route(shape, 1, measure, 1, 1, 1, "NHWC", fuse_gap) == "k2"
    x = _x(shape, seed=3)
    want = np.asarray(jops.nfp(x, 1, measure, **kw))
    got = _port(x, 1, measure, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


K2_GEOMETRY = {
    "nchw_map": ((2, 24, 20, 20), dict(radius=1, padding=1, data_format="NCHW")),
    "nchw_gap": ((2, 24, 20, 20), dict(radius=1, padding=1, data_format="NCHW",
                                       fuse_gap=True)),
    "zeros_pad": ((2, 20, 20, 24), dict(radius=1, padding=1, padding_mode="zeros")),
    "replicate_gap": ((2, 20, 20, 24), dict(radius=1, padding=1, fuse_gap=True,
                                            padding_mode="replicate")),
    "circular_odd": ((2, 21, 17, 24), dict(radius=1, padding=1, padding_mode="circular")),
    "r2_dilation2": ((2, 24, 24, 24), dict(radius=2, padding=4, dilation=2)),
    "r2_dilation2_gap": ((2, 24, 24, 24), dict(radius=2, padding=4, dilation=2,
                                               fuse_gap=True)),
    "insert_valid": ((2, 20, 20, 24), dict(radius=1, padding=0)),
}


@pytest.mark.parametrize("case", sorted(K2_GEOMETRY))
def test_k2_geometry_matches_jax(case):
    shape, kw = K2_GEOMETRY[case]
    kw = dict(kw)
    radius = kw.pop("radius")
    fmt = kw.get("data_format", "NHWC")
    assert _route(shape, radius, "cosine", 1, kw["padding"], kw.get("dilation", 1),
                  fmt, kw.get("fuse_gap", False)) == "k2"
    x = _x(shape, seed=4)
    want = np.asarray(jops.nfp(x, radius, "cosine", **kw))
    got = _port(x, radius, "cosine", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", SEPARABLE_NAMES)
def test_separable_table_matches_jax(name):
    """The ported SEPARABLE: same names, accumulator counts, per-channel
    terms and tails as the JAX table on the same numpy inputs."""
    assert sorted(SEPARABLE) == SEPARABLE_NAMES
    rng = np.random.default_rng(5)
    c, n = rng.standard_normal((2, 3, 24)).astype(np.float32)
    for p in (1.0, 2.0, 3.0):
        jcfg, cfg = JaxMeasureConfig(p=p), MeasureConfig(p=p)
        jsep, sep = JAX_SEPARABLE[name], SEPARABLE[name]
        assert sep.n_acc == jsep.n_acc
        jterms = [np.array(t) for t in jsep.map_terms(c, n, jcfg)]
        terms = [t.numpy() for t in sep.map_terms(torch.from_numpy(c), torch.from_numpy(n), cfg)]
        assert len(terms) == len(jterms) == sep.n_acc
        for got, want in zip(terms, jterms):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        jsums = tuple(t.sum(-1) for t in jterms)
        sums = tuple(torch.from_numpy(t).sum(-1) for t in jterms)
        np.testing.assert_allclose(sep.finalize_sums(sums, 24, cfg).numpy(),
                                   np.asarray(jsep.finalize_sums(jsums, 24, jcfg)),
                                   rtol=1e-6, atol=1e-6)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, found by ``pkgutil.walk_packages`` so a new
    one cannot slip past, and ``chip_smoke``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import chip_smoke\n"
        "import neighbour_feature_pooling_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names), 'modules:', ' '.join(names))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'neighbour_feature_pooling_tpu'"
        " or m.startswith('neighbour_feature_pooling_tpu.'))\n"
        "print('imported from JAX:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("serve", "quant", "ops.int8_conv", "models.backbones.mobilenetv3",
                 "tools.bench_nfp_kernel", "tools.sweep_nfp_kernel"):
        assert f"neighbour_feature_pooling_tpu_torch.{name}" in proc.stdout.split(), proc.stdout
