"""The PyTorch port's int8 tier against the JAX package's, on the CPU.

Kernel level: the port's plain ``int8_gemm`` / ``int8_conv2d`` against the
JAX Pallas kernels in interpret mode (the JAX tests' own way), on ragged
shapes and every padding and stride the serving path uses, in the three
output forms (s32, fused fp32, s8 with ReLU). s8 × s8 → s32 is exact and
both epilogues round the multiply and the add on their own, so all three
must be equal bit for bit.

Model level: ResNet18 + texture_nfp at 32 px with JAX weights from
``PRNGKey(0)`` whose BatchNorm leaves and biases are numpy draws, moved
with ``state_dict_from_flax``. The JAX side runs ``quantized_apply`` op by
op (not under ``jit``): compiled, XLA turns a division by a trace-time
constant (``amax / 127``, ``x / act_scale``) into a multiply by the fp32
reciprocal, which moves some scales by an ulp; the port divides as the
source does (ROADMAP.md Queue 3). Logits: the repo's fp32 bar, 1e-4.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from neighbour_feature_pooling_tpu import quant as jq
from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.ops.common import dequant_epilogue as jax_dequant_epilogue
from neighbour_feature_pooling_tpu.ops.int8_conv import int8_conv2d as jax_int8_conv2d
from neighbour_feature_pooling_tpu.ops.int8_gemm import int8_gemm as jax_int8_gemm
from neighbour_feature_pooling_tpu_torch import quant
from neighbour_feature_pooling_tpu_torch.models import get_model, state_dict_from_flax, torch_module_name
from neighbour_feature_pooling_tpu_torch.ops import (
    dequant_epilogue, int8_conv2d, int8_conv2d_reference, int8_gemm, int8_gemm_reference)
from neighbour_feature_pooling_tpu_torch.ops.int8_conv import pack_conv_weight
from neighbour_feature_pooling_tpu_torch.ops.int8_gemm import _tile_plan, a_mode, pack_weight
from test_torch_model import _draw_variables, one_torch_thread  # noqa: F401

SIZE = 32
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomise(variables, seed):
    """Numpy draws for every BatchNorm leaf and every bias."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = getattr(path[-1], "key", str(path[-1]))
        v = np.asarray(v)
        if name == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _s8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# ---------------------------------------------------------------- kernels

#: output forms: (name, with scale/bias, out dtype, relu)
FORMS = [("s32", False, None, False), ("fp32", True, "float32", False),
         ("s8_relu", True, "int8", True)]


def _epilogue_args(rng, n, with_scale):
    if not with_scale:
        return None, None
    scale = rng.uniform(1e-4, 5e-3, n).astype(np.float32)
    bias = rng.uniform(-2.0, 2.0, n).astype(np.float32)
    return scale, bias


def _assert_same(port, ref):
    ref = np.array(ref)
    assert port.dtype == torch.from_numpy(ref).dtype
    np.testing.assert_array_equal(port.numpy(), ref)


def _check_form(form, rng, n, port_fn, jax_fn):
    """The port's plain version against the JAX kernel in one output form.

    s32: equal. Fused: equal to the JAX kernel's s32 accumulator put
    through the JAX ``dequant_epilogue`` op by op, which rounds the
    multiply and the add on their own as the source says. The JAX kernel
    itself, compiled by XLA for the CPU, contracts them into one fma, so
    it is held within the product's rounding: one ulp of ``acc·scale``
    and one of the result (one s8 step)."""
    _, with_scale, out, relu = form
    scale, bias = _epilogue_args(rng, n, with_scale)
    got = port_fn(scale=None if scale is None else torch.from_numpy(scale),
                  bias=None if bias is None else torch.from_numpy(bias),
                  out_dtype=out and getattr(torch, out), relu=relu)
    if scale is None:
        _assert_same(got, jax_fn())
        return
    acc = jax_fn()
    with jax.disable_jit():
        want = jax_dequant_epilogue(acc, jnp.asarray(scale), jnp.asarray(bias),
                                    getattr(jnp, out), relu)
    _assert_same(got, want)
    fused = np.asarray(jax_fn(scale=jnp.asarray(scale), bias=jnp.asarray(bias),
                              out_dtype=getattr(jnp, out), relu=relu))
    if out == "int8":
        assert np.abs(got.numpy().astype(np.int32) - fused).max() <= 1
    else:
        product = np.abs(np.asarray(acc).astype(np.float32) * scale)
        assert (np.abs(got.numpy() - fused)
                <= np.spacing(product) + np.spacing(np.abs(fused))).all()


def _launch_counts():
    return int8_gemm.launches, int8_conv2d.launches, int8_conv2d.s8_launches


def _check_packed(form, rng, n, port_fn, plain_fn):
    """On the CPU the packed operand changes nothing: the wrapper's result
    with it is the plain version's, bit for bit, and nothing launches."""
    _, with_scale, out, relu = form
    scale, bias = _epilogue_args(rng, n, with_scale)
    kw = dict(scale=None if scale is None else torch.from_numpy(scale),
              bias=None if bias is None else torch.from_numpy(bias),
              out_dtype=out and getattr(torch, out), relu=relu)
    before = _launch_counts()
    got, want = port_fn(**kw), plain_fn(**kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert _launch_counts() == before


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("m,k,n", [(37, 100, 70), (64, 64, 128), (5, 300, 9)])
def test_int8_gemm_plain_matches_jax_kernel(m, k, n, form, packed):
    """Ragged M, N and K; the JAX kernel pads to its tiles, the port's
    plain version and K4 never pad. ``packed``: the same call with
    ``b_packed`` against the plain version."""
    rng = np.random.default_rng(m + k + n)
    a, b = _s8(rng, (m, k)), _s8(rng, (k, n))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if packed:
        _check_packed(form, rng, n,
                      lambda **kw: int8_gemm(ta, tb, b_packed=pack_weight(tb), **kw),
                      lambda **kw: int8_gemm_reference(ta, tb, **kw))
        return
    _check_form(form, rng, n, lambda **kw: int8_gemm(ta, tb, **kw),
                lambda **kw: jax_int8_gemm(jnp.asarray(a), jnp.asarray(b), **kw))


#: (label, x shape, kernel (kh, kw, cout), padding, strides)
CONV_CASES = [
    ("3x3 SAME s1", (2, 9, 11, 16), (3, 3, 24), "SAME", (1, 1)),
    ("3x3 pad 1 s2", (2, 9, 10, 16), (3, 3, 8), ((1, 1), (1, 1)), (2, 2)),
    ("3x3 VALID s1", (1, 8, 8, 32), (3, 3, 16), "VALID", (1, 1)),
    ("5x5 asymmetric pads s2", (1, 11, 9, 8), (5, 5, 12), ((2, 1), (0, 3)), (2, 2)),
    ("stem 7x7 pad 3 s2, Cin 3", (1, 32, 32, 3), (7, 7, 64), ((3, 3), (3, 3)), (2, 2)),
    ("1x1 SAME s2", (2, 7, 7, 16), (1, 1, 32), "SAME", (2, 2)),
]


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv2d_plain_matches_jax_kernel(case, form, packed):
    _, xshape, (kh, kw, cout), padding, strides = case
    rng = np.random.default_rng(sum(xshape) + kh * cout)
    x, w = _s8(rng, xshape), _s8(rng, (kh, kw, xshape[3], cout))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if packed:
        _check_packed(form, rng, cout,
                      lambda **kw: int8_conv2d(tx, tw, padding=padding, strides=strides,
                                               w_packed=pack_conv_weight(tw), **kw),
                      lambda **kw: int8_conv2d_reference(tx, tw, padding=padding,
                                                         strides=strides, **kw))
        return
    _check_form(form, rng, cout,
                lambda **kw: int8_conv2d(tx, tw, padding=padding, strides=strides, **kw),
                lambda **kw: jax_int8_conv2d(jnp.asarray(x), jnp.asarray(w),
                                             padding=padding, strides=strides, **kw))


@pytest.mark.parametrize("k,n", [(100, 70), (300, 9), (576, 64)])
def test_pack_weight_is_the_zero_padded_transpose(k, n):
    """``(K, N)`` → ``(N, Kp)``: k contiguous, Kp = K rounded up to 16,
    zeros past K."""
    w = _s8(np.random.default_rng(k + n), (k, n))
    kp = -(-k // 16) * 16
    want = np.zeros((n, kp), np.int8)
    want[:, :k] = w.T
    got = pack_weight(torch.from_numpy(w))
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_conv_weight_gives_rgb_a_zero_fourth_channel():
    """HWIO with Cin 3 packs as Cin 4: column (dy·kw + dx)·4 + ci, the
    fourth channel and the columns past K = 196 zero. Any other Cin packs
    as its own ``(kh·kw·Cin, Cout)`` view."""
    w = _s8(np.random.default_rng(7), (7, 7, 3, 64))
    w4 = np.zeros((7, 7, 4, 64), np.int8)
    w4[:, :, :3] = w
    want = np.zeros((64, 208), np.int8)
    want[:, :196] = w4.reshape(196, 64).T
    np.testing.assert_array_equal(pack_conv_weight(torch.from_numpy(w)).numpy(), want)
    w16 = torch.from_numpy(_s8(np.random.default_rng(8), (3, 3, 16, 24)))
    assert torch.equal(pack_conv_weight(w16), pack_weight(w16.reshape(144, 24)))


def test_packed_operand_of_another_weight_is_refused():
    """The check runs on the CUDA path only; its helper is plain Python."""
    from neighbour_feature_pooling_tpu_torch.ops.int8_gemm import check_packed
    check_packed("int8_gemm", torch.zeros(70, 112, dtype=torch.int8), 100, 70)
    with pytest.raises(ValueError, match="packed weight"):
        check_packed("int8_gemm", torch.zeros(112, 70, dtype=torch.int8), 100, 70)
    with pytest.raises(TypeError):
        pack_weight(torch.zeros(4, 4))


def test_zero_fourth_channel_leaves_the_conv_unchanged():
    """What K5's RGB path relies on: the plain conv of x and w, each
    zero-padded to four channels, is the plain conv of the originals (s32)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_s8(rng, (2, 21, 18, 3)))
    w = torch.from_numpy(_s8(rng, (7, 7, 3, 16)))
    pads = ((3, 3), (3, 3))
    want = int8_conv2d_reference(x, w, pads, (2, 2))
    x4, w4 = F.pad(x, (0, 1)), F.pad(w, (0, 0, 0, 1))
    assert x4.shape[-1] == 4 and w4.shape[2] == 4
    assert torch.equal(int8_conv2d_reference(x4, w4, pads, (2, 2)), want)


#: the eleven K5 and K4 products of int8 ResNet18 at 224 px: (m per image, n, k)
MAIN_PATH_PRODUCTS = {
    "stem": (112 * 112, 64, 7 * 7 * 4), "layer1": (56 * 56, 64, 576),
    "layer2.0": (28 * 28, 128, 576), "layer2": (28 * 28, 128, 1152),
    "layer3.0": (14 * 14, 256, 1152), "layer3": (14 * 14, 256, 2304),
    "layer4.0": (7 * 7, 512, 2304), "layer4": (7 * 7, 512, 4608),
    "layer2 downsample": (28 * 28, 128, 64), "layer3 downsample": (14 * 14, 256, 128),
    "layer4 downsample": (7 * 7, 512, 256)}
SMALL_TILE_AT_32 = {"layer3.0", "layer3", "layer4.0", "layer4", "layer3 downsample",
                    "layer4 downsample"}


@pytest.mark.parametrize("name", list(MAIN_PATH_PRODUCTS))
def test_tile_plan_on_the_main_path(name):
    """64×64 tiles where the 128×64 grid has fewer than 2 × 132 blocks: at
    B=32 layer3, layer4 and their downsample GEMMs; nowhere at B=128."""
    m, n, k = MAIN_PATH_PRODUCTS[name]
    assert _tile_plan(32 * m, n, k) == int(name in SMALL_TILE_AT_32)
    assert _tile_plan(128 * m, n, k) == 0


def test_tile_plan_on_ragged_shapes_and_a_modes():
    assert _tile_plan(37, 9, 300) == 1 and _tile_plan(1000, 70, 100) == 1
    assert _tile_plan(128 * 263, 64, 64) == 1 and _tile_plan(128 * 263 + 1, 64, 64) == 0
    assert _tile_plan(128 * 131 + 1, 65, 64) == 0  # 132 x 2 blocks
    assert _tile_plan(128 * 20, 64, 64, sms=10) == 0 and _tile_plan(128 * 19, 64, 64, sms=10) == 1
    # 16-byte chunks, 4-byte words or bytes, by the run of k and the address
    assert [a_mode(r, 256) for r in (64, 16, 24, 4, 100, 3, 37)] == [2, 2, 1, 1, 1, 0, 0]
    assert a_mode(64, 260) == 1 and a_mode(64, 257) == 0


def test_dequant_epilogue_matches_jax_at_ties():
    """Accumulators that land on .5 after the scale: half to even on both
    sides, and the saturating clamp."""
    acc = np.array([[1, 3, 5, -1, -3, 254, -254, 1000]], np.int32)
    scale = np.full(8, 0.5, np.float32)
    bias = np.zeros(8, np.float32)
    for relu in (False, True):
        want = jax_dequant_epilogue(jnp.asarray(acc), jnp.asarray(scale), jnp.asarray(bias),
                                    jnp.int8, relu)
        got = dequant_epilogue(torch.from_numpy(acc), torch.from_numpy(scale),
                               torch.from_numpy(bias), torch.int8, relu)
        _assert_same(got, want)


@pytest.mark.parametrize("call,error", [
    (lambda: int8_gemm(torch.zeros(2, 3), torch.zeros(3, 2, dtype=torch.int8)), TypeError),
    (lambda: int8_gemm(torch.zeros(2, 3, dtype=torch.int8), torch.zeros(4, 2, dtype=torch.int8)),
     ValueError),
    (lambda: int8_gemm(torch.zeros(2, 3, dtype=torch.int8), torch.zeros(3, 2, dtype=torch.int8),
                       bias=torch.zeros(2)), ValueError),
    (lambda: int8_conv2d(torch.zeros(1, 4, 4, 3, dtype=torch.int8),
                         torch.zeros(3, 3, 4, 8, dtype=torch.int8)), ValueError),
    (lambda: int8_conv2d(torch.zeros(1, 4, 4, 3, dtype=torch.int8),
                         torch.zeros(3, 3, 3, 8, dtype=torch.int8), bias=torch.zeros(8)),
     ValueError),
], ids=["gemm dtype", "gemm contraction", "gemm bias without scale", "conv Cin",
        "conv bias without scale"])
def test_kernel_wrappers_check_their_operands(call, error):
    with pytest.raises(error):
        call()


def test_cpu_wrappers_never_launch():
    rng = np.random.default_rng(0)
    before = _launch_counts()
    a, b = torch.from_numpy(_s8(rng, (8, 64))), torch.from_numpy(_s8(rng, (64, 16)))
    torch.testing.assert_close(int8_gemm(a, b), int8_gemm_reference(a, b), rtol=0, atol=0)
    x, w = torch.from_numpy(_s8(rng, (1, 6, 6, 16))), torch.from_numpy(_s8(rng, (3, 3, 16, 8)))
    torch.testing.assert_close(int8_conv2d(x, w, strides=(2, 2)),
                               int8_conv2d_reference(x, w, strides=(2, 2)), rtol=0, atol=0)
    assert _launch_counts() == before


@pytest.mark.parametrize("dims", [None, (0, 1, 2)], ids=["per_tensor", "per_channel"])
def test_quantize_matches_jax(dims):
    x = (np.random.default_rng(1).standard_normal((3, 3, 8, 4)) * 3.7).astype(np.float32)
    wq, ws = jq._quantize(jnp.asarray(x), axes=dims)
    q, s = quant._quantize(torch.from_numpy(x), dims=dims)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


# ------------------------------------------------------------ the model


@pytest.fixture(scope="module")
def resnet():
    """(JAX model, variables, images, folding, act_scales, chains) and a
    builder of the port's float model with the same weights."""
    model = jax_get_model("resnet18", "texture_nfp", 5)
    x = np.random.default_rng(3).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    v = _draw_variables(model, x[:1], train=False, seed=3)
    folding = jq.build_bn_folding(model, v, jnp.asarray(x))
    cfg = jq.QuantConfig(bn_folding=folding)
    scales = jq.calibrate_act_scales(model, v, [jnp.asarray(x)], config=cfg)
    chains = jq.build_int8_chains(model, v, jnp.asarray(x), scales, config=cfg)
    sd = state_dict_from_flax(v)

    def port_model():
        m = get_model("resnet18", "texture_nfp", 5)
        m.load_state_dict(sd)
        return m.eval()

    return dict(model=model, v=v, x=x, folding=folding, scales=scales, chains=chains,
                port_model=port_model)


def _names(keys):
    return {torch_module_name(k) for k in keys}


def test_prequantize_weights_match_jax(resnet):
    """The same 20 layers and s8 weights (HWIO → OIHW); the scales too once
    the JAX sweep runs op by op (compiled, ``amax / 127`` becomes a
    multiply by the reciprocal)."""
    with jax.disable_jit():
        jw = jq.prequantize_weights(resnet["v"])
    pw = quant.prequantize_weights(resnet["port_model"]())
    want = {}

    def walk(tree, path):
        for k, val in tree.items():
            if "wq" in val:
                want[torch_module_name(path + (k,))] = val
            else:
                walk(val, path + (k,))

    walk(jw, ())
    assert set(pw) == set(want) and len(pw) == 20
    for name, (wq, ws) in pw.items():
        np.testing.assert_array_equal(wq.numpy(), np.asarray(want[name]["wq"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(ws.numpy(), np.asarray(want[name]["ws"]).reshape(-1))


def test_bn_folding_matches_jax(resnet):
    """The same 20 (conv, BN) pairs; the affines agree to an ulp or two
    (the port's ``gamma / sqrt(var + eps)`` is IEEE on both devices; the
    JAX one, run by XLA on the CPU, came out an ulp apart on one channel
    of 3840)."""
    model = resnet["port_model"]()
    folding = quant.build_bn_folding(model, torch.from_numpy(resnet["x"]))
    want = resnet["folding"]
    assert len(folding["convs"]) == 20
    assert set(folding["convs"]) == _names(want["convs"])
    assert folding["bns"] == _names(want["bns"])
    for key, (mult, shift) in want["convs"].items():
        got = folding["convs"][torch_module_name(key)]
        np.testing.assert_allclose(got[0].numpy(), np.asarray(mult), rtol=3e-7, atol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(shift), rtol=3e-7, atol=1e-7)


def test_folding_needs_dataflow_not_adjacency():
    """A BN called right after a conv that does not consume its output
    does not fold (test_quant.py:674-695)."""

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(8, 8, 3, padding=1, bias=False)
            self.bn = nn.BatchNorm2d(8)

        def forward(self, x):
            return self.bn(torch.relu(self.conv(x)))

    folding = quant.build_bn_folding(M().eval(), torch.zeros(1, 8, 8, 8),
                                     quant.QuantConfig(min_contraction=1))
    assert folding == {"convs": {}, "bns": set()}


def test_calibration_and_chains_match_jax(resnet):
    """The same 20 calibrated layers, scales within rel 1e-5 (the float
    forwards they observe differ by fp32 rounding, ~1e-6 relative), and
    the same 8 chains, all conv1 → conv2 with ReLU, despite the port's
    BasicBlock calling its downsample before conv1."""
    model = resnet["port_model"]()
    x = torch.from_numpy(resnet["x"])
    cfg = quant.QuantConfig(bn_folding=quant.build_bn_folding(model, x))
    scales = quant.calibrate_act_scales(model, [x], cfg)
    want = {torch_module_name(k): v for k, v in resnet["scales"].items()}
    assert set(scales) == set(want) and len(scales) == 20
    for k in want:
        assert abs(scales[k] - want[k]) <= 1e-5 * want[k], k
    chains = quant.build_int8_chains(model, x, scales, cfg)
    assert len(chains) == 8
    assert set(chains) == _names(resnet["chains"])
    assert all(relu for relu, _ in chains.values())
    assert all(k.endswith(".conv1") for k in chains)
    assert all(cs == scales[k[: -len("conv1")] + "conv2"] for k, (_, cs) in chains.items())


def _jax_logits(resnet, **cfg):
    with fnn.intercept_methods(jq.make_int8_interceptor(jq.QuantConfig(**cfg))):
        return np.asarray(resnet["model"].apply(resnet["v"], jnp.asarray(resnet["x"]),
                                                train=False))


TIERS = ["dynamic", "folded", "calibrated_chained", "mixed"]


@pytest.mark.parametrize("tier", TIERS)
def test_quantized_logits_match_jax(resnet, tier):
    """Dynamic scales; BN folded; folded with JAX's calibrated scales and
    chains copied in; and the mixed tier (spatial convs float)."""
    model = resnet["port_model"]()
    x = torch.from_numpy(resnet["x"])
    jcfg, cfg = {}, quant.QuantConfig()
    if tier != "dynamic" and tier != "mixed":
        jcfg["bn_folding"] = resnet["folding"]
        cfg = quant.QuantConfig(bn_folding=quant.build_bn_folding(model, x))
    if tier == "calibrated_chained":
        jcfg.update(act_scales=resnet["scales"], int8_chains=resnet["chains"])
        cfg = dataclasses.replace(
            cfg, act_scales={torch_module_name(k): v for k, v in resnet["scales"].items()},
            int8_chains={torch_module_name(k): v for k, v in resnet["chains"].items()})
    if tier == "mixed":
        jcfg["quantize_spatial"] = False
        cfg = quant.QuantConfig(quantize_spatial=False)
    want = _jax_logits(resnet, **jcfg)
    quant.quantize_model(model, cfg)
    with torch.no_grad():
        got = model(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    swapped = sorted(n for n, m in model.named_modules() if isinstance(m, quant.Int8Conv2d))
    if tier == "mixed":
        assert swapped == [f"backbone.layer{i}.0.downsample.0" for i in (2, 3, 4)]
    else:
        assert len(swapped) == 20
    if tier == "calibrated_chained":
        s8 = [n for n, m in model.named_modules()
              if isinstance(m, quant.Int8Conv2d) and m.cons_scale is not None]
        assert len(s8) == 8
    # no fp32 weight of a swapped layer stays in the model
    assert not any(isinstance(m, nn.Conv2d) and name in swapped
                   for name, m in model.named_modules())


def test_packed_weights_stay_out_of_the_state_dict(resnet):
    """``quantize_model`` packs every int8 weight once, in a buffer that
    ``state_dict()`` leaves out: its keys are the quantized model's own
    (wq, ws, the affines), and a loaded ``wq`` is packed anew."""
    model = quant.quantize_model(resnet["port_model"]())
    mods = {n: m for n, m in model.named_modules() if isinstance(m, quant.Int8Conv2d)}
    assert len(mods) == 20
    keys = set(model.state_dict())
    assert not any("packed" in k for k in keys)
    assert {f"{n}.wq" for n in mods} | {f"{n}.ws" for n in mods} <= keys
    float_keys = set(resnet["port_model"]().state_dict())
    assert keys - float_keys == {f"{n}.{b}" for n in mods for b in ("wq", "ws")}
    for name, m in mods.items():
        want = (pack_weight(m.wq.view(m.in_channels, m.out_channels)) if m.gemm
                else pack_conv_weight(m.wq))
        assert torch.equal(m.wq_packed, want), name
    assert mods["backbone.conv1"].wq_packed.shape == (64, 208)  # 7·7·4 = 196 → 208
    sd = model.state_dict()
    sd["backbone.layer1.0.conv1.wq"] = -sd["backbone.layer1.0.conv1.wq"]
    model.load_state_dict(sd)
    m = mods["backbone.layer1.0.conv1"]
    assert torch.equal(m.wq_packed, pack_conv_weight(m.wq))


def test_int8_linear_matches_jax_dense():
    """``Int8Linear`` (K4's route for a linear) against the JAX
    ``_dense_int8``, with a bias."""

    class Dense(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(24, name="proj")(x)

    x = np.random.default_rng(5).standard_normal((6, 96)).astype(np.float32)
    jm = Dense()
    v = _randomise(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), seed=5)
    with fnn.intercept_methods(jq.make_int8_interceptor(jq.QuantConfig())):
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
    model = nn.Sequential()
    model.add_module("proj", nn.Linear(96, 24))
    with torch.no_grad():
        model.proj.weight.copy_(torch.tensor(np.asarray(v["params"]["proj"]["kernel"]).T))
        model.proj.bias.copy_(torch.tensor(np.asarray(v["params"]["proj"]["bias"])))
    quant.quantize_model(model)
    assert isinstance(model.proj, quant.Int8Linear)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mobilenetv3_folding_and_chain_guard():
    """23 folded pairs (the SE convs have no BN) and 0 chains: the linear
    conv_pwl → conv_pw candidates also feed a residual add, and the end to
    end guard must drop them all. The weights and the image are those of
    the JAX test (test_quant.py:640-652, :752-775)."""
    jm = jax_get_model("mobilenetv3", "gap_only", 3)
    x = np.random.default_rng(12).standard_normal((1, 64, 64, 3)).astype(np.float32)
    v = jax.jit(lambda k, xx: jm.init({"params": k}, xx, train=False))(  # one compile, not
        jax.random.PRNGKey(0), jnp.asarray(x))                            # one per op
    model = get_model("mobilenetv3", "gap_only", 3)
    model.load_state_dict(state_dict_from_flax(v))
    model.eval()
    x = torch.from_numpy(x)
    cfg = quant.QuantConfig(bn_folding=quant.build_bn_folding(model, x))
    assert len(cfg.bn_folding["convs"]) == 23
    scales = quant.calibrate_act_scales(model, [x], cfg)
    with pytest.warns(UserWarning, match="failed end-to-end verification"):
        assert quant.build_int8_chains(model, x, scales, cfg) == {}
