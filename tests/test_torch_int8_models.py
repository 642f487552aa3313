"""int8 serving on every backbone and head: the port's int8 tier against
the JAX package's, on the CPU.

Layer sets: the port's int8 layers (``quant._eligible`` on its modules,
named by ``torch_module_name``) are the JAX interceptor's ``replaced``
calls, call for call, on one pair of each head class that holds a Conv
or Dense, on MobileNetV3's own variants and on the mixed tier of ResNet50
and ViT-Tiny (the JAX side traced with ``jax.eval_shape``, nothing
computed); their counts match the JAX interceptor's on all 63 pairs of
the registry (a port-only table); and an int8 ``Predictor`` builds and
answers on the pairs whose int8 tier is new.

Models, with numpy-drawn weights (``test_torch_model.py::_draw_variables``)
moved by ``state_dict_from_flax``: ResNet50 + texture_nfp (64 px; BN
folding pairs, the 32 s8 chains of its bottlenecks, calibrated scales,
logits dynamic and calibrated-chained), ViT-Tiny + texture_nfp (32 px,
five tokens padded to eight: the JAX ``seq_align`` pad rows set
per-tensor amaxes on these weights, so the port's int8 ViT pads as the
JAX one does), MobileNetV3 + gap_only (64 px; dynamic and calibrated,
where the end-to-end guard drops every chain), and ResNet18's fractal
head (192 px, its BatchNorm folded through the eval-mode dropout). Each
int8 layer is held to JAX's given
JAX's input (``_check_tier`` says why the free-running logits are not
compared on every model), and the logits to JAX's.

The JAX int8 forwards here are jitted with XLA's algebraic simplifier and
fusion passes off (``UNFUSED``), where ``test_torch_quant.py`` runs them
op by op: an eager first call of ResNet50 or MobileNetV3 compiles each op
on its own (26 s and 43 s), this jit compiles once (3-5 s). A default jit
turns ``amax / 127`` and ``x / act_scale`` into a multiply by the
reciprocal and contracts the epilogue into an fma (ROADMAP.md Queue 3),
which moves values across rounding steps of the next quantization
(ResNet50's dynamic logits then move by up to 4e-2); with those passes
off every op rounds on its own, as op by op (ResNet50's dynamic logits
within 3.6e-7 of the eager run), so the layers and logits are held to
the op-by-op cases' bar, ``TOL``. The calibrated scales observe float
forwards that differ by fp32 rounding: ``SCALE_RTOL``.
"""

import collections

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu import quant as jq
from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.models.backbones.vit import ViT as JaxViT
from neighbour_feature_pooling_tpu_torch import quant
from neighbour_feature_pooling_tpu_torch.models import (
    MODEL_VARIANTS, get_model, state_dict_from_flax, torch_module_name)
from neighbour_feature_pooling_tpu_torch.serve import Predictor
from test_torch_model import _draw_variables, one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
#: a jit whose ops each round as they do op by op (module docstring)
UNFUSED = {"xla_disable_hlo_passes": "algsimp,cpu-instruction-fusion,instruction-fusion,fusion"}
#: and with LLVM's optimisation off, which halves a compile but slows the
#: code: for the small inputs (not the 192 px fractal case)
UNFUSED_O0 = dict(UNFUSED, xla_backend_optimization_level=0)
#: calibrated scales: the float forwards they observe differ by fp32
#: rounding, which grows with depth (ResNet50's layer3.0.conv2 input amax
#: is 1.01e-6 apart, ViT-Tiny's and MobileNetV3's ≤ 8e-7)
SCALE_RTOL = 2e-6
NUM_CLASSES = 5

#: int8 layer calls per forward, as the JAX interceptor counts them at the
#: default QuantConfig: each backbone alone, plus what a head adds
BACKBONE_CALLS = dict(resnet18=20, resnet50=53, mobilenetv3=36, vittiny=49)
HEAD_CALLS = dict(texture_fractal=1, gap_mlp=2, nfp_conv_mlp=2, gap_nfp_conv_mlp_concat=2,
                  gap_nfp_noconv_mlp_concat=2, nfp_head=2, multi_radius_nfp=2,
                  adaptive_fusion_nfp=2, se_gate=4)
#: MobileNetV3's variants that read conv_head (one more 1×1 conv) or stop early
MNV3_CALLS = dict(nfp_insert=37, mid_nfp=37, multi_stage_nfp=37, texture_nfp_intermediate=2)
PAIRS = [(mt, v) for mt, vs in MODEL_VARIANTS.items() for v in vs]


def _expected_calls(model_type, variant):
    if model_type == "mobilenetv3" and variant in MNV3_CALLS:
        return MNV3_CALLS[variant]
    return BACKBONE_CALLS[model_type] + HEAD_CALLS.get(variant, 0)


@pytest.mark.parametrize("model_type,variant", PAIRS, ids=[f"{m}/{v}" for m, v in PAIRS])
def test_int8_layer_count(model_type, variant):
    """Every pair's eligible layers, counted on the module tree (no
    forward: each is called once, as the layer sets below show)."""
    with torch.device("meta"):  # no weights drawn: eligibility reads the modules only
        model = get_model(model_type, variant, NUM_CLASSES)
    cfg = quant.QuantConfig()
    assert sum(1 for _ in quant._eligible_layers(model, cfg)) == _expected_calls(
        model_type, variant)


#: (type, variant, quantize_spatial): a pair of each head class holding an
#: eligible Conv or Dense (se_gate holds nfp_head's), MobileNetV3 with its
#: conv_head, and the mixed tier on ResNet50 and ViT-Tiny
SET_CASES = [("resnet18", "texture_fractal", True), ("resnet18", "gap_mlp", True),
             ("resnet18", "nfp_conv_mlp", True), ("resnet18", "gap_nfp_conv_mlp_concat", True),
             ("resnet18", "multi_radius_nfp", True), ("resnet18", "adaptive_fusion_nfp", True),
             ("resnet18", "se_gate", True), ("mobilenetv3", "multi_stage_nfp", True),
             ("resnet50", "texture_nfp", False), ("vittiny", "gap_nfp_noconv_mlp_concat", False)]


@pytest.mark.parametrize("model_type,variant,spatial", SET_CASES,
                         ids=[f"{m}/{v}{'' if s else '/mixed'}" for m, v, s in SET_CASES])
def test_int8_layer_set_matches_jax(model_type, variant, spatial):
    """The port's int8 layer calls in one forward are the JAX
    interceptor's ``replaced`` calls, through ``torch_module_name``."""
    # the fractal head needs a 6² map, nfp_conv_mlp's NFP (padding 0) a 3² one
    size = 192 if variant == "texture_fractal" else 96
    jm = jax_get_model(model_type, variant, NUM_CLASSES)
    replaced = []

    def init(key, x):
        with fnn.intercept_methods(jq.make_int8_interceptor(
                jq.QuantConfig(quantize_spatial=spatial), replaced=replaced)):
            return jm.init({"params": key, "dropout": key}, x, train=False)

    jax.eval_shape(init, jax.random.PRNGKey(0),
                   jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32))
    want = collections.Counter(torch_module_name(k) for k in replaced)

    model = get_model(model_type, variant, NUM_CLASSES).eval()
    got = collections.Counter()
    for name, mod in quant._eligible_layers(model, quant.QuantConfig(quantize_spatial=spatial)):
        mod.register_forward_pre_hook(lambda m, args, name=name: got.update([name]))
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3))
    assert got == want
    if spatial:
        assert sum(want.values()) == _expected_calls(model_type, variant)


@pytest.mark.parametrize("model_type,variant", [("resnet50", "texture_nfp"),
                                                ("vittiny", "gap_only"),
                                                ("resnet18", "nfp_at_layer"),
                                                ("resnet18", "texture_deepten"),
                                                ("resnet18", "se_gate")])
def test_int8_predictor_serves_the_new_pairs(model_type, variant):
    """A CPU int8 ``Predictor`` builds and answers on pairs whose int8
    tier used to raise, with each eligible layer swapped for its int8
    module."""
    size = 96 if variant == "nfp_at_layer" else 64  # its NFP (padding 0) needs a 3² map
    pred = Predictor(model_type, variant, NUM_CLASSES, batch_size=2, input_size=size,
                     resize_size=size + 8, quantize="int8", device="cpu")
    swapped = [m for m in pred.model.modules() if isinstance(m, (quant.Int8Conv2d, quant.Int8Linear))]
    assert len(swapped) == _expected_calls(model_type, variant)
    rng = np.random.default_rng(9)
    out = pred.predict([rng.random((80, 70, 3), dtype=np.float32) for _ in range(3)])
    assert out["probabilities"].shape == (3, NUM_CLASSES)
    assert np.isfinite(out["probabilities"]).all()


# ------------------------------------------------------------ the models


def _case(model_type, variant, size, seed, batch=2):
    """The JAX model, its variables, ``batch`` images, its BN folding, and
    a function that makes the port's float model with the same weights."""
    model = jax_get_model(model_type, variant, NUM_CLASSES)
    x = np.random.default_rng(seed).standard_normal((batch, size, size, 3)).astype(np.float32)
    v = _draw_variables(model, x[:1], train=False, seed=seed)
    sd = state_dict_from_flax(v)

    def port_model():
        m = get_model(model_type, variant, NUM_CLASSES)
        m.load_state_dict(sd)
        return m.eval()

    return dict(model=model, v=v, x=x, folding=jq.build_bn_folding(model, v, jnp.asarray(x)),
                port_model=port_model)


def _calibrate(case, chains=True):
    """JAX's calibrated scales (and chains) on the case's images."""
    cfg = jq.QuantConfig(bn_folding=case["folding"])
    x = jnp.asarray(case["x"])
    case["scales"] = jq.calibrate_act_scales(case["model"], case["v"], [x], config=cfg)
    if chains:
        case["chains"] = jq.build_int8_chains(case["model"], case["v"], x, case["scales"],
                                              config=cfg)
    return case


def _names(d):
    return {torch_module_name(k): val for k, val in d.items()}


def _jax_run(case, **cfg):
    """JAX's int8 logits and each int8 call's input and output, by the
    port's module name: a recording interceptor around the int8 one sees
    every call it replaces."""
    model, keys = case["model"], []

    def apply(v, x):
        keys.clear()
        replaced, vals = [], []

        def record(next_fun, args, kwargs, context):
            n = len(replaced)
            out = next_fun(*args, **kwargs)
            mod = context.module
            if len(replaced) == n + 1 and context.method_name == "proj":
                keys.append(tuple(mod.path) + (f"proj_{kwargs.get('tag', 'qkv')}",))
                vals.append((args[0], out))
            elif len(replaced) == n + 1 and type(mod) in (fnn.Conv, fnn.Dense):
                keys.append(tuple(mod.path))
                vals.append((args[0], out))
            return out

        with fnn.intercept_methods(record):
            with fnn.intercept_methods(jq.make_int8_interceptor(jq.QuantConfig(**cfg),
                                                                replaced=replaced)):
                return model.apply(v, x, train=False), vals

    options = UNFUSED if case["x"].shape[1] > 64 else UNFUSED_O0
    logits, vals = jax.jit(apply, compiler_options=options)(case["v"], jnp.asarray(case["x"]))
    return np.asarray(logits), {torch_module_name(k): (np.array(a), np.array(b))
                                for k, (a, b) in zip(keys, vals)}


def _port_config(case, tier):
    """The port's QuantConfig of a tier, given JAX's scales and chains."""
    if tier == "dynamic":
        return quant.QuantConfig()
    folding = quant.build_bn_folding(case["port_model"](), torch.from_numpy(case["x"]))
    if tier == "folded":
        return quant.QuantConfig(bn_folding=folding)
    return quant.QuantConfig(bn_folding=folding, act_scales=_names(case["scales"]),
                             int8_chains=_names(case.get("chains") or {}) or None)


def _jax_config(case, tier):
    if tier == "dynamic":
        return {}
    if tier == "folded":
        return dict(bn_folding=case["folding"])
    return dict(bn_folding=case["folding"], act_scales=case["scales"],
                int8_chains=case.get("chains") or None)


def _check_tier(case, tier, free_running=False):
    """The port's int8 tier against JAX's, layer by layer: each int8
    module is given JAX's input to the same layer and must give JAX's
    output (s8 outputs equal, fp32 ones within ``TOL``), which the rest of
    the port's forward then reads; the logits within ``TOL``. Between two
    int8 layers run fp32 ops (BatchNorm where it is not folded, LayerNorm
    and attention, depthwise convs), which the two packages round
    differently in the last bit, and a last-bit change moves a value
    across a rounding step of the next quantization; run free, those steps
    compound through the network, so the models' free-running logits are
    only compared (``free_running``) where no fp32 op but exact ones
    (adds, ReLU, max-pool) sits between int8 layers. Returns the port's
    quantized model."""
    want, records = _jax_run(case, **_jax_config(case, tier))
    model = quant.quantize_model(case["port_model"](), _port_config(case, tier))
    if free_running:
        with torch.no_grad():
            np.testing.assert_allclose(model(torch.from_numpy(case["x"])).numpy(), want, **TOL)
    seen, handles = [], []

    def nchw(a, conv):
        t = torch.from_numpy(a)
        return t.permute(0, 3, 1, 2) if conv else t

    for name, mod in model.named_modules():
        if not isinstance(mod, (quant.Int8Conv2d, quant.Int8Linear)):
            continue
        conv = isinstance(mod, quant.Int8Conv2d)
        handles.append(mod.register_forward_pre_hook(
            lambda m, args, name=name, conv=conv: (nchw(records[name][0], conv),)))

        def check(m, args, out, name=name, conv=conv):
            got, ref = (out.permute(0, 2, 3, 1) if conv else out).numpy(), records[name][1]
            assert got.dtype == ref.dtype, name
            if ref.dtype == np.int8:
                np.testing.assert_array_equal(got, ref, err_msg=name)
            else:
                np.testing.assert_allclose(got, ref, err_msg=name, **TOL)
            seen.append(name)
            return nchw(ref, conv)

        handles.append(mod.register_forward_hook(check))
    with torch.no_grad():
        got = model(torch.from_numpy(case["x"])).numpy()
    for h in handles:
        h.remove()
    assert sorted(seen) == sorted(records)
    np.testing.assert_allclose(got, want, **TOL)
    return model


@pytest.fixture(scope="module")
def resnet50():
    return _calibrate(_case("resnet50", "texture_nfp", 64, seed=50))


def test_resnet50_folding_and_chains_match_jax(resnet50):
    """53 folded (conv, BN) pairs; 32 chains, conv1 → conv2 → conv3 in
    each bottleneck (the port calls the downsample conv before conv1, JAX
    after conv3: call order does not change the dataflow), each with its
    ReLU, conv1 on K4 and conv2 on K5."""
    model = resnet50["port_model"]()
    x = torch.from_numpy(resnet50["x"])
    folding = quant.build_bn_folding(model, x)
    want = resnet50["folding"]
    assert len(folding["convs"]) == 53
    assert set(folding["convs"]) == set(_names(want["convs"]))
    assert folding["bns"] == {torch_module_name(k) for k in want["bns"]}
    cfg = quant.QuantConfig(bn_folding=folding)
    scales = quant.calibrate_act_scales(model, [x], cfg)
    chains = quant.build_int8_chains(model, x, scales, cfg)
    want_chains = _names(resnet50["chains"])
    assert len(chains) == 32 and set(chains) == set(want_chains)
    assert sorted({k.rsplit(".", 1)[1] for k in chains}) == ["conv1", "conv2"]
    assert all(relu for relu, _ in chains.values())
    assert all(chains[k][0] == want_chains[k][0] for k in chains)


def test_resnet50_calibrated_scales_match_jax(resnet50):
    model = resnet50["port_model"]()
    x = torch.from_numpy(resnet50["x"])
    cfg = quant.QuantConfig(bn_folding=quant.build_bn_folding(model, x))
    scales = quant.calibrate_act_scales(model, [x], cfg)
    want = _names(resnet50["scales"])
    assert set(scales) == set(want) and len(scales) == 53
    for k in want:
        assert abs(scales[k] - want[k]) <= SCALE_RTOL * want[k], k


@pytest.mark.parametrize("tier", ["dynamic", "calibrated_chained"])
def test_resnet50_int8_logits_match_jax(resnet50, tier):
    """Dynamic scales (BatchNorm in fp32 between the int8 convs); BN folded
    with JAX's calibrated scales and chains, where the free-running logits
    match too: 16 of the 32 chained producers are 1×1 convs, which emit s8
    through K4's GEMM branch."""
    model = _check_tier(resnet50, tier, free_running=tier != "dynamic")
    producers = [m for m in model.modules()
                 if isinstance(m, quant.Int8Conv2d) and m.cons_scale is not None]
    if tier == "dynamic":
        assert not producers
    else:
        assert len(producers) == 32 and sum(m.gemm for m in producers) == 16


@pytest.fixture(scope="module")
def vit():
    return _calibrate(_case("vittiny", "texture_nfp", 32, seed=51), chains=False)


@pytest.mark.parametrize("tier", ["dynamic", "calibrated"])
def test_vit_int8_logits_match_jax(vit, tier):
    """49 int8 layers (the patch embed on K5, the 48 linears on K4), the
    JAX layout of 8 tokens for 5 (``quant._int8_layout``)."""
    model = _check_tier(vit, tier)
    assert model.backbone.seq_align == quant.VIT_SEQ_ALIGN
    assert sum(isinstance(m, quant.Int8Linear) for m in model.modules()) == 48


def test_vit_pad_rows_set_amaxes_and_the_port_pads(vit):
    """The pad-row check. The JAX ViT's calibrated scales with its
    ``seq_align`` (8) and without padding (1) disagree on these weights:
    the three zero pad rows, after LayerNorm its shift, set amaxes. So the
    port's int8 tier pads too, and its scales agree with JAX's to
    ``SCALE_RTOL``, while the fp32 model keeps 5 tokens."""
    backbone = {k: t["backbone"] for k, t in vit["v"].items()}
    x = jnp.asarray(vit["x"])
    unpadded = jq.calibrate_act_scales(JaxViT(seq_align=1), backbone, [x],
                                       config=jq.QuantConfig())
    padded = {k[1:]: s for k, s in vit["scales"].items() if k[0] == "backbone"}
    assert set(unpadded) == set(padded) and len(padded) == 49
    assert max(abs(unpadded[k] - padded[k]) / padded[k] for k in padded) > 1e-3

    model = vit["port_model"]()
    assert model.backbone.seq_align == 1
    scales = quant.calibrate_act_scales(model, [torch.from_numpy(vit["x"])])
    assert model.backbone.seq_align == quant.VIT_SEQ_ALIGN
    want = _names(vit["scales"])
    assert set(scales) == set(want)
    for k in want:
        assert abs(scales[k] - want[k]) <= SCALE_RTOL * want[k], k


@pytest.fixture(scope="module")
def mobilenetv3():
    return _calibrate(_case("mobilenetv3", "gap_only", 64, seed=52), chains=False)


@pytest.mark.parametrize("tier", ["dynamic", "calibrated"])
def test_mobilenetv3_int8_logits_match_jax(mobilenetv3, tier):
    """36 int8 1×1 convs, 13 of them with Cin ≡ 8 (mod 16); calibrated,
    the port's end-to-end guard drops every chain candidate, the JAX
    verdict (tests/test_torch_quant.py::test_mobilenetv3_folding_and_chain_guard)."""
    if tier == "calibrated":
        model = mobilenetv3["port_model"]()
        x = torch.from_numpy(mobilenetv3["x"])
        cfg = quant.QuantConfig(bn_folding=quant.build_bn_folding(model, x))
        scales = quant.calibrate_act_scales(model, [x], cfg)
        want = _names(mobilenetv3["scales"])
        assert set(scales) == set(want)
        for k in want:
            assert abs(scales[k] - want[k]) <= SCALE_RTOL * want[k], k
        with pytest.warns(UserWarning, match="failed end-to-end verification"):
            assert quant.build_int8_chains(model, x, scales, cfg) == {}
    model = _check_tier(mobilenetv3, tier)
    convs = [m for m in model.modules() if isinstance(m, quant.Int8Conv2d)]
    assert len(convs) == 36 and all(m.gemm for m in convs)
    assert sum(m.in_channels % 16 == 8 for m in convs) == 13


def test_resnet18_fractal_head_int8_logits_match_jax():
    """The fractal head's 1×1 conv with its BatchNorm folded through the
    eval-mode dropout (192 px: a 6² map, the head's least), BN folded and
    dynamic scales; every op between the int8 layers is exact, so the
    free-running logits match too."""
    case = _case("resnet18", "texture_fractal", 192, seed=53, batch=1)
    folding = quant.build_bn_folding(case["port_model"](), torch.from_numpy(case["x"]))
    assert set(folding["convs"]) == set(_names(case["folding"]["convs"]))
    assert "pool.conv1.0" in folding["convs"] and "pool.conv1.2" in folding["bns"]
    model = _check_tier(case, "folded", free_running=True)
    assert sum(isinstance(m, (quant.Int8Conv2d, quant.Int8Linear))
               for m in model.modules()) == _expected_calls("resnet18", "texture_fractal")
