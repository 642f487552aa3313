"""The port's heads and the models built on them against the JAX package's,
on the CPU.

* Every head class of the JAX head library against its flax counterpart,
  in eval mode and in train mode: the output, the gradients of every
  parameter and of the input (``jax.vjp`` against ``torch.autograd.grad``,
  for one seeded cotangent) and, in train mode, the new BatchNorm running
  statistics. Dropout is off on both sides in these comparisons (each head
  is built with rate 0); the port's dropout law is checked on its own.
* The logits of every (backbone, variant) pair this slice adds, and the
  freeze mask of every variant on a backbone's standard map, against the
  JAX ``TextureModel``. Each backbone runs in JAX once: its weights are a
  seeded port model's, carried over by the JAX package's own importer, and
  its output on the test images is what the JAX model's ``backbone``
  returns for the rest of the JAX model (``flax.linen.intercept_methods``),
  so per backbone one jitted apply runs the heads and ``fc``s of all its
  variants. The port runs its whole model, backbone included, on the same
  images with the merged weights.
* One whole-model train step (loss, every gradient, the BatchNorm
  statistics) for ResNet18 with ``texture_deepten``, ``texture_radam``
  and ``multi_radius_nfp`` against the JAX model's, the three taken in
  one jit that runs the shared backbone's forward and vjp once
  (``_jax_train_steps``).

The heads' variables are numpy draws on the tree traced from the flax
``init``, which is never compiled
(``test_torch_model.py::_draw_variables``), with BatchNorm statistics,
scales and shifts and biases away from their identity values, so a
swapped mapping cannot hide behind an identity BatchNorm or a zero bias.
Tolerance: the repo's fp32 bar, 1e-4 (gradients relative to each
tensor's largest magnitude); BatchNorm running statistics 1e-5.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.models import heads as jheads
from neighbour_feature_pooling_tpu.models.import_torch import import_reference_checkpoint
from neighbour_feature_pooling_tpu.models import zoo as jzoo
from neighbour_feature_pooling_tpu.models.backbones.resnet import ResNet as JaxResNet
from neighbour_feature_pooling_tpu.models.zoo import TextureModel as JaxTextureModel
from neighbour_feature_pooling_tpu.ops.neighborhood import nfp_reference as jnfp_reference
from neighbour_feature_pooling_tpu.train import engine as jengine
from neighbour_feature_pooling_tpu_torch.models import (MODEL_VARIANTS, get_model, heads,
                                                        init_params, state_dict_from_flax)
from neighbour_feature_pooling_tpu_torch.models.batchnorm import BatchNorm1d
from neighbour_feature_pooling_tpu_torch.models.dropout import Dropout
from neighbour_feature_pooling_tpu_torch.train import engine
from test_torch_model import _draw_variables, jit_reference, one_torch_thread  # noqa: F401

#: the module (the package's ``ops`` exports its function of the same name)
jnfp_pallas = importlib.import_module("neighbour_feature_pooling_tpu.ops.nfp_pallas")
TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES = 5
C = 12


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_tree(tree):
    """{port name: numpy array} of a flax params tree (``from_jax``'s map)."""
    return {k: v.numpy() for k, v in state_dict_from_flax({"params": tree}).items()}


def _port_stats(tree):
    sd = state_dict_from_flax({"params": {}, "batch_stats": tree})
    return {k: v.numpy() for k, v in sd.items() if not k.endswith("num_batches_tracked")}


#: a gradient below this fraction of the largest one compared with it is
#: zero but for fp32 rounding (a bias feeding a train-mode BatchNorm)
ZERO = 1e-5


def _check_grads(got, want, what):
    """Each gradient within 1e-4 of its tensor's largest magnitude; one that
    is zero but for rounding on the JAX side must be so on the port's."""
    assert set(got) == set(want), what
    if not want:
        return
    zero = ZERO * max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        scale = float(np.abs(w).max())
        if scale <= zero:
            assert float(np.abs(got[name]).max()) <= zero, f"{what}: grad of {name} not 0"
            continue
        err = float(np.abs(got[name] - w).max()) / scale
        assert err <= 1e-4, f"{what}: grad of {name} off by {err:.2e} of its max"


def _check_stats(model, want):
    sd = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


# ------------------------------------------------------------------ head level


class _Holder(nn.Module):
    """The port head under the name the zoo gives it, so its state_dict keys
    are the model's; DeepTEN's encoding is followed by the model-level
    ``bn``."""

    def __init__(self, name, head, num_codes=0):
        super().__init__()
        self.name = name
        setattr(self, name, head)
        if num_codes:
            self.bn = BatchNorm1d(num_codes * C)

    def forward(self, *xs):
        out = getattr(self, self.name)(*xs)
        return self.bn(out) if hasattr(self, "bn") else out


# key: (flax head, port head, zoo name, input shapes, takes ``train``);
# C = 12 channels, 7x7 maps unless a case says otherwise; rate 0 wherever a
# head has dropout. The key is the flax module's name in ``_Side``.
HEADS = {
    "fractal": (lambda **kw: jheads.FractalPoolingHead(C, dropout_ratio=0.0, **kw),
                lambda: heads.FractalPoolingHead(C, C, dropout_ratio=0.0), "pool",
                [(2, 7, 6, C)], True),
    "lacunarity": (jheads.LacunarityPoolingHead, heads.LacunarityPoolingHead, "pool",
                   [(2, 5, 6, C)], True),
    "deepten": (lambda **kw: jheads.DeepTENHead(4, **kw), lambda: heads.DeepTENHead(4, C),
                "encoding", [(3, 4, 5, C)], True),
    "radam": (lambda **kw: jheads.RADAMHead(7, C, 4, **kw), lambda: heads.RADAMHead(7, C, 4),
              "pool", [(2, 7, 7, C)], True),
    "radam_resized": (lambda **kw: jheads.RADAMHead(7, C, 4, **kw),
                      lambda: heads.RADAMHead(7, C, 4), "pool", [(2, 4, 5, C)], True),
    "gap_mlp": (lambda **kw: jheads.GAPMLPHead(C, dropout_p=0.0, **kw),
                lambda: heads.GAPMLPHead(C, dropout_p=0.0), "head", [(2, 7, 7, C)], True),
    "nfp_conv_only_padding_0": (lambda **kw: jheads.NFPConvOnlyHead(16, padding=0, **kw),
                                lambda: heads.NFPConvOnlyHead(16, padding=0), "head",
                                [(2, 7, 7, C)], True),
    "nfp_conv_only_stride_2": (lambda **kw: jheads.NFPConvOnlyHead(16, stride=2, **kw),
                               lambda: heads.NFPConvOnlyHead(16, stride=2), "head",
                               [(2, 7, 7, C)], True),
    "nfp_conv_mlp": (lambda **kw: jheads.NFPConvMLPHead(16, padding=0, dropout_p=0.0, **kw),
                     lambda: heads.NFPConvMLPHead(16, padding=0, dropout_p=0.0), "head",
                     [(2, 7, 7, C)], True),
    "nfp_head": (lambda **kw: jheads.NFPHeadMLP(16, **kw), lambda: heads.NFPHeadMLP(C, 16),
                 "nfp_head", [(2, 7, 7, C)], True),
    "nfp_head_noconv": (lambda **kw: jheads.NFPHeadNoConv(16, **kw),
                        lambda: heads.NFPHeadNoConv(C, 16), "head", [(2, 7, 7, C)], True),
    "multi_radius": (lambda **kw: jheads.MultiRadiusNFPHead(C, **kw),
                     lambda: heads.MultiRadiusNFPHead(C, C), "head", [(2, 7, 7, C)], True),
    "se_gate": (lambda **kw: jheads.SEGateHead(C, dropout_p=0.0, **kw),
                lambda: heads.SEGateHead(C, C, dropout_p=0.0), "head", [(2, 7, 7, C)], True),
    "similarity_aware": (jheads.SimilarityAwarePooling, heads.SimilarityAwarePooling, "head",
                         [(2, 7, 7, C)], True),
    "adaptive_fusion": (lambda **kw: jheads.AdaptiveFusionNFP(C, dropout_p=0.0, **kw),
                        lambda: heads.AdaptiveFusionNFP(C, C, dropout_p=0.0), "head",
                        [(2, 7, 7, C)], True),
    "bottleneck_projected": (lambda **kw: jheads.NFPBottleneck(32, **kw),
                             lambda: heads.NFPBottleneck(C, 32), "head", [(2, 7, 7, C)], True),
    "bottleneck_identity": (lambda **kw: jheads.NFPBottleneck(C, **kw),
                            lambda: heads.NFPBottleneck(C, C), "head", [(2, 6, 7, C)], True),
    "positional_encoding": (jheads.PositionalEncoding2D, heads.PositionalEncoding2D, "head",
                            [(2, 5, 7, C)], False),
    "attention_fusion": (lambda **kw: jheads.AttentionFusion(16, **kw),
                         lambda: heads.AttentionFusion(C, 8, 16), "head", [(3, C), (3, 8)],
                         False),
}
HEADS.update({
    f"gap_nfp_{'conv' if conv else 'noconv'}_{'mlp' if mlp else 'nomlp'}": (
        lambda conv=conv, mlp=mlp, **kw: jheads.GAPNFPConcatHead(
            conv, mlp, bottleneck_dim=16, dropout_p=0.0, **kw),
        lambda conv=conv, mlp=mlp: heads.GAPNFPConcatHead(C, conv, mlp, bottleneck_dim=16,
                                                          dropout_p=0.0),
        "head", [(2, 7, 7, C)], True)
    for conv in (True, False) for mlp in (True, False)})
# texture_fractal on the other backbones' maps at 224 px (a CNN needs
# 192 px for the 6x6 map the op takes, so only ResNet18 runs the model),
# in fp64 on both sides: over a 7x7x2048 map some max-pool windows hold two
# values within fp32 rounding of each other, and the two frameworks' fp32
# convs then route the max's gradient to different pixels
for _name, _c, _hw in (("resnet50", 2048, 7), ("mobilenetv3", 960, 7), ("vittiny", 192, 14)):
    HEADS[f"fractal_{_name}_map"] = (
        lambda c=_c, **kw: jheads.FractalPoolingHead(c, dropout_ratio=0.0, dtype=jnp.float64,
                                                     **kw),
        lambda c=_c: heads.FractalPoolingHead(c, c, dropout_ratio=0.0), "pool",
        [(1, _hw, _hw, _c)], True)
FP64 = tuple(k for k in HEADS if k.endswith("_map"))
FP32 = tuple(k for k in HEADS if k not in FP64)


class _Side(fnn.Module):
    """The flax heads ``keys`` of ``HEADS`` side by side, each under its
    key, so one jitted vector-Jacobian product per mode serves them all."""

    keys: tuple

    @fnn.compact
    def __call__(self, inputs, train):
        out = {}
        for key in self.keys:
            jctor, _, _, _, takes_train = HEADS[key]
            out[key] = jctor(name=key)(*inputs[key], **({"train": train} if takes_train else {}))
        return out


_SIDE = {}


def _side(keys, train):
    """(variables, inputs, outputs, cotangents, (param grads, input grads),
    new BatchNorm statistics) of the flax heads ``keys`` in one mode, in
    fp64 for ``FP64``."""
    dtype = np.float64 if keys == FP64 else np.float32
    with jax.enable_x64(keys == FP64):
        inputs = {k: [_x(s, seed=i + 1).astype(dtype) for i, s in enumerate(HEADS[k][3])]
                  for k in keys}
        if (keys, "variables") not in _SIDE:
            variables = _draw_variables(_Side(keys), inputs, False, seed=7)
            _SIDE[keys, "variables"] = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                                               variables)
        if (keys, train) not in _SIDE:
            variables = _SIDE[keys, "variables"]
            stats = variables.get("batch_stats", {})

            def fn(p, i):
                out = _Side(keys).apply({"params": p, "batch_stats": stats}, i, train,
                                        mutable=["batch_stats"] if train else False)
                return out if train else (out, {})

            def outs_and_grads(p, i, g):
                out, vjp, new = jax.vjp(fn, p, i, has_aux=True)
                return out, vjp(g), new

            shapes = jax.eval_shape(lambda p, i: fn(p, i)[0], variables["params"], inputs)
            cot = {k: _x(v.shape, seed=99).astype(dtype) for k, v in shapes.items()}
            out, grads, new = jax.tree_util.tree_map(np.asarray, jit_reference(outs_and_grads)(
                variables["params"], inputs, cot))
            _SIDE[keys, train] = (inputs, out, cot, grads, new.get("batch_stats", {}))
    return (_SIDE[keys, "variables"],) + _SIDE[keys, train]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_flax(name, train):
    fp64 = name in FP64
    variables, inputs, outs, cots, (pgrads, igrads), new_stats = _side(
        FP64 if fp64 else FP32, train)
    _, tctor, zoo_name, _, _ = HEADS[name]
    params = variables["params"].get(name, {})
    stats = variables.get("batch_stats", {}).get(name, {})
    port = _Holder(zoo_name, tctor(), num_codes=4 if name == "deepten" else 0)
    port.load_state_dict(state_dict_from_flax(
        {"params": {zoo_name: params}, "batch_stats": {zoo_name: stats}}), strict=True)
    port.train(train).to(torch.float64 if fp64 else torch.float32)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in inputs[name]]
    want = outs[name]
    got = port(*ts)
    assert got.shape == want.shape and got.dtype == ts[0].dtype, name
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL, err_msg=name)
    names, tparams = zip(*port.named_parameters()) if params else ((), ())
    tgrads = torch.autograd.grad(got, list(tparams) + ts, torch.from_numpy(cots[name]))
    _check_grads(dict(zip(names, (t.numpy() for t in tgrads))),
                 _port_tree({zoo_name: pgrads[name]}) if params else {}, name)
    _check_grads({f"x{i}": t.numpy() for i, t in enumerate(tgrads[len(names):])},
                 {f"x{i}": w for i, w in enumerate(igrads[name])}, name)
    if train and stats:
        _check_stats(port, _port_stats({zoo_name: new_stats[name]}))


# ---------------------------------------------------------------- dropout law


def test_dropout_drops_whole_channels_at_its_rate_with_the_kept_scaled():
    """Whole channels of an NHWC map (the fractal head's), at rate p, the
    kept ones scaled by 1/(1-p); elementwise at rate 0.2 (the legacy
    heads')."""
    x = torch.rand((64, 3, 4, 500)) + 0.5
    for p, channels in ((0.6, True), (0.2, False)):
        d = Dropout(p, channels=channels).train()
        y = d(x, torch.Generator().manual_seed(1))
        kept = y != 0
        torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=0, atol=0)
        if channels:
            assert torch.equal(kept, kept[:, :1, :1, :].expand_as(kept))
            frac = 1 - kept[:, 0, 0, :].float().mean().item()
        else:
            assert not torch.equal(kept, kept[:, :1, :1, :].expand_as(kept))
            frac = 1 - kept.float().mean().item()
        assert abs(frac - p) < 0.02, (p, frac)


def test_dropout_mask_is_the_generator_seeds_and_off_in_eval():
    x = torch.ones((4, 2, 2, 64))
    d = Dropout(0.5, channels=True).train()
    a = d(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, d(x, torch.Generator().manual_seed(3)))
    assert not torch.equal(a, d(x, torch.Generator().manual_seed(4)))
    with pytest.raises(ValueError, match="Generator"):
        d(x)
    assert d.eval()(x) is x
    assert Dropout(0.0).train()(x) is x


def test_train_step_masks_follow_the_seed_and_the_step():
    """``TrainState.dropout_generator`` is seeded from (seed + 1, step): two
    states of one seed draw the same masks at the same step, and the next
    step draws others."""
    model = heads.GAPMLPHead(8)
    a, b = (engine.create_train_state(nn.Sequential(model), 5, 1e-3) for _ in range(2))
    assert a.dropout_seed == 6
    x = torch.ones(1000)
    draw = lambda s: torch.empty_like(x).bernoulli_(0.5, generator=s.dropout_generator())
    assert torch.equal(draw(a), draw(b))
    first = draw(a)
    a.step += 1
    assert not torch.equal(first, draw(a))


# ---------------------------------------------------------------- model level


#: the JAX run of each backbone: (model type, image side, batch)
BACKBONES = {"resnet18": (96, 2), "resnet18 192 px": (192, 1), "resnet50": (64, 2),
             "mobilenetv3": (96, 2), "vittiny": (64, 2)}
_NEW = {"texture_fractal", "texture_lacunarity", "texture_deepten", "texture_radam",
        "gap_mlp", "nfp_conv_only", "nfp_conv_mlp", "gap_nfp_conv_nomlp_concat",
        "gap_nfp_noconv_nomlp_concat", "gap_nfp_conv_mlp_concat", "gap_nfp_noconv_mlp_concat",
        "nfp_head", "multi_radius_nfp", "similarity_aware_pooling", "adaptive_fusion_nfp",
        "se_gate"}
#: every new pair, on the backbone run that reaches it: texture_fractal on
#: ResNet18 at 192 px only (its other maps at head level above)
PAIRS = [("resnet18 192 px" if v == "texture_fractal" else mt, v)
         for mt, variants in MODEL_VARIANTS.items() for v in variants
         if v in _NEW and (mt == "resnet18" or v != "texture_fractal")]
#: the pairs whose logits and freeze mask are compared: the new ones, and
#: gap_only and texture_nfp on each backbone beside them
STANDARD = PAIRS + [(mt, v) for mt in MODEL_VARIANTS for v in ("gap_only", "texture_nfp")]

_BACKBONE_RUNS = {}
_VARIANTS = {}


def _model_type(run):
    return run.split()[0]


def _oracle_nfp(x, radius=1, measure="cosine", similarity=True, p=1.0, eps=1e-6, q_scs=1e-6,
                stride=1, padding=0, dilation=1, padding_mode="reflect", data_format="NHWC",
                fuse_gap=False):
    """The JAX ``nfp`` with the kernel route off: its forward is the oracle
    and its ``custom_vjp`` backward the oracle's vjp, so the oracle itself,
    differentiated directly, is the same function with the same gradient,
    traced once instead of twice."""
    return jnfp_reference(x, radius, measure, similarity=similarity, p=p, eps=eps,
                          q_scs=q_scs, stride=stride, padding=padding, dilation=dilation,
                          padding_mode=padding_mode, data_format=data_format,
                          fuse_gap=fuse_gap)


@pytest.fixture(scope="module", autouse=True)
def _jax_nfp_through_its_plain_reference():
    """The JAX ``nfp`` computes through its XLA oracle here, not its Pallas
    kernel in interpret mode (both are how the JAX package's tests run it;
    the kernel is held against the oracle there): the oracle traces in a
    fraction of the time. Compiled traces are dropped on both sides of the
    module, so no other module sees this route."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnfp_pallas, "pallas_supported", lambda measure, stride: False)
        mp.setattr(jheads, "nfp", _oracle_nfp)
        mp.setattr(jzoo, "nfp", _oracle_nfp)
        yield
    jax.clear_caches()


def _stub_backbone(out):
    """Make every JAX model's ``backbone`` return ``out``."""
    def interceptor(next_fun, args, kwargs, context):
        if context.module.name == "backbone" and context.method_name == "__call__":
            return out
        return next_fun(*args, **kwargs)
    return fnn.intercept_methods(interceptor)


def _backbone_run(run):
    """(flax backbone variables, images, the JAX backbone's output) of a
    seeded port backbone with numpy BatchNorm statistics and biases."""
    if run not in _BACKBONE_RUNS:
        mt = _model_type(run)
        size, batch = BACKBONES[run]
        port = init_params(get_model(mt, "gap_only", NUM_CLASSES), torch.Generator().manual_seed(0))
        rng = np.random.default_rng(1)
        sd = {}
        for k, v in port.state_dict().items():
            v = v.numpy()
            if k.endswith("running_var"):
                v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k.endswith(("running_mean", ".bias")):
                v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            sd[k] = v
        variables, _ = import_reference_checkpoint(sd, mt, "gap_only")
        bb = {c: variables[c]["backbone"] for c in variables}
        x = _x((batch, size, size, 3), seed=size)
        jmodel = jax_get_model(mt, "gap_only", NUM_CLASSES)
        _, seen = jax.jit(lambda v, xx: jmodel.apply(
            v, xx, train=False, mutable=["intermediates"],
            capture_intermediates=lambda m, method: m.name == "backbone"))(variables, x)
        _BACKBONE_RUNS[run] = (bb, x, seen["intermediates"]["backbone"]["__call__"][0])
    return _BACKBONE_RUNS[run]


class _Variants(fnn.Module):
    """JAX ``TextureModel``s of one backbone side by side, each under its
    variant's name (one jitted init and one jitted apply for all)."""

    model_type: str
    variants: tuple

    @fnn.compact
    def __call__(self, x):
        return {v: JaxTextureModel(self.model_type, v, NUM_CLASSES, name=v)(x, False)
                for v in self.variants}


def _variant(run, variant):
    """(merged flax variables, images, JAX logits) of a pair: every variant
    of the run's heads and fcs initialised and run in JAX at once on its
    backbone's output."""
    if (run, variant) not in _VARIANTS:
        bb, x, out = _backbone_run(run)
        mt = _model_type(run)
        variants = tuple(v for r, v in STANDARD if r == run)
        side = _Variants(mt, variants)
        with _stub_backbone(out):
            init = _draw_variables(side, x, seed=2)
            logits = jax.jit(side.apply)(init, x)
        for v in variants:
            merged = {c: {**init.get(c, {}).get(v, {}), **({"backbone": bb[c]} if c in bb else {})}
                      for c in ("params", "batch_stats")}
            _VARIANTS[(run, v)] = (merged, x, np.asarray(logits[v]))
    return _VARIANTS[(run, variant)]


def _port_model(mt, variant, merged):
    model = get_model(mt, variant, NUM_CLASSES)
    model.load_state_dict(state_dict_from_flax(merged), strict=True)
    return model


@pytest.mark.parametrize("run,variant", STANDARD)
def test_logits_match_jax(run, variant):
    merged, x, want = _variant(run, variant)
    model = _port_model(_model_type(run), variant, merged).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("run,variant", STANDARD)
def test_freeze_mask_matches_jax(run, variant):
    """The port's mask selects, through ``from_jax``'s name map, the tensors
    JAX's ``freeze_mask`` selects (``nfp_head`` and ``se_gate`` anywhere in
    a path: ``multi_radius_nfp``'s ``se_gate1``/``se_gate2`` too)."""
    merged, _, _ = _variant(run, variant)
    params = merged["params"]
    mask = jengine.freeze_mask(params)
    want = {k for k, v in _port_tree(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), m, np.float32), mask, params)).items()
        if float(v.max()) == 0.0}
    got = {k for k, v in engine.freeze_mask(get_model(_model_type(run), variant,
                                                      NUM_CLASSES)).items() if v == 0.0}
    assert got == want
    assert bool(got) == (variant in ("nfp_head", "se_gate", "multi_radius_nfp"))


TRAIN_VARIANTS = ("texture_deepten", "texture_radam", "multi_radius_nfp")
_TRAIN = {}


def _jax_train_steps():
    """{variant: (loss, new BatchNorm statistics, gradients)} of one JAX
    ResNet18 train step of each ``TRAIN_VARIANTS`` variant, in fp64 at 64
    px, B=4: the JAX model's loss differentiated in two parts in one jit.
    The backbone's train-mode forward and its vjp are taken once, as every
    variant's backbone is the same (``_backbone_run``); each JAX
    ``TextureModel`` runs on that output (its ``backbone`` stubbed) under
    ``jax.value_and_grad`` with respect to its head's parameters and the
    output; the backbone's vjp is then mapped over the variants' output
    gradients. By the chain rule these are the whole model's gradients."""
    if not _TRAIN:
        rng = np.random.default_rng(3)
        x = rng.standard_normal((4, 64, 64, 3))
        labels, weights = rng.integers(0, NUM_CLASSES, 4), np.ones(4)
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
            merged = {v: f64(_variant("resnet18", v)[0]) for v in TRAIN_VARIANTS}
            bb = {c: merged[TRAIN_VARIANTS[0]][c]["backbone"] for c in ("params", "batch_stats")}
            heads = {v: {c: {k: t for k, t in merged[v][c].items() if k != "backbone"}
                         for c in ("params", "batch_stats")} for v in TRAIN_VARIANTS}
            # the backbone JAX's TextureModel builds for ResNet18 (zoo.py)
            backbone = JaxResNet(block="basic", layers=(2, 2, 2, 2), dtype=jnp.float64)
            models = {v: jax_get_model("resnet18", v, NUM_CLASSES, dtype=jnp.float64)
                      for v in TRAIN_VARIANTS}

            def steps(bb_params, head_params):
                feat, bb_vjp, bb_stats = jax.vjp(
                    lambda p: backbone.apply({"params": p, "batch_stats": bb["batch_stats"]},
                                             x, True, mutable=["batch_stats"]),
                    bb_params, has_aux=True)
                out, cots = {}, []
                for v, model in models.items():
                    def loss_fn(hp, f, model=model, v=v):
                        with _stub_backbone(f):
                            logits, mut = model.apply(
                                {"params": hp, "batch_stats": heads[v]["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
                        return (jengine.cross_entropy_loss(logits, labels, weights),
                                mut["batch_stats"])

                    (loss, stats), (g_head, g_feat) = jax.value_and_grad(
                        loss_fn, argnums=(0, 1), has_aux=True)(head_params[v], feat)
                    out[v] = (loss, stats, g_head)
                    cots.append(g_feat)
                (g_bb,) = jax.vmap(bb_vjp)(jnp.stack(cots))
                return out, g_bb, bb_stats["batch_stats"]

            out, g_bb, bb_stats = jax.tree_util.tree_map(np.asarray, jax.jit(steps)(
                bb["params"], {v: heads[v]["params"] for v in TRAIN_VARIANTS}))
        for i, v in enumerate(TRAIN_VARIANTS):  # g_bb's order (a pytree's dict is sorted)
            loss, stats, g_head = out[v]
            _TRAIN[v] = (loss, {**stats, "backbone": bb_stats},
                         {**g_head, "backbone": jax.tree_util.tree_map(lambda a: a[i], g_bb)})
        _TRAIN["batch"] = (x, labels, weights)
    return _TRAIN


@pytest.mark.parametrize("variant", TRAIN_VARIANTS)
def test_train_step_matches_jax(variant):
    """One ResNet18 train step at 64 px, B=4 (no dropout in these heads),
    in fp64 on both sides: the loss, every gradient and the new BatchNorm
    statistics against the JAX model's (``_jax_train_steps``).

    Why fp64: in fp32 the port's step is ~1e-4 of a tensor's largest
    gradient off its own fp64 step on these weights, and the JAX CPU
    step's stem BatchNorm bias 0.5-2% off (the ResNet50 train step's
    reason, ``tests/test_torch_resnet50.py``)."""
    steps = _jax_train_steps()
    want_loss, want_stats, want_grads = steps[variant]
    x, labels, weights = steps["batch"]
    merged, _, _ = _variant("resnet18", variant)
    assert want_loss.dtype == np.float64
    model = _port_model("resnet18", variant, merged)
    state = engine.create_train_state(model, 0, 1e-3,
                                      init_variables=state_dict_from_flax(merged))
    model.double()
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(labels),
             "weight": torch.from_numpy(weights)}
    loss, _ = engine.train_step(state, batch, NUM_CLASSES)
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    # from_jax rounds to fp32 (6e-8), far inside the bar
    _check_grads({n: p.grad.numpy() for n, p in model.named_parameters()},
                 _port_tree(want_grads), variant)
    _check_stats(model, _port_stats(want_stats))
