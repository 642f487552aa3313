"""The PyTorch port's ResNet18 models (``gap_only``, ``texture_nfp`` and
``nfp_at_layer``) against the JAX package's, on the CPU.

The JAX ``TextureModel``'s variables are numpy draws on its traced tree
(``_draw_variables``): every BatchNorm scale, shift, running mean and
variance and every bias away from its identity value, so a swapped or
transposed mapping cannot hide behind an identity BatchNorm or a zero
bias. ``state_dict_from_flax`` carries the tree
into the port, and both models see the same numpy images.

Tolerance: the repo's fp32 bar, 1e-4 on the logits (convolutions sum in
other orders in XLA and in PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.models.import_torch import import_reference_checkpoint
from neighbour_feature_pooling_tpu_torch.models import get_model, state_dict_from_flax
from neighbour_feature_pooling_tpu_torch.quant import Int8Conv2d
from neighbour_feature_pooling_tpu_torch.serve import Predictor

NUM_CLASSES = 5
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a port test module runs (the port's test
    modules import this fixture, but ``test_torch_train.py``, whose
    ResNet18 train steps match JAX's to 1e-4 only in the summation order of
    torch's default threads). The whole suite runs as six pytest-xdist
    workers on eight cores, where torch's default of one thread per core
    makes the threads contend (the trainer module ran 313 s there against
    25 s alone); at the port tests' sizes one thread is as fast alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jit_reference(fn):
    """``jax.jit`` of a small JAX reference computation with LLVM's
    optimisation off (``xla_backend_optimization_level`` 0): XLA's own
    passes still run, and the code computes the same operations in the
    same order, only unoptimised by LLVM, which halves the CPU time of a
    compile. Not for a backbone: its convolutions then run several times
    slower than the compile saves."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _randomise(variables, seed):
    """Numpy draws for every BatchNorm leaf and every bias."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        names = [getattr(k, "key", str(k)) for k in path]
        v = np.asarray(v)
        if names[-1] == "var":
            return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        if names[-1] == "mean":
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if names[-1] == "bias":
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _draw_variables(model, *args, seed, **kwargs):
    """Variables of the flax ``model`` for ``model.init(*args, **kwargs)``:
    the tree's shapes are traced (never compiled: a jitted init of a whole
    network costs ~13 s on the CPU, an eager one more), the values numpy
    draws: kernels normal with std 1/sqrt(fan_in), ViT's tokens normal
    with std 0.02, DeepTEN's codewords uniform in ±1/sqrt(K·D), the rest
    (BatchNorm, biases, scales) as ``_randomise`` draws them."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, *args, **kwargs),
                            jax.random.PRNGKey(0))

    def leaf(path, v):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "kernel":
            return (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                    ).astype(np.float32)
        if name in ("cls_token", "pos_embed"):
            return (0.02 * rng.standard_normal(v.shape)).astype(np.float32)
        if name == "codewords":
            return (rng.uniform(-1.0, 1.0, v.shape) / np.sqrt(np.prod(v.shape))
                    ).astype(np.float32)
        return np.zeros(v.shape, np.float32)

    return _randomise(jax.tree_util.tree_map_with_path(leaf, shapes), seed)


_JAX_CASES = {}


def _jax_case(variant, size, stem_s2d=False, **kwargs):
    """(variables, images, logits) of the JAX model, once per configuration."""
    key = (variant, size, stem_s2d) + tuple(sorted(kwargs.items()))
    if key not in _JAX_CASES:
        model = jax_get_model("resnet18", variant, NUM_CLASSES, stem_s2d=stem_s2d, **kwargs)
        x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
        variables = _draw_variables(model, x[:1], train=False, seed=size)
        logits = np.asarray(jax.jit(lambda v, xx: model.apply(v, xx, train=False))(variables, x))
        _JAX_CASES[key] = (variables, x, logits)
    return _JAX_CASES[key]


def _port_model(variant, variables, stem_s2d=False, **kwargs):
    model = get_model("resnet18", variant, NUM_CLASSES, stem_s2d=stem_s2d, **kwargs)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


# 64 and 96 px give 2x2 and 3x3 head maps; 45 px makes odd maps (23, 12,
# 6, 3, 2) so the strided 1x1 downsample convs see odd inputs, where flax's
# "SAME" padding must still be 0; the space-to-depth stem is a TPU layout
# of the same 7x7/2 conv and the port computes the direct conv
CASES = [("gap_only", 64, False), ("texture_nfp", 64, False),
         ("gap_only", 96, False), ("texture_nfp", 96, False),
         ("texture_nfp", 45, False), ("texture_nfp", 64, True)]


@pytest.mark.parametrize("variant,size,stem_s2d", CASES)
def test_logits_match_jax(variant, size, stem_s2d):
    variables, x, want = _jax_case(variant, size, stem_s2d)
    model = _port_model(variant, variables, stem_s2d)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


# nfp_at_layer taps layer{idx+1} with the zoo's padding 0: at 128 px,
# layer4's 4x4 map gives a 2x2 NFP map (at 64 px its 2x2 map would give
# none); at 64 px, layer3's 4x4 gives 2x2 and layer1's 16x16 gives 14x14
@pytest.mark.parametrize("idx,size", [(3, 128), (2, 64), (0, 64)])
def test_nfp_at_layer_logits_match_jax(idx, size):
    variables, x, want = _jax_case("nfp_at_layer", size, nfp_layer_idx=idx)
    model = _port_model("nfp_at_layer", variables, nfp_layer_idx=idx)
    assert model.nfp_at_layer.compress.conv.weight.shape == (64 * 2 ** idx, 8, 1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


def test_state_dict_keys_are_the_reference_keys():
    """The submodule names give timm's and the reference's keys."""
    variables, _, _ = _jax_case("texture_nfp", 64)
    keys = set(_port_model("texture_nfp", variables).state_dict())
    for k in ("backbone.conv1.weight", "backbone.bn1.running_var",
              "backbone.layer2.0.downsample.0.weight",
              "backbone.layer2.0.downsample.1.num_batches_tracked",
              "pool.nfp_proj.weight", "pool.nfp_proj.bias", "fc.weight", "fc.bias"):
        assert k in keys, k


def test_state_dict_round_trips_through_the_jax_importer():
    """The port's state_dict, read by the JAX package's own reference
    checkpoint importer, gives back the original flax tree exactly."""
    variables, _, _ = _jax_case("texture_nfp", 64)
    sd = {k: v.numpy() for k, v in _port_model("texture_nfp", variables).state_dict().items()}
    back, _ = import_reference_checkpoint(sd, "resnet18", "texture_nfp",
                                          validate_against=variables)
    want = jax.tree_util.tree_leaves_with_path(
        {k: variables[k] for k in ("params", "batch_stats")})
    got = dict(jax.tree_util.tree_leaves_with_path(
        {k: back[k] for k in ("params", "batch_stats")}))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("model_type,variant,error,match", [
    ("resnet50", "gap_mlp", ValueError, "Unknown model_variant"),
    ("vittiny", "se_gate", ValueError, "Unknown model_variant"),
    ("resnet18", "no_such_head", ValueError, "Unknown model_variant"),
    ("resnet18", "texture_fractal", None, None),
    ("mobilenetv3", "gap_nfp_conv_mlp_concat", None, None),
])
def test_unported_variants_raise(model_type, variant, error, match):
    """A pair the JAX registry lacks raises ValueError in both packages;
    every pair of the registry builds, and serves int8."""
    if error is ValueError:
        with pytest.raises(ValueError, match=match):
            jax_get_model(model_type, variant, NUM_CLASSES)
        with pytest.raises(ValueError, match=match):
            get_model(model_type, variant, NUM_CLASSES)
        return
    assert get_model(model_type, variant, NUM_CLASSES).model_variant == variant
    pred = Predictor(model_type, variant, NUM_CLASSES, quantize="int8", fold_bn=False,
                     device="cpu")
    assert any(isinstance(m, Int8Conv2d) for m in pred.model.modules())
