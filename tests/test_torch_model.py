"""The PyTorch port's ResNet18 models (``gap_only``, ``texture_nfp`` and
``nfp_at_layer``) against the JAX package's, on the CPU.

The JAX ``TextureModel`` is initialised from ``PRNGKey(0)``; every BatchNorm
scale, shift, running mean and variance and every bias is then replaced by
numpy draws, so a swapped or transposed mapping cannot hide behind an
identity BatchNorm or a zero bias. ``state_dict_from_flax`` carries the tree
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

NUM_CLASSES = 5
TOL = dict(rtol=1e-4, atol=1e-4)


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


_JAX_CASES = {}


def _jax_case(variant, size, stem_s2d=False, **kwargs):
    """(variables, images, logits) of the JAX model, once per configuration."""
    key = (variant, size, stem_s2d) + tuple(sorted(kwargs.items()))
    if key not in _JAX_CASES:
        model = jax_get_model("resnet18", variant, NUM_CLASSES, stem_s2d=stem_s2d, **kwargs)
        x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
        init = model.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]), train=False)
        variables = _randomise(init, seed=size)
        logits = np.asarray(jax.jit(lambda v, xx: model.apply(v, xx, train=False))(variables, x))
        _JAX_CASES[key] = (init, variables, x, logits)
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
    _, variables, x, want = _jax_case(variant, size, stem_s2d)
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
    _, variables, x, want = _jax_case("nfp_at_layer", size, nfp_layer_idx=idx)
    model = _port_model("nfp_at_layer", variables, nfp_layer_idx=idx)
    assert model.nfp_at_layer.compress.conv.weight.shape == (64 * 2 ** idx, 8, 1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


def test_state_dict_keys_are_the_reference_keys():
    """The submodule names give timm's and the reference's keys."""
    _, variables, _, _ = _jax_case("texture_nfp", 64)
    keys = set(_port_model("texture_nfp", variables).state_dict())
    for k in ("backbone.conv1.weight", "backbone.bn1.running_var",
              "backbone.layer2.0.downsample.0.weight",
              "backbone.layer2.0.downsample.1.num_batches_tracked",
              "pool.nfp_proj.weight", "pool.nfp_proj.bias", "fc.weight", "fc.bias"):
        assert k in keys, k


def test_state_dict_round_trips_through_the_jax_importer():
    """The port's state_dict, read by the JAX package's own reference
    checkpoint importer, gives back the original flax tree exactly."""
    init, variables, _, _ = _jax_case("texture_nfp", 64)
    sd = {k: v.numpy() for k, v in _port_model("texture_nfp", variables).state_dict().items()}
    back, _ = import_reference_checkpoint(sd, "resnet18", "texture_nfp",
                                          validate_against=init)
    want = jax.tree_util.tree_leaves_with_path(
        {k: variables[k] for k in ("params", "batch_stats")})
    got = dict(jax.tree_util.tree_leaves_with_path(
        {k: back[k] for k in ("params", "batch_stats")}))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_model("resnet18", "texture_fractal", NUM_CLASSES)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 4"):
        get_model("resnet50", "texture_fractal", NUM_CLASSES)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 4"):
        get_model("mobilenetv3", "gap_nfp_conv_mlp_concat", NUM_CLASSES)
    with pytest.raises(ValueError, match="Unknown model_variant"):
        get_model("resnet18", "no_such_head", NUM_CLASSES)
