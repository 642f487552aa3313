"""The PyTorch port's MobileNetV3-Large models against the JAX package's, on
the CPU.

As in ``test_torch_model.py``: the JAX ``TextureModel``'s variables are
numpy draws on its traced tree, every BatchNorm leaf and every bias away
from its identity value (so a swapped stage-0 BatchNorm or a transposed
depthwise kernel cannot hide behind an identity), ``state_dict_from_flax``
carries the tree into the port, and both models see the same numpy images.

At 96 px the taps are 48²×16, 24²×24, 12²×40, 6²×112 and 3²×960: the first
two take the large-map kernel's route (K2), the rest the small-map one
(K1). At 64 px the 16² tap sits at K1's 256-position edge.

Tolerance: the repo's fp32 bar, 1e-4 on the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.models.import_torch import import_reference_checkpoint
from neighbour_feature_pooling_tpu_torch.models import get_model, state_dict_from_flax
from neighbour_feature_pooling_tpu_torch.ops.nfp_cuda import _route
from test_torch_model import _draw_variables, one_torch_thread  # noqa: F401

NUM_CLASSES = 5
TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = ("gap_only", "texture_nfp", "texture_nfp_intermediate", "mid_nfp",
            "multi_stage_nfp", "nfp_insert")

_JAX_CASES = {}


def _jax_case(variant, size):
    """(variables, images, logits) of the JAX model, once per case: numpy
    variables on the traced tree (``_draw_variables``), applied by one
    jit (~2-6 s; the eager apply's compile of each op took 26 s at the
    first case)."""
    key = (variant, size)
    if key not in _JAX_CASES:
        model = jax_get_model("mobilenetv3", variant, NUM_CLASSES)
        x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
        variables = _draw_variables(model, x[:1], train=False, seed=size)
        logits = np.asarray(jax.jit(lambda v, xx: model.apply(v, xx, train=False))(
            variables, x))
        _JAX_CASES[key] = (variables, x, logits)
    return _JAX_CASES[key]


def _port_model(variant, variables):
    model = get_model("mobilenetv3", variant, NUM_CLASSES)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


CASES = [(v, 96) for v in VARIANTS] + [("multi_stage_nfp", 64), ("gap_only", 57)]


@pytest.mark.parametrize("variant,size", CASES)
def test_logits_match_jax(variant, size):
    variables, x, want = _jax_case(variant, size)
    model = _port_model(variant, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size,routes", [
    (96, ["k2", "k2", "kernel", "kernel", "kernel"]),
    (64, ["k2", "kernel", "kernel", "kernel", "kernel"]),
])
def test_multi_stage_taps_take_the_jax_routes(size, routes):
    """The five features taps, with multi_stage_nfp's NFP settings, go where
    the JAX nfp sends them."""
    model = get_model("mobilenetv3", "multi_stage_nfp", NUM_CLASSES).eval()
    with torch.no_grad():
        feats, _ = model.backbone(torch.zeros(1, size, size, 3), mode="features+head")
    assert [f.shape[-1] for f in feats] == [16, 24, 40, 112, 960]
    assert all(f.is_contiguous() for f in feats)  # NHWC without a copy
    assert [_route(tuple(f.shape), 1, "cosine", 1, 1, 1, "NHWC", True)
            for f in feats] == routes


def test_state_dict_keys_are_the_timm_keys():
    """timm's names, including the stage-0 DepthwiseSeparableConv
    (conv_dw/bn1/conv_pw/bn2) and blocks.6.0.conv/bn1."""
    variables, _, _ = _jax_case("multi_stage_nfp", 96)
    keys = set(_port_model("multi_stage_nfp", variables).state_dict())
    for k in ("backbone.conv_stem.weight", "backbone.bn1.running_mean",
              "backbone.blocks.0.0.conv_dw.weight", "backbone.blocks.0.0.bn1.weight",
              "backbone.blocks.0.0.conv_pw.weight", "backbone.blocks.0.0.bn2.running_var",
              "backbone.blocks.1.0.conv_pwl.weight", "backbone.blocks.1.0.bn3.bias",
              "backbone.blocks.2.0.se.conv_reduce.bias",
              "backbone.blocks.2.0.se.conv_expand.weight",
              "backbone.blocks.6.0.conv.weight", "backbone.blocks.6.0.bn1.weight",
              "backbone.conv_head.weight", "backbone.conv_head.bias",
              "nfp_proj.weight", "fc.weight"):
        assert k in keys, k
    assert not any(k.startswith("backbone.blocks.0.0.bn3") for k in keys)
    insert = set(get_model("mobilenetv3", "nfp_insert", NUM_CLASSES).state_dict())
    assert "nfp_insert.nfp_proj.conv.weight" in insert
    assert "nfp_insert.nfp_proj.bn.running_var" in insert
    assert "nfp_mid_proj.bias" in set(get_model("mobilenetv3", "mid_nfp", NUM_CLASSES).state_dict())
    tap = set(get_model("mobilenetv3", "texture_nfp_intermediate", NUM_CLASSES).state_dict())
    assert "pool.nfp_proj.weight" in tap and not any(".blocks.2." in k for k in tap)


@pytest.mark.parametrize("variant", ["gap_only", "texture_nfp"])
def test_state_dict_round_trips_through_the_jax_importer(variant):
    """The port's state_dict, read by the JAX package's own reference
    checkpoint importer (timm_port.port_mobilenetv3), gives back the
    original flax tree exactly."""
    variables, _, _ = _jax_case(variant, 96)
    sd = {k: v.numpy() for k, v in _port_model(variant, variables).state_dict().items()}
    back, _ = import_reference_checkpoint(sd, "mobilenetv3", variant,
                                          validate_against=variables)
    want = jax.tree_util.tree_leaves_with_path(
        {k: variables[k] for k in ("params", "batch_stats")})
    got = dict(jax.tree_util.tree_leaves_with_path(
        {k: back[k] for k in ("params", "batch_stats")}))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
