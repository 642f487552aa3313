"""The PyTorch port's ResNet50 models against the JAX package's, on the CPU.

One JAX ResNet50 + texture_nfp tree of numpy draws on the traced tree
(``tests/test_torch_model.py::_draw_variables``: every BatchNorm
statistic, scale and shift and every bias away from its identity value)
serves every case:
``gap_only`` is the same tree without the ``pool`` head, and the backbone
subtree serves ``return_stages`` and the timm porter. ``state_dict_from_flax``
carries it into the port.

Tolerance: the repo's fp32 bar, 1e-4 on logits and stage maps; one train
step, in fp64 on both sides (the test says why), with its loss within 1e-4
and every gradient within 1e-4 of its tensor's largest magnitude (the JAX
gradient read from Adam's first moment).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neighbour_feature_pooling_tpu.models import get_model as jax_get_model
from neighbour_feature_pooling_tpu.models.backbones.resnet import resnet50 as jax_resnet50
from neighbour_feature_pooling_tpu.models.backbones.timm_port import port_resnet
from neighbour_feature_pooling_tpu.train import engine as jengine
from neighbour_feature_pooling_tpu_torch.models import get_model, state_dict_from_flax
from neighbour_feature_pooling_tpu_torch.train import engine
from test_torch_model import _draw_variables, one_torch_thread  # noqa: F401

NUM_CLASSES = 3
TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX model and its randomised variables, shared by every test."""
    model = jax_get_model("resnet50", "texture_nfp", NUM_CLASSES)
    return model, _draw_variables(model, np.zeros((1, 64, 64, 3), np.float32), train=False,
                                  seed=50)


def _without_pool(variables):
    return {k: {n: v for n, v in tree.items() if n != "pool"} for k, tree in variables.items()}


def _port(variant, variables):
    model = get_model("resnet50", variant, NUM_CLASSES)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("variant", ["gap_only", "texture_nfp"])
def test_logits_match_jax(jax_case, variant):
    """64 px, B=2: a (2, 2, 2, 2048) head map."""
    model, variables = jax_case
    if variant == "gap_only":
        model = jax_get_model("resnet50", "gap_only", NUM_CLASSES)
        variables = _without_pool(variables)
    x = _images((2, 64, 64, 3), seed=1)
    want = np.asarray(jax.jit(lambda v, xx: model.apply(v, xx, train=False))(variables, x))
    with torch.no_grad():
        got = _port(variant, variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got, want, **TOL)


def test_return_stages_match_jax(jax_case):
    """The four stage maps, NHWC, at 45 px (odd maps: 12, 6, 3, 2)."""
    _, variables = jax_case
    backbone = {k: tree["backbone"] for k, tree in variables.items()}
    x = _images((2, 45, 45, 3), seed=2)
    want = jax.jit(lambda v, xx: jax_resnet50().apply(v, xx, train=False,
                                                      return_stages=True))(backbone, x)
    with torch.no_grad():
        got = _port("texture_nfp", variables).backbone(torch.from_numpy(x), return_stages=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 12, 12, 256), (2, 6, 6, 512), (2, 3, 3, 1024), (2, 2, 2, 2048)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_port_resnet_gives_back_the_flax_tree(jax_case):
    """The port's backbone state_dict, read by the JAX timm porter
    (``port_resnet(..., layers=(3, 4, 6, 3), bottleneck=True)``), gives
    back the flax backbone tree bit for bit."""
    _, variables = jax_case
    sd = {k[len("backbone."):]: v.numpy()
          for k, v in _port("texture_nfp", variables).state_dict().items()
          if k.startswith("backbone.")}
    back = port_resnet(sd, layers=(3, 4, 6, 3), bottleneck=True)
    for kind in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[kind]["backbone"])
        got = dict(jax.tree_util.tree_leaves_with_path(back[kind]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                          err_msg=jax.tree_util.keystr(path))


def test_train_step_matches_jax(jax_case):
    """One train step at 64 px, B=2, in fp64 on both sides: the loss, every
    gradient and the BatchNorm running statistics.

    Why fp64: ResNet50's train step is not computable to 1e-4 in fp32 at
    a size the CPU affords. At 64 px, B=2, the port's fp32 gradients are up
    to 15% (median 1.4%) of a tensor's largest gradient off its fp64 step,
    and JAX's fp32 ones up to 37% (median 6.6%): ReLU masks that flip on
    one rounding and the BatchNorm backward's cancellations. In fp64 the
    two agree to ~2e-7. (At 32 px, layer4's BatchNorm sees two values per
    channel, and even the fp64 steps differ, by ~4e-4: flax takes the batch
    variance as E[x²] − E[x]², which cancels there.) The JAX ``nfp`` kernel
    returns fp32 even for fp64 input (nfp_pallas.py:303); its backward is
    the fp64 oracle's."""
    model, variables = jax_case
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 64, 64, 3))
    labels, weights = np.array([0, 2], np.int32), np.ones(2)
    with jax.enable_x64(True):
        model = jax_get_model("resnet50", "texture_nfp", NUM_CLASSES, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
        jstate = jengine.TrainState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                                    batch_stats=v64["batch_stats"],
                                    opt_state=tx.init(v64["params"]), tx=tx,
                                    apply_fn=model.apply)
        jstate, jloss, _ = jax.jit(lambda s, b: jengine.train_step_body(
            s, b, jax.random.PRNGKey(1), False, NUM_CLASSES))(
            jstate, {"image": images, "label": labels, "weight": weights})
        mu, stats = jax.tree_util.tree_map(np.asarray, (jstate.opt_state[0].mu,
                                                        jstate.batch_stats))
    assert jloss.dtype == jnp.float64

    port = get_model("resnet50", "texture_nfp", NUM_CLASSES)
    state = engine.create_train_state(port, 0, LR, init_variables=state_dict_from_flax(variables))
    port.double()
    loss, _ = engine.train_step(state, {"image": torch.from_numpy(images),
                                        "label": torch.from_numpy(labels),
                                        "weight": torch.from_numpy(weights)}, NUM_CLASSES)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    # state_dict_from_flax rounds to fp32: 6e-8, far inside the bar
    grads = state_dict_from_flax({"params": mu})
    got = dict(port.named_parameters())
    assert set(got) == set(grads)
    for name, m in grads.items():
        want = m.double().numpy() / 0.1  # Adam's first moment: mu = (1 − b1)·g
        err = float(np.abs(got[name].grad.numpy() - want).max()) / max(float(np.abs(want).max()),
                                                                        1e-30)
        assert err <= 1e-4, f"{name}: grad off by {err:.2e} of its max"
    sd = port.state_dict()
    for name, v in state_dict_from_flax({"params": {}, "batch_stats": stats}).items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
