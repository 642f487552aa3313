"""The PyTorch port's ``Predictor`` against the JAX package's, on the CPU.

The JAX ``Predictor`` (ResNet18 + texture_nfp, 5 classes, batch 4, 64 px;
and MobileNetV3 + multi_stage_nfp at 64 px, whose 32² tap takes the
large-map kernel's route) builds its weights from ``PRNGKey(0)``;
``state_dict_from_flax`` turns them into a ``torch.save``d state_dict that
the port's ``Predictor(device="cpu")`` serves. Both answer the same raw images. Tolerance: the repo's fp32 bar,
1e-4 on the probabilities; labels equal.

int8: the JAX int8 ``Predictor`` on the same weights, with its weights
baked and its forward run op by op (``jax.disable_jit``): compiled for the
CPU, XLA turns ``amax / 127`` into a multiply by the reciprocal and
contracts the epilogue's multiply and add into one fma, while the port
(and the JAX source) rounds each op on its own (ROADMAP.md Queue 3). The
two int8 tiers then agree to 1e-5 on the probabilities.
"""

import jax
import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu import quant as jax_quant
from neighbour_feature_pooling_tpu.serve import Predictor as JaxPredictor
from neighbour_feature_pooling_tpu_torch import quant
from neighbour_feature_pooling_tpu_torch import serve as torch_serve
from neighbour_feature_pooling_tpu_torch.models import state_dict_from_flax, torch_module_name
from neighbour_feature_pooling_tpu_torch.ops import int8_conv2d, int8_gemm
from neighbour_feature_pooling_tpu_torch.serve import Predictor
from test_torch_model import one_torch_thread  # noqa: F401

KW = dict(model_type="resnet18", model_variant="texture_nfp", num_classes=5,
          batch_size=4, input_size=64, resize_size=72)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((int(rng.integers(60, 100)), int(rng.integers(60, 100)), 3),
                       dtype=np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    jax_pred = JaxPredictor(**KW)
    path = str(tmp_path_factory.mktemp("weights") / "texture_nfp.pt")
    torch.save(state_dict_from_flax(jax_pred._variables), path)
    return jax_pred, Predictor(**KW, checkpoint=path, device="cpu"), path


@pytest.mark.parametrize("n", [0, 3, 9])
def test_predict_matches_jax(predictors, n):
    """0 (empty), 3 (one padded batch) and 9 (three batches, the last
    padded) images per request."""
    jax_pred, pred, _ = predictors
    images = _images(n, seed=n)
    want, got = jax_pred.predict(images), pred.predict(images)
    assert got["probabilities"].shape == want["probabilities"].shape == (n, 5)
    assert got["probabilities"].dtype == np.float32
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               rtol=1e-4, atol=1e-4)
    if n:
        np.testing.assert_allclose(got["probabilities"].sum(-1), 1.0, atol=1e-5)


MNV3_KW = dict(KW, model_type="mobilenetv3", model_variant="multi_stage_nfp")


def test_mobilenetv3_predict_matches_jax(tmp_path):
    """Two batches (the second padded) through MobileNetV3 +
    multi_stage_nfp."""
    jax_pred = JaxPredictor(**MNV3_KW)
    path = str(tmp_path / "multi_stage_nfp.pt")
    torch.save(state_dict_from_flax(jax_pred._variables), path)
    pred = Predictor(**MNV3_KW, checkpoint=path, device="cpu")
    images = _images(6, seed=11)
    want, got = jax_pred.predict(images), pred.predict(images)
    assert got["probabilities"].shape == want["probabilities"].shape == (6, 5)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               rtol=1e-4, atol=1e-4)


def test_preprocess_is_bit_identical(predictors):
    jax_pred, pred, _ = predictors
    images = _images(3, seed=7) + [(np.random.default_rng(8).random((50, 80, 3)) * 255)
                                   .astype(np.uint8)]
    np.testing.assert_array_equal(pred.preprocess(images), jax_pred.preprocess(images))


def test_reload_rejects_another_class_count(predictors, tmp_path):
    _, pred, path = predictors
    other = Predictor(**dict(KW, num_classes=3), device="cpu")
    bad = str(tmp_path / "three_classes.pt")
    torch.save(other.model.state_dict(), bad)
    before = {k: v.clone() for k, v in pred.model.state_dict().items()}
    with pytest.raises(ValueError, match="incompatible"):
        pred.reload(bad)
    assert pred.checkpoint == path
    for k, v in pred.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert pred.reload() == path


def test_seeded_weights_repeat():
    """Without a checkpoint the weights come from torch.Generator seed 0."""
    a = Predictor(**KW, device="cpu").model.state_dict()
    b = Predictor(**KW, device="cpu").model.state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_cuda_predictor_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(**KW)


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError, match="quantize"):
        Predictor(**KW, quantize="int4", device="cpu")


def test_calibrate_requires_int8(predictors):
    _, pred, _ = predictors
    with pytest.raises(ValueError, match="int8"):
        pred.calibrate(_images(2, seed=1))


@pytest.fixture(scope="module")
def int8_predictors(predictors):
    """The JAX int8 Predictor on ``PRNGKey(0)`` weights, baked and folded op
    by op, and the port's int8 Predictor on the same weights."""
    _, _, path = predictors
    jax_pred = JaxPredictor(**KW, quantize="int8")
    with jax.disable_jit():
        jax_pred._variables["int8w"] = jax_quant.prequantize_weights(
            jax_pred._variables, jax_quant.QuantConfig())
        jax_pred._build_forward()
    return jax_pred, Predictor(**KW, quantize="int8", checkpoint=path, device="cpu")


def _close_to_jax(got, want):
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               rtol=1e-5, atol=1e-5)


def test_int8_predict_matches_jax(int8_predictors):
    """Dynamic activation scales, BN folded; 6 images = 2 batches, the
    second padded; every conv of the backbone swapped, the classifier and
    the NFP projection (fan-in 8) left fp32; no kernel launched on the CPU."""
    jax_pred, pred = int8_predictors
    images = _images(6, seed=21)
    with jax.disable_jit():
        want = jax_pred.predict(images)
    before = (int8_gemm.launches, int8_conv2d.launches)
    _close_to_jax(pred.predict(images), want)
    assert (int8_gemm.launches, int8_conv2d.launches) == before
    kinds = [type(m).__name__ for m in pred.model.modules()]
    assert kinds.count("Int8Conv2d") == 20 and "Int8Linear" not in kinds
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in pred.model.modules())


def test_int8_calibrate_matches_jax(int8_predictors):
    """``calibrate`` returns JAX's layer count and finds JAX's 8 chains;
    with JAX's scales and chains copied in (the float forwards the two
    calibrations observe differ by fp32 rounding) the calibrated, chained
    tiers agree. Runs after the dynamic case: it calibrates both."""
    jax_pred, pred = int8_predictors
    images = _images(6, seed=22)
    with jax.disable_jit():
        n = jax_pred.calibrate(images)
        assert pred.calibrate(images) == n == 20
        assert set(pred._int8_chains) == {torch_module_name(k) for k in jax_pred._int8_chains}
        pred._act_scales = {torch_module_name(k): v for k, v in jax_pred._act_scales.items()}
        pred._int8_chains = {torch_module_name(k): v for k, v in jax_pred._int8_chains.items()}
        pred._rebuild()
        _close_to_jax(pred.predict(images), jax_pred.predict(images))
    chained = [m for m in pred.model.modules()
               if isinstance(m, quant.Int8Conv2d) and m.cons_scale is not None]
    assert len(chained) == 8


def test_int8_reload_rebuilds_and_drops_calibration(predictors, tmp_path, monkeypatch):
    """int8 reload re-bakes the weights and drops the calibration: it
    answers as a fresh int8 Predictor on the new checkpoint (JAX
    test_serve.py:294-330); a rebuild that fails leaves the old state."""
    _, _, path_a = predictors
    path_b = str(tmp_path / "b.pt")
    init = Predictor(**KW, device="cpu")  # torch.Generator seed 0 weights
    torch.save(init.state_dict(), path_b)
    pred = Predictor(**KW, quantize="int8", checkpoint=path_a, device="cpu")
    images = _images(4, seed=23)
    pred.calibrate(images)
    out_a = pred.predict(images)["probabilities"]
    assert pred.reload(path_b) == path_b
    assert pred._act_scales is None and pred._int8_chains is None
    out_b = pred.predict(images)["probabilities"]
    assert not np.allclose(out_a, out_b)
    fresh = Predictor(**KW, quantize="int8", checkpoint=path_b, device="cpu")
    np.testing.assert_array_equal(out_b, fresh.predict(images)["probabilities"])
    np.testing.assert_array_equal(pred.state_dict()["fc.weight"], init.state_dict()["fc.weight"])

    def broken(*args, **kwargs):
        raise RuntimeError("rebuild failed")

    fresh.calibrate(images)
    calibrated = fresh.predict(images)["probabilities"]
    monkeypatch.setattr(torch_serve, "build_bn_folding", broken)
    with pytest.raises(RuntimeError, match="rebuild failed"):
        fresh.reload(path_a)
    assert fresh.checkpoint == path_b and fresh._act_scales is not None
    np.testing.assert_array_equal(fresh.predict(images)["probabilities"], calibrated)


@pytest.mark.parametrize("option,config", [
    (dict(fold_bn=False), quant.QuantConfig()),
    (dict(quantize_spatial=False), None),
], ids=["fold_bn=False", "quantize_spatial=False"])
def test_int8_predictor_options(predictors, option, config):
    """``fold_bn=False`` keeps every BatchNorm; the mixed tier swaps only
    the three 1×1 downsample convs. Either way the Predictor serves what
    ``quant.quantize_model`` builds from its weights and configuration
    (held against the JAX package in test_torch_quant.py)."""
    _, fp32, path = predictors
    pred = Predictor(**KW, quantize="int8", checkpoint=path, device="cpu", **option)
    model = fp32._new_model()
    model.load_state_dict(fp32.state_dict())
    model.to(memory_format=torch.channels_last)
    if config is None:  # the mixed tier folds the BNs of its three convs
        config = quant.QuantConfig(quantize_spatial=False, bn_folding=quant.build_bn_folding(
            model, torch.zeros(1, KW["input_size"], KW["input_size"], 3),
            quant.QuantConfig(quantize_spatial=False)))
    quant.quantize_model(model, config)
    swapped = [n for n, m in pred.model.named_modules() if isinstance(m, quant.Int8Conv2d)]
    bns = [m for m in pred.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if "fold_bn" in option:
        assert len(swapped) == 20 and len(bns) == 20
    else:
        assert swapped == [f"backbone.layer{i}.0.downsample.0" for i in (2, 3, 4)]
        assert len(bns) == 17
    images = _images(4, seed=24)  # one full batch: dynamic scales are per batch
    x = torch.from_numpy(pred.preprocess(images))
    with torch.no_grad():
        want = torch.softmax(model(x), dim=-1).numpy()
    np.testing.assert_array_equal(pred.predict(images)["probabilities"], want)
