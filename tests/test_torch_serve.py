"""The PyTorch port's ``Predictor`` against the JAX package's, on the CPU.

The JAX ``Predictor`` (ResNet18 + texture_nfp, 5 classes, batch 4, 64 px;
and MobileNetV3 + multi_stage_nfp at 64 px, whose 32² tap takes the
large-map kernel's route) builds its weights from ``PRNGKey(0)``;
``state_dict_from_flax`` turns them into a ``torch.save``d state_dict that
the port's ``Predictor(device="cpu")`` serves. Both answer the same raw images. Tolerance: the repo's fp32 bar,
1e-4 on the probabilities; labels equal.
"""

import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu.serve import Predictor as JaxPredictor
from neighbour_feature_pooling_tpu_torch.models import state_dict_from_flax
from neighbour_feature_pooling_tpu_torch.serve import Predictor

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
