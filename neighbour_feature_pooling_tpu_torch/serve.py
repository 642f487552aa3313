"""Serving: a batched predictor (counterpart of ``neighbour_feature_pooling_tpu/
serve.py``).

``Predictor`` wraps a ``TextureModel``: host-side preprocessing through the
eval transform, requests chunked and padded to a fixed batch size, a forward
on the device under ``torch.inference_mode()``, softmax probabilities and
argmax labels out. It runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises. It serves
whatever ``models.get_model`` builds, every (type, variant) pair of the
JAX registry, whose options reach the model through ``model_kwargs``.

``quantize="int8"`` serves the int8 tier of ``quant.py`` for every pair,
as the JAX ``Predictor(quantize="int8")`` does: the same layers go int8
(``quant.py``'s module docstring). Weights quantized once at build, BN
folded into the conv epilogues (``fold_bn``), every eligible conv and
linear through the int8 kernels K4 and K5, and
``calibrate`` for static activation scales and s8 chains. The float
weights stay on the host for ``calibrate`` and ``reload``.

Not ported yet: reference-checkpoint import, data-parallel serving, export
and the HTTP server (ROADMAP.md Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .data.transforms import TransformConfig, eval_transform
from .models import get_model, init_params
from .quant import (QuantConfig, build_bn_folding, build_int8_chains,
                    calibrate_act_scales, prequantize_weights, quantize_model)
from .train.checkpoint import checkpoint_exists, restore_for_inference

__all__ = ["Predictor"]


def _resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Predictor(device={device!r}) needs a CUDA device and "
                           "none is available; pass device='cpu' to run on the CPU")
    return dev


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of ``path``: a ``train.save_checkpoint`` prefix
    (``<path>.pt`` exists), as the JAX ``Predictor`` takes, or a bare
    ``torch.save``d state_dict file."""
    if checkpoint_exists(path):
        return restore_for_inference(path)
    return torch.load(path, map_location="cpu", weights_only=True)


@dataclasses.dataclass
class Predictor:
    """Inference endpoint for a texture-pooling classifier."""

    model_type: str
    model_variant: str
    num_classes: int
    checkpoint: Optional[str] = None      # a save_checkpoint prefix or a
    #                                       torch.save'd state_dict; None:
    #                                       weights from torch.Generator seed 0
    batch_size: int = 32
    input_size: int = 224
    resize_size: int = 256
    num_input_channels: int = 3
    transform: Optional[TransformConfig] = None
    model_kwargs: Optional[Dict] = None
    quantize: Optional[str] = None        # None (fp32) | "int8"
    fold_bn: bool = True                  # int8 only: fold inference BNs
    #                                       into the conv dequant epilogue
    quantize_spatial: bool = True         # int8 only: False = mixed tier
    #                                       (linears and 1×1 convs int8,
    #                                       spatial convs stay fp32)
    device: str = "cuda"

    def __post_init__(self):
        self._device = _resolve_device(self.device)
        if self.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {self.quantize!r}; "
                             "expected None or 'int8'")
        self.transform = self.transform or TransformConfig(
            resize_size=self.resize_size, input_size=self.input_size)
        model = self._new_model()
        if self.checkpoint:
            sd = _load_state_dict(self.checkpoint)
            self._check_compatible(sd, self.checkpoint, model.state_dict())
            model.load_state_dict(sd)
        else:
            init_params(model, torch.Generator().manual_seed(0))
        if self.quantize == "int8":
            self._set_float_state(model.state_dict())
            self._act_scales = self._int8_chains = None
            self._rebuild()
        else:
            self.model = model.to(device=self._device, memory_format=torch.channels_last)

    def _new_model(self) -> torch.nn.Module:
        return get_model(self.model_type, self.model_variant, self.num_classes,
                         num_input_channels=self.num_input_channels,
                         **(self.model_kwargs or {})).eval()

    def _set_float_state(self, sd: Mapping[str, torch.Tensor]) -> None:
        """int8: keep the float weights on the host (for ``calibrate`` and
        ``reload``) and quantize the eligible ones once."""
        model = self._new_model()
        model.load_state_dict(sd)
        self._float_state = model.state_dict()
        self._int8w = prequantize_weights(
            model, QuantConfig(quantize_spatial=self.quantize_spatial))

    def _float_model(self) -> torch.nn.Module:
        model = self._new_model()
        model.load_state_dict(self._float_state)
        return model.to(device=self._device, memory_format=torch.channels_last)

    def _rebuild(self) -> None:
        """int8: build the serving model from the float weights, the baked
        s8 weights, BN folding and any calibrated scales and chains."""
        model = self._float_model()
        cfg = QuantConfig(quantize_spatial=self.quantize_spatial,
                          act_scales=self._act_scales,
                          int8_chains=self._int8_chains)
        if self.fold_bn:
            sample = torch.zeros((1, self.input_size, self.input_size,
                                  self.num_input_channels), device=self._device)
            cfg = dataclasses.replace(cfg, bn_folding=build_bn_folding(model, sample, cfg))
        self._quant_config = cfg
        self.model = quantize_model(model, cfg, weights=self._int8w)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The float weights served (quantized from them under int8): a
        checkpoint another ``Predictor`` of this model can load."""
        if self.quantize == "int8":
            return dict(self._float_state)
        return self.model.state_dict()

    def calibrate(self, images: Sequence[np.ndarray],
                  preprocessed: bool = False) -> int:
        """Static activation calibration for the int8 tier.

        Observes ``max|x|`` per quantized layer of the float model over the
        images (any count, padded with zero rows to a multiple of the batch
        size; zero rows never raise a maximum) and rebuilds the serving
        model with every layer on its fixed calibrated scale. With the
        scales known, conv → conv chains (``quant.build_int8_chains``)
        activate too: chained producers emit requantized s8 with the ReLU
        fused, verified end to end against the unchained model first.
        Returns the number of calibrated layers.
        """
        if self.quantize != "int8":
            raise ValueError("calibrate() requires quantize='int8'")
        x = (np.asarray(images, np.float32) if preprocessed
             else self.preprocess(images))
        pad = (-x.shape[0]) % self.batch_size
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)])
        batches = [torch.from_numpy(np.ascontiguousarray(x[i: i + self.batch_size]))
                   .to(self._device) for i in range(0, x.shape[0], self.batch_size)]
        model = self._float_model()
        self._act_scales = calibrate_act_scales(model, batches, self._quant_config)
        self._int8_chains = build_int8_chains(
            model, batches[0], self._act_scales, self._quant_config) or None
        self._rebuild()
        return len(self._act_scales)

    def reload(self, checkpoint: Optional[str] = None) -> str:
        """Swap in the weights of ``checkpoint`` (default: the build-time
        path), after checking that its keys and shapes are this model's;
        nothing changes when the check fails. Returns the path used.

        Under int8 the weights are quantized and BN folded anew, and any
        calibrated scales and chains are dropped (they were measured on the
        old weights: call ``calibrate`` again); if the rebuild fails, the
        predictor keeps serving the old weights.
        """
        path = checkpoint or self.checkpoint
        if not path:
            raise ValueError("no checkpoint to reload: the predictor was "
                             "built without one and none was given")
        sd = _load_state_dict(path)
        self._check_compatible(sd, path, self.state_dict())
        if self.quantize == "int8":
            saved = (self.checkpoint, self._float_state, self._int8w,
                     self._act_scales, self._int8_chains, self.model,
                     self._quant_config)
            try:
                self.checkpoint = path
                self._set_float_state(sd)
                self._act_scales = self._int8_chains = None
                self._rebuild()
            except Exception:
                (self.checkpoint, self._float_state, self._int8w,
                 self._act_scales, self._int8_chains, self.model,
                 self._quant_config) = saved
                raise
        else:
            self.model.load_state_dict(sd)
            self.checkpoint = path
        return path

    def _check_compatible(self, sd: Mapping[str, torch.Tensor], path: str,
                          want: Mapping[str, torch.Tensor]) -> None:
        """Reject a state_dict whose keys or tensor shapes differ from the
        serving model's (``want``)."""
        if ({k: tuple(v.shape) for k, v in want.items()}
                != {k: tuple(v.shape) for k, v in sd.items()}):
            raise ValueError(
                f"checkpoint {path!r} is incompatible with this predictor "
                f"({self.model_type}/{self.model_variant}/"
                f"{self.num_classes} classes): keys or tensor shapes differ")

    def preprocess(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """HWC float arrays in [0,1] (any sizes) → normalized model input."""
        return np.stack([eval_transform(np.asarray(im, np.float32),
                                        self.transform) for im in images])

    def predict(self, images: Sequence[np.ndarray],
                preprocessed: bool = False) -> Dict[str, np.ndarray]:
        """Classify a list of images of any length.

        Returns ``{"probabilities": (N, K), "label": (N,)}``. Requests are
        chunked and padded to ``batch_size``.
        """
        if len(images) == 0:
            return {"probabilities": np.zeros((0, self.num_classes),
                                              np.float32),
                    "label": np.zeros((0,), np.int64)}
        x = (np.asarray(images, np.float32) if preprocessed
             else self.preprocess(images))
        probs_out = []
        with torch.inference_mode():
            for start in range(0, x.shape[0], self.batch_size):
                chunk = x[start: start + self.batch_size]
                pad = self.batch_size - chunk.shape[0]
                if pad:
                    chunk = np.concatenate(
                        [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
                batch = torch.from_numpy(np.ascontiguousarray(chunk)).to(self._device)
                probs = torch.softmax(self.model(batch), dim=-1)
                probs_out.append(probs[: self.batch_size - pad].cpu().numpy())
        probs = np.concatenate(probs_out)
        return {"probabilities": probs, "label": probs.argmax(-1)}
