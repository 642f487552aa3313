"""Serving: a batched predictor (counterpart of ``neighbour_feature_pooling_tpu/
serve.py``).

``Predictor`` wraps a ``TextureModel``: host-side preprocessing through the
eval transform, requests chunked and padded to a fixed batch size, a forward
on the device under ``torch.inference_mode()``, softmax probabilities and
argmax labels out. It runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises. It serves
whatever ``models.get_model`` builds: ResNet18 × {``gap_only``,
``texture_nfp``} and MobileNetV3-Large × {``gap_only``, ``texture_nfp``,
``texture_nfp_intermediate``, ``mid_nfp``, ``multi_stage_nfp``,
``nfp_insert``}, whose options reach the model through ``model_kwargs``.

Not ported yet: reference-checkpoint import, data-parallel serving, export
and the HTTP server (ROADMAP.md Queue 1 item 5), and int8 (item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .data.transforms import TransformConfig, eval_transform
from .models import get_model, init_params

__all__ = ["Predictor"]


def _resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Predictor(device={device!r}) needs a CUDA device and "
                           "none is available; pass device='cpu' to run on the CPU")
    return dev


def _load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


@dataclasses.dataclass
class Predictor:
    """Inference endpoint for a texture-pooling classifier."""

    model_type: str
    model_variant: str
    num_classes: int
    checkpoint: Optional[str] = None      # a torch.save'd state_dict; None:
    #                                       weights from torch.Generator seed 0
    batch_size: int = 32
    input_size: int = 224
    resize_size: int = 256
    num_input_channels: int = 3
    transform: Optional[TransformConfig] = None
    model_kwargs: Optional[Dict] = None
    device: str = "cuda"

    def __post_init__(self):
        self._device = _resolve_device(self.device)
        self.model = get_model(self.model_type, self.model_variant,
                               self.num_classes,
                               num_input_channels=self.num_input_channels,
                               **(self.model_kwargs or {}))
        self.transform = self.transform or TransformConfig(
            resize_size=self.resize_size, input_size=self.input_size)
        if self.checkpoint:
            sd = _load_state_dict(self.checkpoint)
            self._check_compatible(sd, self.checkpoint)
            self.model.load_state_dict(sd)
        else:
            init_params(self.model, torch.Generator().manual_seed(0))
        self.model.to(device=self._device, memory_format=torch.channels_last)
        self.model.eval()

    def reload(self, checkpoint: Optional[str] = None) -> str:
        """Swap in the weights of ``checkpoint`` (default: the build-time
        path), after checking that its keys and shapes are this model's;
        nothing changes when the check fails. Returns the path used."""
        path = checkpoint or self.checkpoint
        if not path:
            raise ValueError("no checkpoint to reload: the predictor was "
                             "built without one and none was given")
        sd = _load_state_dict(path)
        self._check_compatible(sd, path)
        self.model.load_state_dict(sd)
        self.checkpoint = path
        return path

    def _check_compatible(self, sd: Mapping[str, torch.Tensor], path: str) -> None:
        """Reject a state_dict whose keys or tensor shapes differ from the
        serving model's."""
        want = {k: tuple(v.shape) for k, v in self.model.state_dict().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want != got:
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
