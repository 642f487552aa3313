"""Train and eval steps (counterpart of ``neighbour_feature_pooling_tpu/
train/engine.py``).

The reference's ``Lightning_Wrapper`` recipe, as the JAX package runs it:

* loss: cross-entropy with label smoothing 0.05, masked by the batch's
  ``weight`` channel (padding examples weigh 0);
* optimizer: Adam, b1 0.9, b2 0.999, eps 1e-8 (optax ``adam`` and torch
  ``Adam`` compute the same update); scheduler ``none``, ``cosine`` (optax
  ``cosine_decay_schedule(lr, total_steps)`` at the update count before the
  step) or ``plateau`` (the trainer sets the learning rate);
* ``grad_accum = k``: optax ``MultiSteps``, the mean gradient of k train
  steps, one update every k steps, BatchNorm statistics updated on every
  step;
* dropout: the masks of train step ``step`` come from a CPU
  ``torch.Generator`` seeded from (``seed + 1``, ``step``), as the JAX
  step draws from ``fold_in(PRNGKey(seed + 1), state.step)``: a resumed
  run draws the masks it would have drawn, and the card the CPU's;
* freeze schedule: while ``frozen``, the gradients of parameters whose name
  has a component containing ``nfp_head`` or ``se_gate`` are zero tensors.
  Adam still counts the step and decays those moments, as optax does (a
  ``None`` gradient would make torch's Adam skip the parameter, and its
  bias correction would differ after the unfreeze).

There is no jit and no pytree: a ``TrainState`` holds the model (its
parameters and BatchNorm buffers), the optimizer and the step counters,
and the steps update it in place. Batches are dicts ``{"image": NHWC,
"label": (B,), "weight": (B,)}`` of tensors on the model's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models import init_params
from ..models.from_jax import flax_module_path
from .metrics import confusion_matrix_update, init_confusion

__all__ = ["TrainState", "create_train_state", "train_step", "eval_step",
           "cross_entropy_loss", "freeze_mask", "cosine_decay_schedule",
           "FREEZE_SUBSTRINGS"]

FREEZE_SUBSTRINGS = ("nfp_head", "se_gate")


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule(init_value, decay_steps)`` (alpha 0,
    exponent 1): the learning rate of update ``count``."""
    if decay_steps <= 0:
        raise ValueError("cosine_decay_schedule needs decay_steps > 0")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return schedule


@dataclasses.dataclass
class TrainState:
    """The model, its Adam optimizer and the counters of a training run.

    ``step`` counts train steps (the JAX ``state.step``), ``updates`` the
    optimizer updates (one per ``grad_accum`` steps); ``schedule`` maps an
    update count to its learning rate (``cosine``), else None;
    ``dropout_seed`` and ``step`` seed the dropout masks
    (``dropout_generator``)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    updates: int = 0
    grad_accum: int = 1
    schedule: Optional[Callable[[int], float]] = None
    dropout_seed: int = 0
    generator: Optional[torch.Generator] = None

    def dropout_generator(self) -> torch.Generator:
        """The generator of this step's dropout masks, seeded from
        (``dropout_seed``, ``step``): the JAX ``fold_in(dropout_rng,
        state.step)``. It lives on the model's device, so the masks are
        drawn where they are used (a card's masks are not the CPU's)."""
        device = next(self.model.parameters()).device
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device)
        return self.generator.manual_seed((self.dropout_seed << 32) + self.step)

    @property
    def params(self) -> List[Tuple[str, nn.Parameter]]:
        return list(self.model.named_parameters())

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @learning_rate.setter
    def learning_rate(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def apply_gradients(self, grads: Mapping[str, Optional[torch.Tensor]]) -> None:
        """One train step's gradients (by parameter name; a missing or None
        gradient is a zero tensor): stored in ``.grad``, averaged over
        ``grad_accum`` steps, and an Adam update at the end of each window."""
        mini = self.step % self.grad_accum
        for name, p in self.params:
            g = grads.get(name)
            g = torch.zeros_like(p) if g is None else g
            if mini == 0 or p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)
        self.step += 1
        if mini + 1 < self.grad_accum:
            return
        if self.grad_accum > 1:
            for _, p in self.params:
                p.grad.div_(self.grad_accum)
        if self.schedule is not None:
            self.learning_rate = self.schedule(self.updates)
        self.optimizer.step()
        self.updates += 1


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor,
                       label_smoothing: float = 0.05) -> torch.Tensor:
    """Label-smoothed cross-entropy, the mean over the examples of weight 1
    (``nn.CrossEntropyLoss(label_smoothing=0.05)`` on the unpadded rows)."""
    per_ex = _per_example_loss(logits, labels, label_smoothing)
    w = weights.to(per_ex.dtype)
    return torch.sum(per_ex * w) / torch.clamp(torch.sum(w), min=1.0)


def _per_example_loss(logits, labels, label_smoothing):
    k = logits.shape[-1]
    onehot = F.one_hot(labels.long(), k).to(logits.dtype)
    smoothed = onehot * (1.0 - label_smoothing) + label_smoothing / k
    return -torch.sum(smoothed * F.log_softmax(logits, dim=-1), dim=-1)


def freeze_mask(model: nn.Module, substrings: Tuple[str, ...] = FREEZE_SUBSTRINGS
                ) -> Dict[str, float]:
    """0/1 per parameter name: 0 where a component of the parameter's JAX
    path contains a freeze key, as the JAX mask keys the flax path. The
    path is ``models.from_jax``'s name map read backwards, with the flax
    leaf name (``kernel``, ``scale``, ``bias``), so both masks select the
    same tensors."""
    mask = {}
    for name, _ in model.named_parameters():
        module, leaf = name.rsplit(".", 1)
        if leaf == "weight":
            is_norm = isinstance(model.get_submodule(module),
                                 (nn.modules.batchnorm._BatchNorm, nn.LayerNorm))
            leaf = "scale" if is_norm else "kernel"
        path = flax_module_path(module) + (leaf,)
        mask[name] = 0.0 if any(s in part for part in path for s in substrings) else 1.0
    return mask


def create_train_state(model: nn.Module, seed: int, learning_rate: float,
                       scheduler: str = "none", total_steps: int = 0,
                       pretrained_backbone: Optional[Mapping[str, torch.Tensor]] = None,
                       grad_accum: int = 1,
                       init_variables: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> TrainState:
    """Initialize the model from ``seed`` and build its Adam optimizer.

    The weights are ``models.init_params``' seeded draws (the JAX package's
    scales; the draws differ from JAX's). ``init_variables``, a whole
    ``state_dict``, replaces them (keys and shapes checked);
    ``pretrained_backbone``, a ``state_dict`` of the backbone (keys without
    the ``backbone.`` prefix), replaces the backbone's only. The two
    exclude each other. ``scheduler`` is ``none``, ``cosine`` (over
    ``total_steps`` optimizer updates) or ``plateau``; ``grad_accum > 1``
    updates once per ``grad_accum`` steps with the mean gradient.
    """
    if init_variables is not None and pretrained_backbone is not None:
        raise ValueError("pass either pretrained_backbone or init_variables, not both")
    init_params(model, torch.Generator().manual_seed(seed))
    if init_variables is not None:
        _load_checked(model, init_variables, "init_variables")
    if pretrained_backbone is not None:
        _load_checked(model.backbone, pretrained_backbone, "pretrained backbone")
    schedule = None
    if scheduler == "cosine":
        if total_steps <= 0:
            raise ValueError("cosine scheduler needs total_steps > 0")
        schedule = cosine_decay_schedule(learning_rate, total_steps)
    elif scheduler not in ("none", "plateau"):
        raise ValueError(f"unknown scheduler {scheduler!r}")
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    return TrainState(model=model, optimizer=optimizer, grad_accum=max(1, int(grad_accum)),
                      schedule=schedule, dropout_seed=seed + 1)


def _load_checked(module: nn.Module, sd: Mapping[str, torch.Tensor], what: str) -> None:
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    if want != got:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])[:5]
        raise ValueError(f"{what} does not match the model: missing={missing} "
                         f"extra={extra} shape mismatch={shapes}")
    module.load_state_dict(sd)


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor], num_classes: int,
               frozen: bool = False, label_smoothing: float = 0.05,
               freeze_substrings: Tuple[str, ...] = FREEZE_SUBSTRINGS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One train step (JAX ``train_step_body``): forward in train mode (the
    BatchNorm statistics update, dropout from ``state.dropout_generator``),
    the loss, its gradients (zeroed for the
    frozen parameters while ``frozen``), then ``apply_gradients``. Returns
    the loss and this batch's confusion matrix, both on the device; the
    step's gradients stay in each parameter's ``.grad``."""
    model = state.model
    model.train()
    logits = model(batch["image"], generator=state.dropout_generator())
    loss = cross_entropy_loss(logits, batch["label"], batch["weight"], label_smoothing)
    names, params = zip(*state.params)
    grads = dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))
    if frozen:
        for name, keep in freeze_mask(model, freeze_substrings).items():
            if not keep:
                grads[name] = None
    state.apply_gradients(grads)
    cm = confusion_matrix_update(init_confusion(num_classes, logits.device), logits.detach(),
                                 batch["label"], batch["weight"])
    return loss.detach(), cm


@torch.no_grad()
def eval_step(state: TrainState, batch: Mapping[str, torch.Tensor], num_classes: int,
              label_smoothing: float = 0.05):
    """One eval batch (JAX ``eval_step_body``): ``(loss_sum, weight_sum,
    confusion, logits)``, the loss summed over the examples of weight 1."""
    model = state.model
    model.eval()
    logits = model(batch["image"])
    w = batch["weight"].float()
    per_ex = _per_example_loss(logits, batch["label"], label_smoothing)
    cm = confusion_matrix_update(init_confusion(num_classes, logits.device), logits,
                                 batch["label"], batch["weight"])
    return torch.sum(per_ex * w), torch.sum(w), cm, logits
