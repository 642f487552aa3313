"""Training loop (counterpart of ``neighbour_feature_pooling_tpu/train/
trainer.py``), on one device.

The reference's Lightning ``Trainer`` with its callbacks, as the JAX
package runs it:

* Adam + label-smoothed CE (``engine.py``);
* per-epoch train and val metrics (accuracy, macro F1 / precision /
  recall) from one confusion matrix kept on the device;
* EarlyStopping on ``val_loss`` with ``patience`` / ``min_delta``;
* ModelCheckpoint: ``best`` by val accuracy, and ``last`` after the
  early-stop and plateau counters are updated, so ``fit(resume=True)``
  continues the run where it stopped (its counters ride ``last``'s
  metadata, the best accuracy ``best.meta.json``);
* the NFP freeze schedule until ``unfreeze_epoch``;
* ReduceLROnPlateau on ``val_loss`` (``scheduler="plateau"``);
* the test-time confusion-matrix PNG, where matplotlib imports.

Logs go to ``{log_dir}/experiment.log`` and ``{log_dir}/metrics.jsonl`` (one
JSON line per epoch, with ``data_wait_s``, the seconds the loop waited for
the host pipeline). The loss and confusion matrix stay on the device
through an epoch and are read once at its end.

Not ported yet (ROADMAP.md Queue 1 item 2, training remainder):
TensorBoard events, profiler traces (``profile_steps``), SIGTERM
preemption handling and asynchronous checkpoint writes; their
``TrainerConfig`` fields are accepted and do nothing, except
``profile_steps > 0``, which raises. The mesh, ZeRO and pipeline arguments
raise (item 8). ``steps_per_dispatch > 1`` runs its K steps one by one, which the
JAX package's scanned K steps equal.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..data.prefetch import prefetch, to_device
from .checkpoint import checkpoint_exists, restore_checkpoint, save_checkpoint
from .engine import TrainState, create_train_state, eval_step, train_step
from .metrics import init_confusion, metrics_from_confusion

__all__ = ["TrainerConfig", "Trainer"]

_TRAIN_REST = "not ported yet: ROADMAP.md Queue 1 item 2 (training remainder)"
_PARALLEL = "not ported yet: ROADMAP.md Queue 1 item 8 (parallel and auxiliary code)"


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    max_epochs: int = 200
    patience: int = 10
    min_delta: float = 1e-4
    label_smoothing: float = 0.05
    freeze_nfp: bool = True
    unfreeze_epoch: int = 5
    scheduler: str = "none"     # none | cosine | plateau
    scheduler_patience: int = 10   # torch ReduceLROnPlateau default
    scheduler_factor: float = 0.1
    log_dir: str = "logs/run"
    ckpt_dir: str = "checkpoints/run"
    log_every_n_steps: int = 1  # TensorBoard's; accepted, not ported
    tensorboard: bool = True    # accepted, not ported
    profile_steps: int = 0      # > 0 raises: not ported
    #: train steps per host dispatch in the JAX package (a scan); here the
    #: steps run one by one, which gives the same result
    steps_per_dispatch: int = 1
    #: one optimizer update per ``grad_accum`` train steps, with the mean
    #: gradient (optax MultiSteps)
    grad_accum: int = 1
    seed: int = 42
    handle_preemption: bool = True  # accepted, not ported
    preempt_mode: str = "epoch"     # accepted, not ported
    async_ckpt: bool = True         # accepted, not ported: saves block


def _resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Trainer(device={device!r}) needs a CUDA device and none is "
                           "available; pass device='cpu' to train on the CPU")
    return dev


def _finite_or_none(v: float) -> Optional[float]:
    return None if v == float("inf") else v


class Trainer:
    """Fit / validate / test loop for a ``TextureModel`` on one device
    (``"cuda"`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, model, num_classes: int, config: TrainerConfig,
                 device: str = "cuda", pretrained_backbone=None, init_variables=None,
                 mesh=None, zero: str = "none", pp_microbatches: int = 0):
        if mesh is not None or zero != "none" or pp_microbatches:
            raise NotImplementedError(f"mesh, ZeRO and pipeline training are {_PARALLEL}")
        if config.profile_steps > 0:
            raise NotImplementedError(f"profile_steps is {_TRAIN_REST}")
        self.device = _resolve_device(device)
        self.model = model.to(device=self.device, memory_format=torch.channels_last)
        self.num_classes = num_classes
        self.config = config
        self.pretrained_backbone = pretrained_backbone
        self.init_variables = init_variables
        os.makedirs(config.log_dir, exist_ok=True)
        self.logger = self._setup_logging(config.log_dir)
        self._metrics_path = os.path.join(config.log_dir, "metrics.jsonl")
        self.state: Optional[TrainState] = None
        self.best = {"val_acc": -1.0, "epoch": -1}

    @staticmethod
    def _setup_logging(log_dir: str) -> logging.Logger:
        # keyed by the absolute path: python caches loggers process-wide
        logger = logging.getLogger(f"nfp_torch.{os.path.abspath(log_dir)}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        if not logger.handlers:
            fh = logging.FileHandler(os.path.join(log_dir, "experiment.log"))
            fh.setFormatter(logging.Formatter(
                "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
            logger.addHandler(fh)
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter("%(message)s"))
            logger.addHandler(sh)
        return logger

    def close(self) -> None:
        """Release the log file handles (one Trainer per seed in the CLI)."""
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)

    def _log_metrics(self, record: Dict[str, Any]) -> None:
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _put(self, batch):
        return to_device(batch, self.device)

    def init_state(self, total_steps: int = 0) -> TrainState:
        """Seeded weights (or the given ``init_variables`` /
        ``pretrained_backbone``) and a fresh Adam; cosine decays over
        ``total_steps`` train steps, that is ``total_steps / grad_accum``
        updates."""
        ga = max(1, int(self.config.grad_accum))
        self.state = create_train_state(
            self.model, self.config.seed, self.config.learning_rate,
            scheduler=self.config.scheduler, total_steps=-(-total_steps // ga),
            pretrained_backbone=self.pretrained_backbone, grad_accum=ga,
            init_variables=self.init_variables)
        return self.state

    # ------------------------------------------------------------------ fit

    def fit(self, datamodule, resume: bool = False) -> Dict[str, Any]:
        """Train; ``resume=True`` restores the ``last`` checkpoint first (a
        no-op when there is none)."""
        cfg = self.config
        datamodule.prepare_data()
        datamodule.setup("fit")
        if self.state is None:
            total_steps = 0
            if cfg.scheduler == "cosine":
                bs = datamodule.batch_size["train"]
                total_steps = -(-datamodule.split_size("train") // bs) * cfg.max_epochs
            self.init_state(total_steps=total_steps)

        # early-stopping and plateau counters, persisted in `last`'s metadata
        best_val_loss = float("inf")
        patience_left = cfg.patience
        sched_best = float("inf")
        sched_wait = 0
        start_epoch = 0
        last = os.path.join(cfg.ckpt_dir, "last")
        if resume and checkpoint_exists(last):
            _, meta = restore_checkpoint(last, self.state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            es = meta.get("early_stop")
            if es:
                best_val_loss = (float("inf") if es["best_val_loss"] is None
                                 else float(es["best_val_loss"]))
                patience_left = int(es["patience_left"])
            sc = meta.get("sched")
            if sc:
                sched_best = float("inf") if sc["best"] is None else float(sc["best"])
                sched_wait = int(sc["wait"])
            # best-tracking from the best checkpoint's metadata, not last's,
            # so a worse model never overwrites `best`
            best_meta_path = os.path.join(cfg.ckpt_dir, "best.meta.json")
            if os.path.exists(best_meta_path):
                with open(best_meta_path) as f:
                    best_meta = json.load(f)
                self.best = {"val_acc": best_meta.get("accuracy", -1.0),
                             "epoch": best_meta.get("epoch", -1)}
            self.logger.info(f"resumed from last checkpoint at epoch {start_epoch}")

        history = []
        for epoch in range(start_epoch, cfg.max_epochs):
            frozen = bool(cfg.freeze_nfp and epoch < cfg.unfreeze_epoch)
            t0 = time.perf_counter()
            cm = init_confusion(self.num_classes, self.device)
            loss_sum = torch.zeros((), device=self.device)
            nb = 0
            # seconds blocked on the host pipeline: the loop does not wait
            # for the card, so this is the input-bound share of the epoch
            data_wait = 0.0
            batches = prefetch(map(self._put, datamodule.train_batches(epoch)))
            while True:
                tw = time.perf_counter()
                batch = next(batches, None)
                data_wait += time.perf_counter() - tw
                if batch is None:
                    break
                loss, cm_up = train_step(self.state, batch, self.num_classes, frozen=frozen,
                                         label_smoothing=cfg.label_smoothing)
                cm += cm_up
                loss_sum += loss
                nb += 1
            train_metrics = metrics_from_confusion(cm)
            train_metrics["loss"] = float(loss_sum) / max(nb, 1)
            train_metrics["time_s"] = time.perf_counter() - t0
            train_metrics["data_wait_s"] = round(data_wait, 3)
            if data_wait > 0.5 * train_metrics["time_s"] and epoch > start_epoch:
                self.logger.info(
                    f"input-bound: {data_wait:.1f}s of {train_metrics['time_s']:.1f}s "
                    f"waiting on the host pipeline; consider --num_workers")

            val_metrics = self.evaluate(datamodule.val_batches())
            record = {"epoch": epoch, "frozen": frozen, "train": train_metrics,
                      "val": val_metrics}
            history.append(record)
            self._log_metrics(record)
            self.logger.info(
                f"epoch {epoch:3d} | train loss {train_metrics['loss']:.4f} "
                f"acc {train_metrics['accuracy']:.4f} | val loss "
                f"{val_metrics['loss']:.4f} acc {val_metrics['accuracy']:.4f}"
                f" | {train_metrics['time_s']:.1f}s")

            # ModelCheckpoint: best on val accuracy (max)
            if val_metrics["accuracy"] > self.best["val_acc"]:
                self.best = {"val_acc": val_metrics["accuracy"], "epoch": epoch}
                save_checkpoint(os.path.join(cfg.ckpt_dir, "best"), self.state,
                                {"epoch": epoch, **val_metrics})

            # ReduceLROnPlateau on val_loss
            if cfg.scheduler == "plateau":
                if val_metrics["loss"] < sched_best - 1e-8:
                    sched_best = val_metrics["loss"]
                    sched_wait = 0
                else:
                    sched_wait += 1
                    if sched_wait > cfg.scheduler_patience:
                        # the JAX package holds the rate as an fp32 array
                        new_lr = float(np.float32(self.state.learning_rate
                                                  * cfg.scheduler_factor))
                        self.state.learning_rate = new_lr
                        sched_wait = 0
                        self.logger.info(f"plateau: lr -> {new_lr:.2e}")

            # EarlyStopping on val_loss
            stop = False
            if val_metrics["loss"] < best_val_loss - cfg.min_delta:
                best_val_loss = val_metrics["loss"]
                patience_left = cfg.patience
            else:
                patience_left -= 1
                stop = patience_left <= 0

            # `last` after the counter updates, so its metadata carries them
            save_checkpoint(last, self.state, {
                "epoch": epoch, **val_metrics,
                "early_stop": {"best_val_loss": _finite_or_none(best_val_loss),
                               "patience_left": patience_left},
                "sched": {"best": _finite_or_none(sched_best), "wait": sched_wait}})
            if stop:
                self.logger.info(f"early stopping at epoch {epoch} "
                                 f"(val_loss plateau, patience {cfg.patience})")
                break
        return {"history": history, "best": self.best, "preempted": False}

    # ----------------------------------------------------------------- eval

    def evaluate(self, batches: Iterator) -> Dict[str, Any]:
        cm = init_confusion(self.num_classes, self.device)
        loss_sum = torch.zeros((), device=self.device)
        w_sum = torch.zeros((), device=self.device)
        for batch in prefetch(map(self._put, batches)):
            ls, ws, cm_up, _ = eval_step(self.state, batch, self.num_classes,
                                         self.config.label_smoothing)
            cm += cm_up
            loss_sum += ls
            w_sum += ws
        m = metrics_from_confusion(cm)
        m["loss"] = float(loss_sum) / max(float(w_sum), 1.0)
        m["confusion"] = cm.cpu().numpy().tolist()
        return m

    def test(self, datamodule, restore: Optional[str] = "best",
             label_names=None) -> Dict[str, Any]:
        """Test with the ``best`` (or ``last``, or with ``None`` the
        current) weights; saves the confusion-matrix heatmap."""
        datamodule.setup("test")
        if self.state is None:
            self.init_state()
        if restore in ("best", "last"):
            path = os.path.join(self.config.ckpt_dir, restore)
            if checkpoint_exists(path):
                _, meta = restore_checkpoint(path, self.state)
                self.logger.info(f"restored {restore} checkpoint: {meta}")
        metrics = self.evaluate(datamodule.test_batches())
        cm = np.asarray(metrics.pop("confusion"))
        self._save_confusion_png(cm, label_names)
        self._log_metrics({"test": dict(metrics)})
        self.logger.info(f"test | loss {metrics['loss']:.4f} acc "
                         f"{metrics['accuracy']:.4f} f1 {metrics['f1']:.4f}")
        return metrics

    def _save_confusion_png(self, cm: np.ndarray, label_names=None) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        out_dir = os.path.join(self.config.log_dir, "confusion_matrices")
        os.makedirs(out_dir, exist_ok=True)
        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(cm, cmap="Blues")
        if cm.shape[0] <= 30:
            for i in range(cm.shape[0]):
                for j in range(cm.shape[1]):
                    ax.text(j, i, int(cm[i, j]), ha="center", va="center", fontsize=7)
        if label_names is not None:
            ax.set_xticks(range(len(label_names)))
            ax.set_xticklabels(label_names, rotation=45, ha="right")
            ax.set_yticks(range(len(label_names)))
            ax.set_yticklabels(label_names)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title("Confusion Matrix")
        fig.colorbar(im)
        fig.tight_layout()
        # a second test() in the same log dir numbers its PNG
        path = os.path.join(out_dir, "confusion_matrix.png")
        n = 1
        while os.path.exists(path):
            path = os.path.join(out_dir, f"confusion_matrix_{n}.png")
            n += 1
        fig.savefig(path)
        plt.close(fig)
