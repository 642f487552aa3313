"""Experiment CLI (counterpart of ``neighbour_feature_pooling_tpu/cli.py``),
with the same flags plus ``--device``.

    python -m neighbour_feature_pooling_tpu_torch.cli --dataset synthetic \\
        --model_type resnet18 --model_variant texture_nfp --max_epochs 1 \\
        --seeds 7 [--device cpu]

Per seed: data → model → fit → test with the best checkpoint, logging to
``logs/<dataset>/<model_type>-<model_variant>-seed<s>/`` and checkpointing
to ``checkpoints/<dataset>/<name>_seed<s>/{best,last}``; then the mean and
standard deviation of the seeds' test accuracies. Runs on one device,
``--device cuda`` (the default) or ``cpu``.

Flags of parts not ported yet exit with a message naming their
``ROADMAP.md`` item: ``--seed_parallel``, ``--num_devices`` above 1,
``--model_parallel``, ``--pipeline``, ``--zero``, ``--export_dir``,
``--import_ckpt``, ``--pretrained``, ``--device_augment``, ``--device_data``,
``--device_eval``, ``--bf16``, ``--remat``, ``--profile_steps`` and a model
type other than ResNet18 or MobileNetV3.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np

from .data import DATASET_NUM_CLASSES, get_datamodule
from .models import MODEL_VARIANTS, canonical_model_type, get_model
from .ops.measures import MEASURE_NAMES
from .train import Trainer, TrainerConfig
from .train.checkpoint import checkpoint_exists

__all__ = ["build_parser", "run_experiment", "main"]

_SUMMARY_PRINTED = False

#: (resize_size, input_size) when the user does not pass the flags
DATASET_DEFAULT_SIZES = {
    "cifar10": (36, 32),
    "FashionMNIST": (36, 32),
    "EuroSAT": (64, 64),
    "MSTAR": (128, 128),
    "synthetic": (64, 64),
}
_FALLBACK_SIZES = (256, 224)

_PARALLEL = "ROADMAP.md Queue 1 item 8 (parallel and auxiliary code)"
_SERVING = "ROADMAP.md Queue 1 item 5 (serving extras)"
_DEVICE_DATA = "ROADMAP.md Queue 1 item 7 (device-side data)"
_TRAIN_REST = "ROADMAP.md Queue 1 item 2 (training remainder)"
_BACKBONES = "ROADMAP.md Queue 1 item 3 (the ResNet50 and ViT-Tiny backbones)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train models with GAP/NFP variants on various datasets "
                    "(PyTorch/CUDA port)")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--max_epochs", type=int, default=200)
    p.add_argument("--similarity", type=str, default="cosine",
                   choices=MEASURE_NAMES + ["mahalanobis"])
    p.add_argument("--dataset", type=str, default="UCMerced",
                   help="UCMerced|RESISC45|MSTAR|cifar10|GTOS-Mobile|"
                        "PlantVillage|EuroSAT|FashionMNIST|"
                        "sugarcane_damage_usa|synthetic (case/sep insensitive)")
    p.add_argument("--model_type", type=str, default="resnet18",
                   choices=["resnet18", "resnet50", "vittiny", "mobilenetv3",
                            "vit_tiny_patch16_224", "mobilenetv3_large_100"])
    all_variants = sorted({v for vs in MODEL_VARIANTS.values() for v in vs})
    p.add_argument("--model_variant", type=str, default="gap_only", choices=all_variants)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--resize_size", type=int, default=None)
    p.add_argument("--input_size", type=int, default=None)
    p.add_argument("--reference_sizes", action="store_true",
                   help="the reference's 256/224 resize/input sizes for every "
                        "dataset; explicit --resize_size/--input_size still win")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--min_delta", type=float, default=0.0001)
    p.add_argument("--nfp_radius", type=int, default=1)
    p.add_argument("--nfp_padding", type=int, default=0)
    p.add_argument("--nfp_stride", type=int, default=1)
    p.add_argument("--nfp_layer_idx", type=int, default=3)
    p.add_argument("--nfp_insert_idx", type=int, default=1)
    p.add_argument("--nfp_intermediate_layer_idx", type=int, default=1)
    p.add_argument("--nfp_mid_layer_idx", type=int, default=1)
    p.add_argument("--scheduler", type=str, default="none",
                   choices=["none", "cosine", "plateau"])
    p.add_argument("--label_smoothing", type=float, default=0.05)
    p.add_argument("--num_samples", type=int, default=256,
                   help="synthetic dataset size (--dataset synthetic only)")
    p.add_argument("--pretrained", type=str, default=None,
                   help="timm backbone weights; not ported yet")
    p.add_argument("--import_ckpt", type=str, default=None,
                   help="warm start from a reference checkpoint; not ported yet")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute; not ported yet")
    p.add_argument("--remat", action="store_true",
                   help="recompute backbone blocks in the backward; not ported yet")
    p.add_argument("--stem_s2d", action=argparse.BooleanOptionalAction, default=True,
                   help="the JAX package's space-to-depth stem layout; the port "
                        "computes the same 7x7/2 conv directly either way")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="profiler trace of the first N train steps; not ported yet")
    p.add_argument("--device_augment", action="store_true",
                   help="augment train batches on the device; not ported yet")
    p.add_argument("--device_data", action="store_true",
                   help="keep the train split resident on the device; not ported yet")
    p.add_argument("--device_eval", action="store_true",
                   help="eval batches from the resident split; not ported yet")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps per dispatch in the JAX package; here the "
                        "steps run one by one (the same result)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="accumulate this many micro-batch gradients per optimizer "
                        "update (the mean gradient)")
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 123, 999])
    p.add_argument("--seed_parallel", action="store_true",
                   help="all seeds as one program; not ported yet")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel devices; the port runs on one")
    p.add_argument("--model_parallel", type=int, default=1, help="not ported yet")
    p.add_argument("--zero", choices=["none", "zero1", "fsdp"], default="none",
                   help="not ported yet")
    p.add_argument("--pipeline", type=int, default=1, help="not ported yet")
    p.add_argument("--pp_microbatches", type=int, default=8,
                   help="microbatches under --pipeline (not ported yet)")
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--async_ckpt", action=argparse.BooleanOptionalAction, default=True,
                   help="accepted; the port's checkpoint saves block")
    p.add_argument("--resume", action="store_true",
                   help="restore each seed's `last` checkpoint before training "
                        "(no-op when there is none)")
    p.add_argument("--eval_only", action="store_true",
                   help="skip training: restore a checkpoint per seed (--eval_restore) "
                        "and run the test protocol")
    p.add_argument("--eval_restore", choices=["best", "last", "none"], default="best",
                   help="which checkpoint --eval_only restores; `none` scores the "
                        "seeded initial weights")
    p.add_argument("--export_dir", default=None, help="serving artifact; not ported yet")
    p.add_argument("--export_quantize", choices=["none", "int8", "int8_mixed"],
                   default="none", help="export tier (with --export_dir)")
    p.add_argument("--export_batch_size", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def _normalize_dataset(name: str) -> str:
    key = name.strip().replace("-", "").replace("_", "").lower()
    mapping = {
        "ucmerced": "UCMerced", "resisc45": "RESISC45", "mstar": "MSTAR",
        "cifar10": "cifar10", "gtosmobile": "GTOS-Mobile",
        "plantvillage": "PlantVillage", "eurosat": "EuroSAT",
        "fashionmnist": "FashionMNIST", "synthetic": "synthetic",
        "sugarcanedamageusa": "sugarcane_damage_usa",
    }
    return mapping.get(key, name)


def _model_kwargs(config: Dict) -> Dict:
    """The ``get_model`` keyword arguments of a CLI config, shared by the
    trainer and the ``Predictor`` that serves its checkpoints."""
    return dict(
        measure=config.get("similarity", "cosine"),
        nfp_radius=config.get("nfp_radius", 1),
        nfp_padding=config.get("nfp_padding", 0),
        nfp_insert_idx=config.get("nfp_insert_idx", 1),
        nfp_intermediate_layer_idx=config.get("nfp_intermediate_layer_idx", 1),
        nfp_mid_layer_idx=config.get("nfp_mid_layer_idx", 1),
        stem_s2d=config.get("stem_s2d", True),
    )


def _check_ported(args) -> None:
    """Exit, naming the ROADMAP item, on a flag of a part not ported yet."""
    unported = [
        ("--seed_parallel", args.seed_parallel, _PARALLEL),
        ("--num_devices > 1", (args.num_devices or 1) > 1, _PARALLEL),
        ("--model_parallel", args.model_parallel > 1, _PARALLEL),
        ("--pipeline", args.pipeline > 1, _PARALLEL),
        ("--zero", args.zero != "none", _PARALLEL),
        ("--export_dir", args.export_dir, _SERVING),
        ("--import_ckpt", args.import_ckpt, _SERVING),
        ("--pretrained", args.pretrained, _SERVING),
        ("--device_augment", args.device_augment, _DEVICE_DATA),
        ("--device_data", args.device_data, _DEVICE_DATA),
        ("--device_eval", args.device_eval, _DEVICE_DATA),
        ("--bf16", args.bf16, _TRAIN_REST),
        ("--remat", args.remat, _TRAIN_REST),
        ("--profile_steps", args.profile_steps > 0, _TRAIN_REST),
        (f"--model_type {args.model_type}", args.model_type not in ("resnet18", "mobilenetv3"),
         _BACKBONES),
    ]
    for flag, used, item in unported:
        if used:
            raise SystemExit(f"{flag} is not ported yet: {item}")


def run_experiment(seed: int, config: Dict) -> float:
    """One seed: data → model → fit → best-checkpoint test; returns the test
    accuracy."""
    dataset = config["dataset"]
    # the run seed drives shuffling and augmentation; the split stays fixed
    config = dict(config, seed=seed)
    data_module = get_datamodule(dataset, config)
    num_input_channels = 13 if dataset.lower() == "eurosat" else 3
    data_module.num_input_channels = num_input_channels

    exp_dir = os.path.join("logs", dataset,
                           f"{config['model_type']}-{config['model_variant']}-seed{seed}")
    ckpt_dir = os.path.join("checkpoints", dataset, f"{config['name']}_seed{seed}")

    data_module.prepare_data()
    data_module.setup("test" if config.get("eval_only") else "fit")
    if not config.get("eval_only"):
        data_module.print_first_batch_shape()
    num_classes = getattr(data_module, "num_classes", None) or config["num_classes"]

    model = get_model(config["model_type"], config["model_variant"], num_classes,
                      num_input_channels=num_input_channels, **_model_kwargs(config))

    global _SUMMARY_PRINTED
    if not _SUMMARY_PRINTED and not config.get("eval_only"):
        from .utils import summarize

        print(summarize(model))
        _SUMMARY_PRINTED = True

    trainer = Trainer(model, num_classes, TrainerConfig(
        learning_rate=config["learning_rate"],
        max_epochs=config["max_epochs"],
        patience=config["patience"],
        min_delta=config["min_delta"],
        label_smoothing=config.get("label_smoothing", 0.05),
        scheduler=config.get("scheduler", "none"),
        steps_per_dispatch=config.get("steps_per_dispatch", 1),
        grad_accum=config.get("grad_accum", 1),
        async_ckpt=bool(config.get("async_ckpt", True)),
        freeze_nfp=True, unfreeze_epoch=5,
        log_dir=exp_dir, ckpt_dir=ckpt_dir, seed=seed,
    ), device=config.get("device", "cuda"))
    label_names = getattr(data_module, "class_names", None) or None
    try:
        if config.get("eval_only"):
            restore = config.get("eval_restore", "best")
            if restore != "none" and not checkpoint_exists(os.path.join(ckpt_dir, restore)):
                raise SystemExit(f"--eval_only: no `{restore}` checkpoint under {ckpt_dir} "
                                 f"(train first)")
            if restore == "none":
                print("--eval_only --eval_restore none: scoring the seeded initial weights")
            metrics = trainer.test(data_module, restore=None if restore == "none" else restore,
                                   label_names=label_names)
            return metrics["accuracy"]
        trainer.fit(data_module, resume=bool(config.get("resume")))
        metrics = trainer.test(data_module, restore="best", label_names=label_names)
    finally:
        trainer.close()
        data_module.close()
    return metrics["accuracy"]


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.dataset = _normalize_dataset(args.dataset)
    args.model_type = canonical_model_type(args.model_type)
    args.model_variant = args.model_variant.lower()
    _check_ported(args)

    num_classes = DATASET_NUM_CLASSES.get(args.dataset, 10)
    default_sizes = (_FALLBACK_SIZES if args.reference_sizes
                     else DATASET_DEFAULT_SIZES.get(args.dataset, _FALLBACK_SIZES))
    if args.resize_size is None:
        args.resize_size = default_sizes[0]
    if args.input_size is None:
        args.input_size = default_sizes[1]

    config = {
        "name": args.name,
        "data_dir": args.data_dir,
        "batch_size": {"train": args.batch_size, "val": args.batch_size,
                       "test": args.batch_size},
        "num_workers": args.num_workers,
        "learning_rate": args.learning_rate,
        "max_epochs": args.max_epochs,
        "resize_size": args.resize_size,
        "input_size": args.input_size,
        "num_classes": num_classes,
        "patience": args.patience,
        "min_delta": args.min_delta,
        "similarity": args.similarity,
        "dataset": args.dataset,
        "model_type": args.model_type,
        "model_variant": args.model_variant,
        "nfp_radius": args.nfp_radius,
        "nfp_padding": args.nfp_padding,
        "nfp_insert_idx": args.nfp_insert_idx,
        "nfp_intermediate_layer_idx": args.nfp_intermediate_layer_idx,
        "nfp_mid_layer_idx": args.nfp_mid_layer_idx,
        "async_ckpt": args.async_ckpt,
        "resume": args.resume,
        "scheduler": args.scheduler,
        "label_smoothing": args.label_smoothing,
        "num_samples": args.num_samples,
        "stem_s2d": args.stem_s2d,
        "steps_per_dispatch": args.steps_per_dispatch,
        "grad_accum": args.grad_accum,
        "eval_only": args.eval_only,
        "eval_restore": args.eval_restore,
        "device": args.device,
    }

    results = []
    for seed in args.seeds:
        print(f"\n==== Running experiment with seed {seed} ====")
        acc = run_experiment(seed, config)
        print(f"Seed {seed} Test Accuracy: {acc:.4f}")
        results.append(acc)
    print(f"\n Final Test Accuracy over {len(results)} seeds: "
          f"{np.mean(results):.4f} ± {np.std(results):.4f}")


if __name__ == "__main__":
    main()
