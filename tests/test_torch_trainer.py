"""The PyTorch port's data path, trainer, checkpoints and CLI, on the CPU.

The data modules are held against the JAX package's bit for bit (its
python/PIL augmentation, ``use_native=False``: the JAX package's optional
C++ augment resamples differently and is not ported). The trainer and the
CLI run the port alone at 16–24 px on ``device="cpu"``, as the JAX
package's own trainer and CLI tests run it (tests/test_train.py,
tests/test_cli.py), and the CLI's flag set is compared with the JAX
``build_parser``'s.
"""

import json
import os

import numpy as np
import pytest
import torch

from neighbour_feature_pooling_tpu import cli as jax_cli
from neighbour_feature_pooling_tpu.data import SyntheticDataModule as JaxSynthetic
from neighbour_feature_pooling_tpu.data.transforms import plan_train as jax_plan_train
from neighbour_feature_pooling_tpu_torch import cli
from neighbour_feature_pooling_tpu_torch.data import SyntheticDataModule, TransformConfig
from neighbour_feature_pooling_tpu_torch.data.transforms import plan_train
from neighbour_feature_pooling_tpu_torch.models import get_model
from neighbour_feature_pooling_tpu_torch.serve import Predictor
from neighbour_feature_pooling_tpu_torch.train import Trainer, TrainerConfig, checkpoint
from neighbour_feature_pooling_tpu_torch.train.engine import create_train_state
from test_torch_model import one_torch_thread  # noqa: F401

NUM_CLASSES = 2


# ---------------------------------------------------------------- data


def _batches(dm, epoch):
    dm.setup("fit")
    return {"train": list(dm.train_batches(epoch)), "val": list(dm.val_batches()),
            "test": list(dm.test_batches())}


@pytest.mark.parametrize("epoch", [0, 1])
def test_synthetic_batches_equal_jax_bit_for_bit(epoch):
    """Images, labels and weights of every split, the train split with its
    seeded crops and flips, equal the JAX data module's; 70 samples give a
    dropped train tail and a padded val and test tail."""
    kw = dict(num_classes=3, num_samples=70, image_size=20, batch_size=8, seed=7)
    jdm = JaxSynthetic(**kw)
    jdm.use_native = False
    want = _batches(jdm, epoch)
    got = _batches(SyntheticDataModule(**kw), epoch)
    for split in ("train", "val", "test"):
        assert len(got[split]) == len(want[split]) > 0, split
        for b_got, b_want in zip(got[split], want[split]):
            for key in ("image", "label", "weight"):
                assert b_got[key].dtype == b_want[key].dtype, (split, key)
                np.testing.assert_array_equal(b_got[key], b_want[key], err_msg=f"{split}/{key}")
    assert got["val"][-1]["weight"].min() == 0.0


def test_plan_train_equals_jax():
    cfg = TransformConfig(resize_size=256, input_size=224)
    for i, shape in enumerate([(256, 256), (300, 200), (180, 400)]):
        a = plan_train(shape, cfg, np.random.default_rng([1, i]))
        b = jax_plan_train(shape, cfg, np.random.default_rng([1, i]))
        assert a == b


# ---------------------------------------------------------------- trainer


def _dm(num_samples=32, batch_size=16):
    return SyntheticDataModule(num_classes=NUM_CLASSES, num_samples=num_samples,
                               image_size=16, batch_size=batch_size)


def _trainer(tmp_path, tag, max_epochs, variant="texture_nfp", **cfg):
    cfg = dict(dict(learning_rate=1e-3, patience=10, freeze_nfp=False), **cfg)
    model = get_model("resnet18", variant, NUM_CLASSES)
    return Trainer(model, NUM_CLASSES, TrainerConfig(
        max_epochs=max_epochs, log_dir=str(tmp_path / f"l{tag}"),
        ckpt_dir=str(tmp_path / f"c{tag}"), **cfg), device="cpu")


def _constant_val(trainer, loss=1.0, acc=0.5):
    """Script the val metrics so that the early-stop and scheduler counters
    are exactly controlled."""
    trainer.evaluate = lambda batches: {
        "loss": loss, "accuracy": acc, "micro_accuracy": acc, "precision": acc,
        "recall": acc, "f1": acc, "confusion": [[1, 0], [0, 1]]}


def test_trainer_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Trainer(get_model("resnet18", "gap_only", 2), 2, TrainerConfig())


def test_fit_resume_and_history_identical(tmp_path):
    """train(4) and train(2) + resume(2) give float-identical epoch records
    (weights, Adam state, BatchNorm statistics and step counters ride the
    checkpoint; the data order is keyed on (seed, epoch)); the logs and
    checkpoints are where the JAX trainer writes them."""
    full = _trainer(tmp_path, "f", 4).fit(_dm())["history"]
    _trainer(tmp_path, "p", 2).fit(_dm())
    part = _trainer(tmp_path, "p", 4).fit(_dm(), resume=True)["history"]
    assert [h["epoch"] for h in part] == [2, 3]
    for hf, hp in zip(full[2:], part):
        assert hf["train"]["loss"] == hp["train"]["loss"]
        assert hf["train"]["accuracy"] == hp["train"]["accuracy"]
        assert hf["val"]["loss"] == hp["val"]["loss"]
    records = [json.loads(line) for line in open(tmp_path / "lp" / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1, 2, 3]
    assert all(r["train"]["data_wait_s"] >= 0 for r in records)
    assert (tmp_path / "lp" / "experiment.log").exists()
    for name in ("best", "last"):
        assert checkpoint.checkpoint_exists(str(tmp_path / "cp" / name))
        assert (tmp_path / "cp" / f"{name}.meta.json").exists()
    assert json.load(open(tmp_path / "cp" / "last.meta.json"))["epoch"] == 3


def test_dropout_masks_follow_the_step_across_a_resume(tmp_path):
    """gap_mlp (dropout 0.2): train(2) and train(1) + resume(1) give the
    same second epoch, because each step's masks come from (seed + 1,
    step), and the step rides the checkpoint."""
    full = _trainer(tmp_path, "f", 2, variant="gap_mlp").fit(_dm())["history"]
    _trainer(tmp_path, "p", 1, variant="gap_mlp").fit(_dm())
    part = _trainer(tmp_path, "p", 2, variant="gap_mlp").fit(_dm(), resume=True)["history"]
    assert [h["epoch"] for h in part] == [1]
    assert full[1]["train"]["loss"] == part[0]["train"]["loss"]
    assert full[1]["val"]["loss"] == part[0]["val"]["loss"]
    assert full[0]["train"]["loss"] != full[1]["train"]["loss"]


def test_cli_passes_the_head_options_to_the_model():
    """``--nfp_stride`` reaches the legacy heads (JAX cli.py:246);
    ``num_codes`` and ``radam_m`` have no flag and keep their defaults."""
    kw = cli._model_kwargs({"nfp_stride": 2, "nfp_padding": 1})
    head = get_model("resnet18", "nfp_conv_mlp", NUM_CLASSES, **kw).head
    assert (head.stride, head.padding) == (2, 1)
    assert get_model("resnet18", "texture_deepten", NUM_CLASSES, **kw).encoding.codewords.shape \
        == (32, 512)
    assert get_model("vittiny", "texture_radam", NUM_CLASSES, **kw).pool.alphas.shape \
        == (4, 1, 192)


def test_early_stopping_counters_survive_resume(tmp_path):
    """val_loss never improves after epoch 0: patience 3 stops the
    uninterrupted run after epoch 3, and train(2) + resume stops at the
    same epoch (the counter rides ``last``'s metadata)."""
    def mk(tag, max_epochs):
        t = _trainer(tmp_path, tag, max_epochs, patience=3)
        _constant_val(t)
        return t

    full = mk("full", 20).fit(_dm())
    assert [h["epoch"] for h in full["history"]] == [0, 1, 2, 3]
    mk("split", 2).fit(_dm())
    resumed = mk("split", 20).fit(_dm(), resume=True)
    assert [h["epoch"] for h in resumed["history"]] == [2, 3]


def test_plateau_counters_survive_resume(tmp_path):
    """Plateau from epoch 1 with patience 1: cuts at epochs 2 and 4 give lr
    1e-3 · 0.5² after 5 epochs, with or without a resume after epoch 3."""
    def mk(tag, max_epochs):
        t = _trainer(tmp_path, tag, max_epochs, patience=100, scheduler="plateau",
                     scheduler_patience=1, scheduler_factor=0.5)
        _constant_val(t)
        return t

    tf = mk("full", 5)
    tf.fit(_dm())
    assert abs(tf.state.learning_rate - 2.5e-4) < 1e-9
    mk("split", 3).fit(_dm())
    t2 = mk("split", 5)
    t2.fit(_dm(), resume=True)
    assert abs(t2.state.learning_rate - tf.state.learning_rate) < 1e-12


def test_checkpoint_round_trip_and_failed_write(tmp_path, monkeypatch):
    """A checkpoint restores the model, the optimizer and the counters
    exactly; a write that fails leaves the previous checkpoint whole and no
    temporary file behind."""
    model = get_model("resnet18", "texture_nfp", NUM_CLASSES)
    state = create_train_state(model, 3, 1e-3, grad_accum=2)
    state.step, state.updates = 5, 2
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.25)
    path = str(tmp_path / "ck" / "last")
    checkpoint.save_checkpoint(path, state, {"epoch": 4})

    other = create_train_state(get_model("resnet18", "texture_nfp", NUM_CLASSES), 9, 1e-3,
                               grad_accum=2)
    _, meta = checkpoint.restore_checkpoint(path, other)
    assert meta == {"epoch": 4} and (other.step, other.updates) == (5, 2)
    for (name, a), b in zip(model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert all(torch.equal(p.grad, torch.full_like(p, 0.25)) for p in other.model.parameters())
    sd = checkpoint.restore_for_inference(path)
    assert set(sd) == set(model.state_dict())

    before = open(path + ".pt", "rb").read()

    def broken_save(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    state.step = 6
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, state, {"epoch": 5})
    assert open(path + ".pt", "rb").read() == before
    assert json.load(open(path + ".meta.json")) == {"epoch": 4}
    assert sorted(os.listdir(tmp_path / "ck")) == ["last.meta.json", "last.pt"]


# ---------------------------------------------------------------- CLI


def _option_strings(parser):
    return {s: a.default for a in parser._actions for s in a.option_strings}


def test_parser_flags_are_the_jax_flags_plus_device():
    want = _option_strings(jax_cli.build_parser())
    got = _option_strings(cli.build_parser())
    assert set(got) == set(want) | {"--device"}
    assert {k: got[k] for k in want} == want
    assert got["--device"] == "cuda"


@pytest.mark.parametrize("flags", [["--seed_parallel"], ["--zero", "fsdp"], ["--bf16"],
                                   ["--device_data"], ["--export_dir", "x"], ["--remat"]])
def test_unported_flags_exit_naming_the_roadmap(flags):
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item"):
        cli.main(["--dataset", "synthetic", "--device", "cpu"] + flags)


def test_main_end_to_end_then_serve(tmp_path, monkeypatch, capsys):
    """One seed on synthetic data at 24 px: the JAX CLI's log and checkpoint
    layout, the printed accuracies, then ``--resume`` and ``--eval_only``,
    and a ``Predictor`` serving the run's ``best``."""
    monkeypatch.chdir(tmp_path)
    base = ["--dataset", "synthetic", "--model_type", "resnet18",
            "--model_variant", "texture_nfp", "--input_size", "24", "--batch_size", "8",
            "--seeds", "7", "--num_samples", "40", "--learning_rate", "1e-3",
            "--device", "cpu"]
    argv = base + ["--max_epochs", "1"]
    cli.main(argv)
    out = capsys.readouterr().out
    assert "Seed 7 Test Accuracy" in out and "Final Test Accuracy" in out
    log_dir = tmp_path / "logs" / "synthetic" / "resnet18-texture_nfp-seed7"
    ckpt_dir = tmp_path / "checkpoints" / "synthetic" / "exp_seed7"
    assert (log_dir / "experiment.log").exists()
    records = [json.loads(line) for line in open(log_dir / "metrics.jsonl")]
    assert records[0]["epoch"] == 0 and "test" in records[-1]
    assert (log_dir / "confusion_matrices" / "confusion_matrix.png").exists()
    for name in ("best", "last"):
        assert (ckpt_dir / f"{name}.pt").exists() and (ckpt_dir / f"{name}.meta.json").exists()

    cli.main(base + ["--max_epochs", "2", "--resume"])
    records = [json.loads(line) for line in open(log_dir / "metrics.jsonl")]
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    cli.main(argv + ["--eval_only"])
    assert "Final Test Accuracy" in capsys.readouterr().out

    pred = Predictor("resnet18", "texture_nfp", 4, checkpoint=str(ckpt_dir / "best"),
                     batch_size=4, input_size=24, resize_size=24, device="cpu")
    want = checkpoint.restore_for_inference(str(ckpt_dir / "best"))
    for k, v in pred.state_dict().items():
        assert torch.equal(v, want[k]), k
    res = pred.predict([np.full((30, 30, 3), 0.5, np.float32)])
    assert res["probabilities"].shape == (1, 4) and np.isfinite(res["probabilities"]).all()
