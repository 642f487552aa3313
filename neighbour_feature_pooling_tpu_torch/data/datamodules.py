"""Data modules (counterpart of ``neighbour_feature_pooling_tpu/data/
datamodules.py``), the host path.

The reference's Lightning DataModule contract: ``prepare_data()`` /
``setup(stage)``, per-split batch sizes (an int or a ``{'train', 'val',
'test'}`` dict), ``num_classes`` / ``num_input_channels`` and
``print_first_batch_shape()``. Batches are ``{"image": NHWC float32,
"label": int32, "weight": float32}`` numpy dicts; the last eval batch of a
split is zero-padded with ``weight=0`` so every step has one shape. The
order, the per-record augmentation seeds and the transforms are the JAX
package's, so a seeded batch is the same bit for bit.

Ported: ``SyntheticDataModule`` (the offline smoke and benchmark workload)
and ``FolderDataModule`` with its subclasses over a local class-folder
tree. Not ported yet: downloads (``prepare_data`` is a no-op), the native
C++ augment and the CIFAR-10 and FashionMNIST readers (ROADMAP.md Queue 1
item 2, training remainder); the device-resident paths
(``device_augment``, ``device_data``, ``device_eval``; item 7).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .transforms import TransformConfig, eval_transform, train_transform

__all__ = [
    "Batch",
    "DataModule",
    "ArrayDataModule",
    "SyntheticDataModule",
    "FolderDataModule",
    "UCMercedDataModule",
    "RESISC45DataModule",
    "GTOSMobileDataModule",
    "PlantVillageDataModule",
    "EuroSATDataModule",
    "MSTARDataModule",
    "SugarcaneDamageUSADataModule",
    "DATASET_NUM_CLASSES",
    "get_datamodule",
]

Batch = Dict[str, np.ndarray]

_TRAIN_REST = "not ported yet: ROADMAP.md Queue 1 item 2 (training remainder)"

#: the reference's CLI table (PlantVillage: 38)
DATASET_NUM_CLASSES = {
    "UCMerced": 21,
    "RESISC45": 45,
    "MSTAR": 6,
    "cifar10": 10,
    "GTOS-Mobile": 31,
    "PlantVillage": 38,
    "EuroSAT": 10,
    "synthetic": 4,
}

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp", ".gif")


def _pad_batch(images: np.ndarray, labels: np.ndarray, batch_size: int) -> Batch:
    """Zero-pad to ``batch_size`` rows with a masking weight channel."""
    n = images.shape[0]
    weight = np.ones((batch_size,), np.float32)
    if n < batch_size:
        pad = batch_size - n
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
        weight[n:] = 0.0
    return {"image": images.astype(np.float32), "label": labels.astype(np.int32),
            "weight": weight}


class DataModule:
    """Base lifecycle and iteration API."""

    num_classes: int = 0
    num_input_channels: int = 3

    def prepare_data(self) -> None:  # downloads in the JAX package
        pass

    def setup(self, stage: Optional[str] = None) -> None:
        raise NotImplementedError

    def train_batches(self, epoch: int = 0) -> Iterator[Batch]:
        raise NotImplementedError

    def val_batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    def test_batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    def print_first_batch_shape(self) -> None:
        batch = next(iter(self.train_batches()))
        print(f"First batch image shape: {batch['image'].shape}, "
              f"labels: {batch['label'].shape}")


@dataclasses.dataclass
class _Split:
    images: List  # lazily decoded items (np arrays or file paths)
    labels: np.ndarray


class ArrayDataModule(DataModule):
    """In-memory or file-backed dataset with the reference transforms."""

    def __init__(self, num_classes: int, batch_size=32, num_workers: int = 0,
                 transform: Optional[TransformConfig] = None, seed: int = 42,
                 num_input_channels: int = 3, split_seed: int = 42):
        self.num_classes = num_classes
        self.num_input_channels = num_input_channels
        if isinstance(batch_size, int):
            batch_size = {"train": batch_size, "val": batch_size, "test": batch_size}
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.transform = transform or TransformConfig()
        #: per-run seed: shuffling order and augmentation randomness
        self.seed = seed
        #: fixed seed of the train/val/test split, so every run seed is
        #: tested on the same test set
        self.split_seed = split_seed
        self._splits: Dict[str, _Split] = {}
        self._decode_cache: Dict[str, np.ndarray] = {}
        self._decode_cache_bytes = 0
        self._decode_executor = None

    def _decode(self, item) -> np.ndarray:
        """item -> HWC image: uint8 in [0, 255] for a file, or the array
        itself for an in-memory dataset (float32 in [0, 1])."""
        if isinstance(item, np.ndarray):
            return item
        from PIL import Image

        with Image.open(item) as im:
            return np.asarray(im.convert("RGB"))

    #: decoded-image cache budget in MB (0 disables); default 1024, or the
    #: environment's ``NFP_TPU_DECODE_CACHE_MB``
    decode_cache_mb: Optional[int] = None

    def _decode_cache_budget(self) -> int:
        mb = self.decode_cache_mb
        if mb is None:
            mb = int(os.environ.get("NFP_TPU_DECODE_CACHE_MB", "1024"))
        return mb * (1 << 20)

    def _decode_cached(self, item) -> np.ndarray:
        if isinstance(item, np.ndarray):
            return item
        hit = self._decode_cache.get(item)
        if hit is not None:
            return hit
        arr = self._decode(item)
        if self._decode_cache_bytes + arr.nbytes <= self._decode_cache_budget():
            self._decode_cache[item] = arr
            self._decode_cache_bytes += arr.nbytes
        return arr

    def _decode_many(self, items: Sequence) -> List[np.ndarray]:
        """Decode a batch of items in order, across ``num_workers`` threads
        (PIL's decoders release the GIL) when there are more than one,
        through the decoded-image cache."""
        if self.num_workers <= 1 or all(isinstance(it, np.ndarray) for it in items):
            return [self._decode_cached(it) for it in items]
        if self._decode_executor is None:
            from concurrent.futures import ThreadPoolExecutor

            self._decode_executor = ThreadPoolExecutor(
                max_workers=self.num_workers, thread_name_prefix="nfp-decode")
        return list(self._decode_executor.map(self._decode_cached, items))

    def close(self) -> None:
        """Release the decode pool (safe to call repeatedly)."""
        if self._decode_executor is not None:
            self._decode_executor.shutdown(wait=False)
            self._decode_executor = None

    def _iter(self, split: str, shuffle: bool, epoch: int) -> Iterator[Batch]:
        sp = self._splits[split]
        n = len(sp.images)
        bs = self.batch_size[split if split in self.batch_size else "test"]
        order = np.arange(n)
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch)
        if shuffle:
            rng.shuffle(order)
        # training drops the final partial batch (unless it is the only
        # one): zero-padded rows would enter the BatchNorm batch statistics,
        # which the weight channel does not mask; eval keeps the padded tail
        end = n
        if shuffle and n >= bs:
            end = (n // bs) * bs
        for start in range(0, end, bs):
            idx = order[start: start + bs]
            # per-record augmentation seeds (seed, epoch, sample index)
            img_rngs = [np.random.default_rng([self.seed, epoch, int(i)]) for i in idx]
            raw = self._decode_many([sp.images[i] for i in idx])
            imgs = np.stack([
                train_transform(img, self.transform, r) if shuffle
                else eval_transform(img, self.transform)
                for img, r in zip(raw, img_rngs)])
            yield _pad_batch(imgs, sp.labels[idx], bs)

    def train_batches(self, epoch: int = 0) -> Iterator[Batch]:
        return self._iter("train", True, epoch)

    def val_batches(self) -> Iterator[Batch]:
        return self._iter("val", False, 0)

    def test_batches(self) -> Iterator[Batch]:
        return self._iter("test", False, 0)

    def split_size(self, split: str) -> int:
        return len(self._splits[split].images)


class SyntheticDataModule(ArrayDataModule):
    """Deterministic synthetic texture classification.

    Class k is a sinusoidal grating with a class-dependent frequency and
    orientation plus noise: learnable in a couple of epochs, the offline
    smoke-train and benchmark workload.
    """

    def __init__(self, num_classes: int = 4, num_samples: int = 256,
                 image_size: int = 64, num_input_channels: int = 3,
                 batch_size=32, seed: int = 42, **kw):
        transform = kw.pop("transform", TransformConfig(
            resize_size=image_size, input_size=image_size,
            mean=(0.5,) * num_input_channels, std=(0.5,) * num_input_channels,
            scale_range=(0.9, 1.0)))
        super().__init__(num_classes, batch_size, transform=transform,
                         seed=seed, num_input_channels=num_input_channels, **kw)
        self.num_samples = num_samples
        self.image_size = image_size

    def setup(self, stage: Optional[str] = None) -> None:
        if self._splits:
            return
        rng = np.random.default_rng(self.split_seed)
        s, c = self.image_size, self.num_input_channels
        yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
        images, labels = [], []
        for i in range(self.num_samples):
            k = i % self.num_classes
            freq = 0.15 + 0.2 * k
            theta = np.pi * k / self.num_classes + rng.normal(0, 0.08)
            phase = rng.uniform(0, 2 * np.pi)
            wave = np.sin(freq * (np.cos(theta) * xx + np.sin(theta) * yy) + phase)
            img = 0.5 + 0.35 * wave[..., None] + rng.normal(0, 0.15, (s, s, c))
            images.append(np.clip(img, 0, 1).astype(np.float32))
            labels.append(k)
        images = np.stack(images)
        labels = np.asarray(labels, np.int64)
        n = len(images)
        n_train, n_val = int(0.7 * n), int(0.15 * n)
        self._splits = {
            "train": _Split(list(images[:n_train]), labels[:n_train]),
            "val": _Split(list(images[n_train:n_train + n_val]),
                          labels[n_train:n_train + n_val]),
            "test": _Split(list(images[n_train + n_val:]), labels[n_train + n_val:]),
        }


class FolderDataModule(ArrayDataModule):
    """Class-subfolder image tree: ``data_dir/<class_name>/*.{jpg,png,tif}``.

    Stratified 70/10/20 split with a fixed seed. A tree whose immediate
    subfolders are all named like splits (``train``, ``test``, ``val``,
    ``validation``) is merged and split anew, as in the JAX package.
    """

    dataset_name = "folder"

    def __init__(self, data_dir: str, num_classes: Optional[int] = None,
                 resize_size: int = 256, input_size: int = 224,
                 batch_size=32, num_workers: int = 0, seed: int = 42,
                 split: Tuple[float, float, float] = (0.7, 0.1, 0.2), **kw):
        transform = kw.pop("transform", TransformConfig(
            resize_size=resize_size, input_size=input_size))
        super().__init__(num_classes or 0, batch_size, num_workers, transform, seed, **kw)
        self.data_dir = data_dir
        self.split = split
        self.class_names: List[str] = []

    _SPLIT_DIR_NAMES = ("train", "test", "val", "validation")

    def _class_roots(self) -> List[str]:
        subdirs = sorted(d for d in os.listdir(self.data_dir)
                         if os.path.isdir(os.path.join(self.data_dir, d)))
        if subdirs and all(d.lower() in self._SPLIT_DIR_NAMES for d in subdirs):
            return [os.path.join(self.data_dir, d) for d in subdirs]
        return [self.data_dir]

    def _scan(self) -> Tuple[List[str], List[int]]:
        if not self.data_dir or not os.path.isdir(self.data_dir):
            raise FileNotFoundError(
                f"{type(self).__name__}: data_dir {self.data_dir!r} not found; provide a "
                f"class-subfolder tree (downloads are {_TRAIN_REST}) or use "
                f"--dataset synthetic.")
        roots = self._class_roots()
        classes = sorted({d for root in roots for d in os.listdir(root)
                          if os.path.isdir(os.path.join(root, d))})
        paths, labels = [], []
        for li, cls in enumerate(classes):
            for root in roots:
                cdir = os.path.join(root, cls)
                if not os.path.isdir(cdir):
                    continue
                for fn in sorted(os.listdir(cdir)):
                    if fn.lower().endswith(_IMG_EXTS):
                        paths.append(os.path.join(cdir, fn))
                        labels.append(li)
        if not paths:
            raise FileNotFoundError(f"{type(self).__name__}: no images under {self.data_dir!r}")
        self.class_names = classes
        return paths, labels

    def setup(self, stage: Optional[str] = None) -> None:
        if self._splits:
            return
        paths, labels = self._scan()
        labels = np.asarray(labels, np.int64)
        if not self.num_classes:
            self.num_classes = int(labels.max()) + 1
        rng = np.random.default_rng(self.split_seed)
        tr_idx, va_idx, te_idx = [], [], []
        for c in range(self.num_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            n = len(idx)
            n_tr = int(self.split[0] * n)
            n_va = int(self.split[1] * n)
            tr_idx.extend(idx[:n_tr])
            va_idx.extend(idx[n_tr:n_tr + n_va])
            te_idx.extend(idx[n_tr + n_va:])

        def make(ids):
            return _Split([paths[i] for i in ids], labels[list(ids)])

        self._splits = {"train": make(tr_idx), "val": make(va_idx), "test": make(te_idx)}


class UCMercedDataModule(FolderDataModule):
    """UCMerced LandUse, 21 classes, 256 px TIFFs."""

    dataset_name = "UCMerced"

    def __init__(self, resize_size=256, input_size=224, data_dir=None,
                 batch_size=32, num_workers: int = 0, **kw):
        super().__init__(data_dir, 21, resize_size, input_size, batch_size, num_workers, **kw)


class RESISC45DataModule(FolderDataModule):
    """NWPU-RESISC45, 45 classes."""

    dataset_name = "RESISC45"

    def __init__(self, resize_size=256, input_size=224, data_dir=None,
                 batch_size=32, num_workers: int = 0, **kw):
        super().__init__(data_dir, 45, resize_size, input_size, batch_size, num_workers, **kw)


class GTOSMobileDataModule(FolderDataModule):
    """GTOS-Mobile ground terrain, 31 classes."""

    dataset_name = "GTOS-Mobile"

    def __init__(self, batch_size=32, num_workers: int = 0, data_dir=None,
                 resize_size=256, input_size=224, **kw):
        super().__init__(data_dir, 31, resize_size, input_size, batch_size, num_workers, **kw)


class PlantVillageDataModule(FolderDataModule):
    """PlantVillage leaf disease; the class count is the tree's (38 in the
    CLI table)."""

    dataset_name = "PlantVillage"

    def __init__(self, batch_size=32, num_workers: int = 0, data_dir=None,
                 resize_size=256, input_size=224, **kw):
        super().__init__(data_dir, None, resize_size, input_size, batch_size, num_workers, **kw)


class EuroSATDataModule(FolderDataModule):
    """EuroSAT, 10 classes: 13-band GeoTIFFs (read with ``tifffile``
    where it is installed) or RGB images, adapted to ``bands`` channels."""

    dataset_name = "EuroSAT"

    def __init__(self, resize_size=64, input_size=64, data_dir=None,
                 batch_size=32, num_workers: int = 0, bands: int = 13, **kw):
        kw.setdefault("transform", TransformConfig(
            resize_size=resize_size, input_size=input_size, mean=(0.5,), std=(0.5,)))
        super().__init__(data_dir, 10, resize_size, input_size, batch_size, num_workers, **kw)
        self.num_input_channels = bands

    def _decode(self, item) -> np.ndarray:
        if isinstance(item, np.ndarray):
            return item
        if str(item).lower().endswith((".tif", ".tiff")):
            arr = _read_multiband_tiff(str(item))
            if arr is not None:
                # uint8 tiles are 0-255; uint16 tiles are Sentinel-2
                # reflectance (0-10000 typical)
                if arr.dtype == np.uint8:
                    arr = arr.astype(np.float32) / 255.0
                elif np.issubdtype(arr.dtype, np.integer):
                    arr = arr.astype(np.float32) / 10000.0
                else:
                    arr = arr.astype(np.float32)
                if arr.shape[2] != self.num_input_channels:
                    arr = _adapt_bands(arr, self.num_input_channels)
                return np.clip(arr, 0.0, 1.0)
        img = super()._decode(item)
        if img.shape[2] != self.num_input_channels:
            img = _adapt_bands(img, self.num_input_channels)
        return img


def _read_multiband_tiff(path: str) -> Optional[np.ndarray]:
    """Multi-band TIFF decode with ``tifffile``; None where it is missing."""
    try:
        import tifffile

        arr = tifffile.imread(path)
    except Exception:
        return None
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim == 3 and arr.shape[0] < arr.shape[2]:  # CHW -> HWC
        arr = np.transpose(arr, (1, 2, 0))
    return arr


def _adapt_bands(img: np.ndarray, bands: int) -> np.ndarray:
    """Repeat or truncate channels (timm's ``in_chans`` adaptation)."""
    c = img.shape[2]
    if c == bands:
        return img
    reps = int(np.ceil(bands / c))
    return np.concatenate([img] * reps, axis=2)[:, :, :bands]


class MSTARDataModule(FolderDataModule):
    """MSTAR SAR target chips, 6 classes."""

    dataset_name = "MSTAR"

    def __init__(self, resize_size=128, input_size=128, data_dir=None,
                 batch_size=32, num_workers: int = 0, **kw):
        super().__init__(data_dir, 6, resize_size, input_size, batch_size, num_workers, **kw)


class SugarcaneDamageUSADataModule(FolderDataModule):
    """sugarcane_damage_usa (AgML) from its extracted class-folder tree,
    70/10/20 split."""

    dataset_name = "sugarcane_damage_usa"

    def __init__(self, resize_size=256, input_size=224, data_dir=None,
                 batch_size=32, num_workers: int = 0, **kw):
        super().__init__(data_dir, None, resize_size, input_size, batch_size, num_workers,
                         split=(0.7, 0.1, 0.2), **kw)


_FOLDER_MODULES = {
    "UCMerced": UCMercedDataModule,
    "RESISC45": RESISC45DataModule,
    "GTOS-Mobile": GTOSMobileDataModule,
    "PlantVillage": PlantVillageDataModule,
    "MSTAR": MSTARDataModule,
    "sugarcane_damage_usa": SugarcaneDamageUSADataModule,
}


def get_datamodule(dataset: str, config: Dict) -> DataModule:
    """Dataset registry, as the JAX ``get_datamodule``; the device-resident
    options and the CIFAR-10 / FashionMNIST readers raise
    ``NotImplementedError``."""
    for key in ("device_augment", "device_data", "device_eval"):
        if config.get(key):
            raise NotImplementedError(
                f"{key} is not ported yet: ROADMAP.md Queue 1 item 7 (device-side data)")
    common = dict(
        resize_size=config.get("resize_size", 256),
        input_size=config.get("input_size", 224),
        data_dir=config.get("data_dir"),
        batch_size=config.get("batch_size", 32),
        num_workers=config.get("num_workers", 0),
        seed=config.get("seed", 42),
    )
    if dataset in _FOLDER_MODULES:
        return _FOLDER_MODULES[dataset](**common)
    if dataset == "EuroSAT":
        return EuroSATDataModule(bands=config.get("num_input_channels", 13), **common)
    if dataset in ("cifar10", "FashionMNIST"):
        raise NotImplementedError(f"the {dataset} reader is {_TRAIN_REST}")
    if dataset == "synthetic":
        return SyntheticDataModule(
            num_classes=config.get("num_classes", 4),
            num_samples=config.get("num_samples", 256),
            image_size=config.get("input_size", 64),
            num_input_channels=config.get("num_input_channels", 3),
            batch_size=config.get("batch_size", 32),
            seed=config.get("seed", 42))
    raise ValueError(f"Unknown dataset: {dataset}")
