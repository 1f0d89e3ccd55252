"""CIFAR-10/100 binary data (a numpy copy of ``ddp_tpu/data/cifar.py``).

Reads the ``-binary`` tarballs from the data root into uint8 NHWC images
and int32 labels; normalisation and augmentation happen inside the train
step, on the device. Nothing is downloaded: a missing tarball raises and
names its path, and only ``allow_synthetic`` (``--synthetic_data``) turns
that into the deterministic synthetic split, byte for byte the JAX
package's.

Record layouts:
- CIFAR-10: 6 files × 10000 records of [label u8][3072 u8 RGB, CHW];
- CIFAR-100: train/test files, records of [coarse u8][fine u8][3072 u8]
  (the fine label is the label).
"""

from __future__ import annotations

import os
import tarfile

import numpy as np

from ddp_tpu_torch.data.mnist import Split

NAMES = ("cifar10", "cifar100")
_TARS = {
    "cifar10": "cifar-10-binary.tar.gz",
    "cifar100": "cifar-100-binary.tar.gz",
}
_TRAIN_FILES = {
    "cifar10": [f"cifar-10-batches-bin/data_batch_{i}.bin" for i in range(1, 6)],
    "cifar100": ["cifar-100-binary/train.bin"],
}
_TEST_FILES = {
    "cifar10": ["cifar-10-batches-bin/test_batch.bin"],
    "cifar100": ["cifar-100-binary/test.bin"],
}


def parse_records(raw: bytes, *, name: str) -> Split:
    """Decode one binary batch file into (uint8 NHWC images, labels)."""
    label_bytes = 1 if name == "cifar10" else 2  # cifar100: coarse+fine
    record = label_bytes + 3072
    if len(raw) % record:
        raise ValueError(f"{name} batch size {len(raw)} not a multiple of {record}")
    arr = np.frombuffer(raw, np.uint8).reshape(-1, record)
    labels = arr[:, label_bytes - 1].astype(np.int32)  # fine label for cifar100
    images = (
        arr[:, label_bytes:]
        .reshape(-1, 3, 32, 32)  # CHW planar
        .transpose(0, 2, 3, 1)  # → NHWC
    )
    return Split(np.ascontiguousarray(images), labels)


def _tar_path(root: str, name: str) -> str:
    path = os.path.join(root, _TARS[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: the port downloads nothing — put the "
            f"{name!r} binary tarball there, or pass --synthetic_data"
        )
    return path


def _load_split(root: str, name: str, split: str) -> Split:
    members = (_TRAIN_FILES if split == "train" else _TEST_FILES)[name]
    parts: list[Split] = []
    with tarfile.open(_tar_path(root, name), "r:gz") as tf:
        for member in members:
            raw = tf.extractfile(member).read()  # type: ignore[union-attr]
            parts.append(parse_records(raw, name=name))
    return Split(
        np.concatenate([p.images for p in parts]),
        np.concatenate([p.labels for p in parts]),
    )


def synthetic(num: int, *, seed: int = 0, num_classes: int = 10) -> Split:
    """Deterministic CIFAR-shaped synthetic data (offline fallback)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    templates = np.stack(
        [
            np.stack(
                [
                    np.sin((c + 2) * np.pi * xx + ch) * np.cos((c % 5 + 1) * np.pi * yy)
                    for ch in range(3)
                ],
                axis=-1,
            )
            for c in range(num_classes)
        ]
    )  # [C, 32, 32, 3] in [-1, 1]
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    base = (templates[labels] * 0.5 + 0.5) * 200.0
    noise = rng.normal(0.0, 20.0, size=base.shape)
    images = np.clip(base + noise, 0, 255).astype(np.uint8)
    return Split(images, labels)


def load(
    root: str = "./data",
    split: str = "train",
    *,
    name: str = "cifar10",
    allow_synthetic: bool = False,
    synthetic_size: int | None = None,
) -> Split:
    """One split as (uint8 NHWC images, int32 labels). ``allow_synthetic``
    gates the offline fallback, so a missing file cannot silently swap
    datasets in a real run."""
    if name not in NAMES:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(NAMES)}")
    try:
        return _load_split(root, name, split)
    except (OSError, ValueError, KeyError, tarfile.TarError, EOFError):
        if not allow_synthetic:
            raise
        n = synthetic_size or (50_000 if split == "train" else 10_000)
        return synthetic(
            n,
            seed=0 if split == "train" else 1,
            num_classes=10 if name == "cifar10" else 100,
        )
