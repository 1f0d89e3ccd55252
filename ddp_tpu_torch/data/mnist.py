"""MNIST-family IDX data (a numpy copy of ``ddp_tpu/data/mnist.py``).

Reads the four gzip IDX files of a split into uint8 NHWC images and
int32 labels; normalisation (``/ 255``, ToTensor's) happens inside the
train step, so the data stays uint8 on the host and on the device.
Nothing is downloaded: a missing file raises and names its path, and
only ``allow_synthetic`` (``--synthetic_data``) turns that into the
deterministic synthetic split, byte for byte the JAX package's.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import NamedTuple

import numpy as np

# Variants share the IDX container; all but "mnist" live in a
# subdirectory of the data root named after the variant. uci_digits is
# the vendored real-digit set under data/uci_digits/.
VARIANTS = ("mnist", "fashion_mnist", "kmnist", "uci_digits")
_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}


class Split(NamedTuple):
    images: np.ndarray  # [N, 28, 28, 1] uint8 (NHWC)
    labels: np.ndarray  # [N] int32


def parse_idx(raw: bytes) -> np.ndarray:
    """Parse one IDX-format buffer (images or labels).

    Format: 2 zero bytes, dtype code, ndim, then ndim big-endian uint32
    dims, then the payload.
    """
    if len(raw) < 4:
        raise ValueError("truncated IDX header")
    zero, dtype_code, ndim = raw[0] << 8 | raw[1], raw[2], raw[3]
    if zero != 0:
        raise ValueError(f"bad IDX magic prefix {raw[:2]!r}")
    dtypes = {
        0x08: np.uint8,
        0x09: np.int8,
        0x0B: np.dtype(">i2"),
        0x0C: np.dtype(">i4"),
        0x0D: np.dtype(">f4"),
        0x0E: np.dtype(">f8"),
    }
    if dtype_code not in dtypes:
        raise ValueError(f"bad IDX dtype code {dtype_code:#x}")
    header_end = 4 + 4 * ndim
    dims = struct.unpack(f">{ndim}I", raw[4:header_end])
    arr = np.frombuffer(raw, dtype=dtypes[dtype_code], offset=header_end)
    expected = int(np.prod(dims)) if ndim else 0
    if arr.size != expected:
        raise ValueError(f"IDX payload size {arr.size} != {expected} for dims {dims}")
    return arr.reshape(dims)


def _path(root: str, fname: str, variant: str) -> str:
    base = root if variant == "mnist" else os.path.join(root, variant)
    path = os.path.join(base, fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: the port downloads nothing — put the "
            f"{variant!r} IDX files there, or pass --synthetic_data"
        )
    return path


def _read_idx_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return parse_idx(gzip.decompress(f.read()))


def _load_pair(root: str, split: str, variant: str = "mnist") -> Split:
    images = _read_idx_file(_path(root, _FILES[f"{split}_images"], variant))[
        ..., None
    ]
    labels = _read_idx_file(
        _path(root, _FILES[f"{split}_labels"], variant)
    ).astype(np.int32)
    if images.shape[0] != labels.shape[0]:
        raise ValueError("image/label count mismatch")
    return Split(np.ascontiguousarray(images), labels)


def synthetic(
    num: int, *, seed: int = 0, num_classes: int = 10, side: int = 28
) -> Split:
    """Deterministic MNIST-shaped synthetic data (offline fallback).

    Each class gets a fixed smooth template; samples are the template
    plus pixel noise — separable enough to train on, hard enough that
    accuracy is not trivially 100%.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    templates = np.stack(
        [
            np.sin((c + 2) * np.pi * xx + c) * np.cos((c % 4 + 1) * np.pi * yy)
            for c in range(num_classes)
        ]
    )  # [C, H, W] in [-1, 1]
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    base = (templates[labels] * 0.5 + 0.5) * 200.0
    noise = rng.normal(0.0, 20.0, size=base.shape)
    images = np.clip(base + noise, 0, 255).astype(np.uint8)[..., None]
    return Split(images, labels)


def load(
    root: str = "./data",
    split: str = "train",
    *,
    variant: str = "mnist",
    allow_synthetic: bool = False,
    synthetic_size: int | None = None,
) -> Split:
    """Load an MNIST-family split as (uint8 NHWC images, int32 labels).

    ``allow_synthetic`` gates the offline fallback so a missing file
    can't silently swap datasets in a real run.
    """
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    try:
        return _load_pair(root, split, variant)
    except (OSError, ValueError):
        if not allow_synthetic:
            raise
        n = synthetic_size or (60_000 if split == "train" else 10_000)
        return synthetic(n, seed=0 if split == "train" else 1)
