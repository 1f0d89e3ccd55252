"""ImageNet-1k ingestion (``ddp_tpu/data/imagenet.py``): the
preprocessed-array loader and the deterministic synthetic stand-in.

``load`` memory-maps ``imagenet_{split}_images.npy`` (uint8 NHWC) and
reads ``imagenet_{split}_labels.npy`` from ``root``, as written by
``python -m ddp_tpu_torch.data.preprocess_imagenet``; the loader's gather
(and the native pool) then reads pages on demand. Without them, and only
when asked, ``synthetic`` generates ImageNet's shapes ([N, 224, 224, 3]
uint8, 1000 classes): per-class plane-wave interference patterns plus
noise, the same bytes as the JAX package's for the same seed.
"""

from __future__ import annotations

import os

import numpy as np

from ddp_tpu_torch.data.mnist import Split

IMAGE_SIZE = 224
NUM_CLASSES = 1000


def synthetic(
    num: int,
    *,
    seed: int = 0,
    num_classes: int = NUM_CLASSES,
    side: int = IMAGE_SIZE,
) -> Split:
    """Deterministic ImageNet-shaped synthetic data: per-class plane-wave
    interference patterns (frequency and phase keyed by the label) plus
    noise, generated in float32 chunks of 256 images."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    out = np.empty((num, side, side, 3), np.uint8)
    chunk = 256
    for lo in range(0, num, chunk):
        lab = labels[lo:lo + chunk]
        fx = (1 + lab % 13).astype(np.float32)[:, None, None]
        fy = (1 + (lab // 13) % 11).astype(np.float32)[:, None, None]
        phase = (lab * 2.618).astype(np.float32)[:, None, None]
        base = np.sin(fx * np.pi * xx[None] + phase) * np.cos(
            fy * np.pi * yy[None]
        )
        img = np.stack(
            [base, np.roll(base, side // 7, axis=1), -base], axis=-1
        )
        img *= 90.0
        img += 128.0
        img += 12.0 * rng.standard_normal(size=img.shape, dtype=np.float32)
        np.clip(img, 0, 255, out=img)
        out[lo:lo + chunk] = img.astype(np.uint8)
    return Split(out, labels)


def load(
    root: str = "./data",
    split: str = "train",
    *,
    allow_synthetic: bool = False,
    synthetic_size: int | None = None,
) -> Split:
    """A split as (uint8 NHWC images, memory-mapped; int32 labels); the
    synthetic split (train seed 0 with 4096 images, test seed 1 with
    1024, unless ``synthetic_size``) only with ``allow_synthetic``."""
    img_path = os.path.join(root, f"imagenet_{split}_images.npy")
    lbl_path = os.path.join(root, f"imagenet_{split}_labels.npy")
    if os.path.exists(img_path) and os.path.exists(lbl_path):
        images = np.load(img_path, mmap_mode="r")
        labels = np.asarray(np.load(lbl_path)).astype(np.int32)
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(
                f"{img_path}: expected uint8 [N, H, W, C], got "
                f"{images.dtype} {images.shape}"
            )
        if len(images) != len(labels):
            raise ValueError("image/label count mismatch")
        return Split(images, labels)
    if not allow_synthetic:
        raise RuntimeError(
            f"no preprocessed ImageNet arrays under {root!r} "
            f"(need {img_path}); pass allow_synthetic to use the "
            f"deterministic synthetic stand-in"
        )
    n = synthetic_size or (4096 if split == "train" else 1024)
    return synthetic(n, seed=0 if split == "train" else 1)
