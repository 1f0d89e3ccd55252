"""ddp_tpu_torch's ImageNet data ≡ the JAX package's, on the CPU.

``data/imagenet.synthetic`` must give JAX's uint8 arrays and labels bit
for bit for the same seed, at small ``num`` and ``side`` and at the real
224²; ``load`` must read preprocessed arrays memory-mapped and raise
JAX's errors; the registry must give ``imagenet`` JAX's class count and
synthetic test-split size. Integer data: every comparison is exact.
"""

import numpy as np
import pytest

from ddp_tpu.data import imagenet as jimagenet
from ddp_tpu.data.registry import NUM_CLASSES as JAX_NUM_CLASSES
from ddp_tpu.data.registry import load_dataset as jax_load_dataset
from ddp_tpu_torch.data import imagenet
from ddp_tpu_torch.data.registry import NUM_CLASSES, load_dataset, load_split
from ddp_tpu_torch.train.config import IMAGE_DATASETS


@pytest.mark.parametrize("num,side,seed,classes", [
    (5, 32, 0, 1000), (3, 48, 1, 1000), (300, 16, 7, 10), (2, 224, 0, 1000),
])
def test_synthetic_equals_jax(num, side, seed, classes):
    got = imagenet.synthetic(num, seed=seed, side=side, num_classes=classes)
    want = jimagenet.synthetic(num, seed=seed, side=side,
                               num_classes=classes)
    assert got.images.dtype == np.uint8 and got.labels.dtype == np.int32
    assert got.images.shape == (num, side, side, 3)
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.labels, want.labels)


def test_registry_equals_jax():
    assert "imagenet" in IMAGE_DATASETS
    assert NUM_CLASSES["imagenet"] == JAX_NUM_CLASSES["imagenet"] == 1000
    train, test = load_dataset("imagenet", "/nonexistent",
                               allow_synthetic=True, synthetic_size=8)
    jtrain, jtest = jax_load_dataset("imagenet", "/nonexistent",
                                     allow_synthetic=True, synthetic_size=8)
    assert len(test.images) == len(jtest.images) == 2  # synthetic_size // 4
    for a, b in ((train, jtrain), (test, jtest)):
        assert np.array_equal(a.images, b.images)
        assert np.array_equal(a.labels, b.labels)
    one = load_split("imagenet", "/nonexistent", "test",
                     allow_synthetic=True, synthetic_size=2)
    assert np.array_equal(one.images, test.images)


def test_missing_arrays_raise_as_jax(tmp_path):
    with pytest.raises(RuntimeError) as got:
        imagenet.load(str(tmp_path), "train")
    with pytest.raises(RuntimeError) as want:
        jimagenet.load(str(tmp_path), "train")
    assert str(got.value) == str(want.value)
    assert "preprocessed ImageNet" in str(got.value)


def test_preprocessed_arrays_load_memory_mapped(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (6, 24, 24, 3), dtype=np.uint8)
    labels = np.arange(6, dtype=np.int64)
    np.save(tmp_path / "imagenet_train_images.npy", images)
    np.save(tmp_path / "imagenet_train_labels.npy", labels)
    got = imagenet.load(str(tmp_path), "train")
    assert isinstance(got.images, np.memmap)
    assert np.array_equal(got.images, images)
    assert got.labels.dtype == np.int32
    assert np.array_equal(got.labels, labels)


@pytest.mark.parametrize("case", ["dtype", "rank", "count"])
def test_malformed_arrays_raise_as_jax(tmp_path, case):
    images = np.zeros((4, 8, 8, 3), np.uint8)
    labels = np.zeros(4, np.int32)
    if case == "dtype":
        images = images.astype(np.float32)
    elif case == "rank":
        images = images[..., 0]
    else:
        labels = labels[:3]
    np.save(tmp_path / "imagenet_train_images.npy", images)
    np.save(tmp_path / "imagenet_train_labels.npy", labels)
    with pytest.raises(ValueError) as got:
        imagenet.load(str(tmp_path), "train")
    with pytest.raises(ValueError) as want:
        jimagenet.load(str(tmp_path), "train")
    assert str(got.value) == str(want.value)
