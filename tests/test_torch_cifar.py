"""ddp_tpu_torch's CIFAR data path ≡ the JAX package's, on the CPU.

The record parsers run on hand-built CIFAR-10 and CIFAR-100 bytes and on
a hand-built ``-binary`` tarball (the CIFAR files are not in the
repository, and nothing here may download: JAX's loader is only ever
given a tarball that exists, and its synthetic generator is called
directly). The synthetic split must be byte for byte JAX's for the same
seed and class count. All comparisons are exact: this is integer data.
"""

import io
import tarfile

import numpy as np
import pytest

from ddp_tpu.data import cifar as jcifar
from ddp_tpu.data.registry import NUM_CLASSES as JAX_NUM_CLASSES
from ddp_tpu_torch.data import cifar as tcifar
from ddp_tpu_torch.data.registry import NUM_CLASSES, load_dataset, load_split

LABEL_BYTES = {"cifar10": 1, "cifar100": 2}


def _records(name, n, seed):
    """n records of ``name``'s layout → (raw bytes, images NHWC, labels)."""
    rng = np.random.default_rng(seed)
    chw = rng.integers(0, 256, (n, 3, 32, 32), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES[name], (n, LABEL_BYTES[name]),
                          dtype=np.uint8)
    raw = np.concatenate([labels, chw.reshape(n, -1)], axis=1).tobytes()
    return raw, chw.transpose(0, 2, 3, 1), labels[:, -1].astype(np.int32)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_parse_records_equals_jax(name):
    raw, images, labels = _records(name, 7, seed=3)
    got = tcifar.parse_records(raw, name=name)
    want = jcifar.parse_records(raw, name=name)
    assert got.images.dtype == np.uint8 and got.labels.dtype == np.int32
    assert got.images.shape == (7, 32, 32, 3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    # Planar CHW → HWC, and CIFAR-100's label is the fine (second) byte.
    np.testing.assert_array_equal(got.images, images)
    np.testing.assert_array_equal(got.labels, labels)
    with pytest.raises(ValueError, match="not a multiple"):
        tcifar.parse_records(raw[:-1], name=name)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_tarball_splits_equal_jax(tmp_path, name):
    """A ``-binary`` tarball with every member file of both splits: the
    port's and JAX's loaders read the same splits from it."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for i, member in enumerate(tcifar._TRAIN_FILES[name]
                                   + tcifar._TEST_FILES[name]):
            raw, _, _ = _records(name, 3 + i, seed=i)
            info = tarfile.TarInfo(member)
            info.size = len(raw)
            tf.addfile(info, io.BytesIO(raw))
    (tmp_path / tcifar._TARS[name]).write_bytes(buf.getvalue())
    for split in ("train", "test"):
        got = tcifar.load(str(tmp_path), split, name=name)
        want = jcifar._load_split(str(tmp_path), name, split)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        one = load_split(name, str(tmp_path), split)
        np.testing.assert_array_equal(one.images, got.images)
    assert len(got.labels) == 3 + len(tcifar._TRAIN_FILES[name])  # the test file


@pytest.mark.parametrize("num,seed,classes", [
    (1, 0, 10), (37, 0, 10), (200, 1, 100), (64, 9, 100)])
def test_synthetic_equals_jax(num, seed, classes):
    got = tcifar.synthetic(num, seed=seed, num_classes=classes)
    want = jcifar.synthetic(num, seed=seed, num_classes=classes)
    assert got.images.dtype == np.uint8 and got.images.shape == (num, 32, 32, 3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_registry_synthetic_splits_as_jax_loads_them(tmp_path, name):
    """``load_dataset`` with --synthetic_data: the train split at seed 0,
    a test split of synthetic_size // 5 at seed 1, the dataset's class
    count — as ``ddp_tpu/data/cifar.load`` chooses them."""
    train, test = load_dataset(name, str(tmp_path), allow_synthetic=True,
                               synthetic_size=100)
    classes = JAX_NUM_CLASSES[name]
    assert NUM_CLASSES[name] == classes
    for got, n, seed in ((train, 100, 0), (test, 20, 1)):
        want = jcifar.synthetic(n, seed=seed, num_classes=classes)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
    assert set(np.unique(train.labels)) <= set(range(classes))


def test_missing_tarball_raises_and_names_its_path(tmp_path):
    for name in ("cifar10", "cifar100"):
        path = tmp_path / tcifar._TARS[name]
        with pytest.raises(FileNotFoundError, match=str(path)):
            tcifar.load(str(tmp_path), "train", name=name)
        with pytest.raises(FileNotFoundError, match="downloads nothing"):
            load_dataset(name, str(tmp_path))
    with pytest.raises(KeyError):
        tcifar.load(str(tmp_path), name="cifar1000", allow_synthetic=True)
