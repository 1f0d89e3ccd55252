"""ddp_tpu_torch's MNIST data path ≡ the JAX package's, on the CPU.

The IDX reader and the synthetic split are held byte for byte against
``ddp_tpu.data.mnist`` (on the vendored ``data/uci_digits``, the only
MNIST-family files in the repository; nothing here may download). The
sampler is fed JAX's own threefry permutation and must give the same
shard indices, padding by wrap included; the loader must deliver exactly
those rows. All comparisons are exact: this is integer data.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ddp_tpu.data import mnist as jmnist
from ddp_tpu.data import sampler as jsampler
from ddp_tpu_torch.data import mnist as tmnist
from ddp_tpu_torch.data import sampler as tsampler
from ddp_tpu_torch.data.loader import ShardedLoader
from ddp_tpu_torch.data.registry import NUM_CLASSES, load_dataset

REPO = Path(__file__).resolve().parent.parent
DATA = str(REPO / "data")


def jax_plan(n, seed):
    """JAX's un-padded epoch permutation, ``epoch -> indices``."""
    return jsampler.ShardSampler(n, 1, 0, seed=seed).epoch_indices


@pytest.mark.parametrize("split", ["train", "test"])
def test_uci_digits_idx_equals_jax(split):
    got = tmnist.load(DATA, split, variant="uci_digits")
    want = jmnist.load(DATA, split, variant="uci_digits")
    assert got.images.dtype == np.uint8 and got.labels.dtype == np.int32
    assert got.images.shape == want.images.shape == (
        (1437 if split == "train" else 360), 28, 28, 1)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_parse_idx_equals_jax_and_rejects_bad_headers():
    import gzip

    raw = gzip.decompress(
        (REPO / "data/uci_digits/t10k-labels-idx1-ubyte.gz").read_bytes())
    np.testing.assert_array_equal(tmnist.parse_idx(raw), jmnist.parse_idx(raw))
    for bad in (raw[:3], b"\x01" + raw[1:], raw[:2] + b"\x07" + raw[3:],
                raw[:-1]):
        with pytest.raises(ValueError):
            tmnist.parse_idx(bad)
        with pytest.raises(ValueError):
            jmnist.parse_idx(bad)


@pytest.mark.parametrize("num,seed", [(1, 0), (37, 0), (500, 1), (64, 9)])
def test_synthetic_equals_jax(num, seed):
    got, want = tmnist.synthetic(num, seed=seed), jmnist.synthetic(num, seed=seed)
    assert got.images.tobytes() == want.images.tobytes()
    assert got.labels.tobytes() == want.labels.tobytes()


def test_missing_files_raise_naming_the_path_unless_synthetic(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        tmnist.load(str(tmp_path), "train")
    with pytest.raises(FileNotFoundError, match="uci_digits"):
        tmnist.load(str(tmp_path), "test", variant="uci_digits")
    with pytest.raises(KeyError):
        tmnist.load(str(tmp_path), "train", variant="emnist")
    # The synthetic fallback and the registry's test split (n // 6),
    # against the JAX package's synthetic() (its loader would try a
    # download for mnist, so it is not called here).
    train, test = load_dataset("mnist", str(tmp_path), allow_synthetic=True,
                               synthetic_size=60)
    for got, want in ((train, jmnist.synthetic(60, seed=0)),
                      (test, jmnist.synthetic(10, seed=1))):
        assert got.images.tobytes() == want.images.tobytes()
        assert got.labels.tobytes() == want.labels.tobytes()
    train, test = load_dataset("uci_digits", DATA)
    assert (len(train.images), len(test.images)) == (1437, 360)
    assert NUM_CLASSES["mnist"] == NUM_CLASSES["uci_digits"] == 10


@pytest.mark.parametrize("n", [1, 7, 10, 33, 64])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_shard_sampler_fed_jax_plan_equals_jax(n, shards):
    for shard in range(shards):
        want = jsampler.ShardSampler(n, shards, shard, seed=3)
        got = tsampler.ShardSampler(n, shards, shard, seed=3,
                                    permutation=jax_plan(n, 3))
        assert (got.total_size, got.shard_size) == (want.total_size,
                                                    want.shard_size)
        for epoch in (0, 1, 5):
            np.testing.assert_array_equal(got.shard_indices(epoch),
                                          want.shard_indices(epoch))
        for bs in (1, 2, 5):
            for drop in (True, False):
                assert got.num_batches(bs, drop) == want.num_batches(bs, drop)


def test_unshuffled_sampler_equals_jax():
    for shard in range(3):
        got = tsampler.ShardSampler(10, 3, shard, shuffle=False)
        want = jsampler.ShardSampler(10, 3, shard, shuffle=False)
        np.testing.assert_array_equal(got.shard_indices(2),
                                      want.shard_indices(2))
    with pytest.raises(ValueError):
        tsampler.ShardSampler(10, 2, 2)


def test_default_permutation_is_seeded_by_epoch():
    n = 50
    shards = [tsampler.ShardSampler(n, 4, r, seed=4) for r in range(4)]
    a = shards[0].epoch_indices(0)
    np.testing.assert_array_equal(a, tsampler.ShardSampler(n, 4, 1, seed=4)
                                  .epoch_indices(0))
    assert not np.array_equal(a, shards[0].epoch_indices(1))
    assert not np.array_equal(a, tsampler.ShardSampler(n, 4, 0, seed=5)
                              .epoch_indices(0))
    # seed + epoch keying: (seed 4, epoch 1) is (seed 5, epoch 0).
    np.testing.assert_array_equal(
        shards[0].epoch_indices(1),
        tsampler.ShardSampler(n, 4, 0, seed=5).epoch_indices(0))
    union = np.concatenate([s.shard_indices(3) for s in shards])
    assert len(union) == 52 and set(union) == set(range(n))
    assert torch.equal(tsampler.default_permutation(n, 4)(0),
                       torch.as_tensor(a[:n]))


@pytest.mark.parametrize("gb,shards,accum", [
    (64, 1, 1), (64, 2, 1), (64, 4, 2), (96, 3, 1), (64, 3, 1), (8, 16, 1),
    (12, 2, 4),
])
def test_rescale_per_shard_batch_equals_jax(gb, shards, accum):
    try:
        want = jsampler.rescale_per_shard_batch(gb, shards,
                                                grad_accum_steps=accum)
    except ValueError:
        with pytest.raises(ValueError):
            tsampler.rescale_per_shard_batch(gb, shards, grad_accum_steps=accum)
        return
    assert tsampler.rescale_per_shard_batch(
        gb, shards, grad_accum_steps=accum) == want


@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_delivers_the_jax_shard_rows(world):
    """Each rank's batches are its JAX shard's rows in order, the final
    partial batch dropped; ``skip_batches`` drops a prefix."""
    data = jmnist.synthetic(45, seed=2)
    lb = 4
    for rank in range(world):
        loader = ShardedLoader(data.images, data.labels, lb * world,
                               rank=rank, world=world, seed=1,
                               permutation=jax_plan(45, 1))
        idx = jsampler.ShardSampler(45, world, rank, seed=1).shard_indices(2)
        batches = list(loader.epoch(2))
        assert len(batches) == loader.steps_per_epoch() == len(idx) // lb
        for b, batch in enumerate(batches):
            sel = idx[b * lb:(b + 1) * lb]
            np.testing.assert_array_equal(batch.images.numpy(), data.images[sel])
            np.testing.assert_array_equal(batch.labels.numpy(), data.labels[sel])
        tail = list(loader.epoch(2, skip_batches=2))
        assert len(tail) == len(batches) - 2
        assert torch.equal(tail[0].images, batches[2].images)
    with pytest.raises(ValueError):
        ShardedLoader(data.images, data.labels, 5, world=2)
