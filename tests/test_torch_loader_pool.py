"""The port's loader with ``num_workers`` ≡ its Python gather, and the
JAX loader's pool gate, on the CPU.

The native pool (``ddp_tpu_torch/native``) must produce the batches of
the Python gather byte for byte (``tests/test_native.py::
test_sharded_loader_native_matches_python``'s check, on the port's
strided shards), a resumed epoch's (``skip_batches``) included; count
what it produced; engage only for uint8 batches of at least 1 MiB with a
spare core (``ShardedLoader.pool_would_engage`` ≡ JAX's); and log, as
JAX's loader does, when the gate turns it off.
"""

import logging
import os

import numpy as np
import pytest

from ddp_tpu.data.loader import ShardedLoader as JaxLoader
from ddp_tpu_torch.data.loader import ShardedLoader


@pytest.fixture
def two_cores(monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 4)  # a 1-core host: gate


def _data(n=96, side=128, seed=4):  # a batch of 32 is 1.5 MiB
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, side, side, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    return images, labels


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1)])
def test_pool_batches_equal_python_gather(two_cores, world, rank):
    images, labels = _data()
    kw = dict(rank=rank, world=world, seed=7)
    py = ShardedLoader(images, labels, 32 * world, num_workers=0, **kw)
    pool = ShardedLoader(images, labels, 32 * world, num_workers=2, **kw)
    assert pool.pool_engaged and not py.pool_engaged
    try:
        n = 0
        for epoch in range(2):
            for skip in (0, 1):
                got = list(pool.epoch(epoch, skip))
                want = list(py.epoch(epoch, skip))
                assert len(got) == len(want) == py.steps_per_epoch() - skip
                for g, w in zip(got, want):
                    assert g.images.dtype == w.images.dtype
                    assert np.array_equal(g.images.numpy(), w.images.numpy())
                    assert np.array_equal(g.labels.numpy(), w.labels.numpy())
                n += len(got)
        assert pool.pool_batches == n and py.pool_batches == 0
    finally:
        pool.close()


def test_abandoned_epoch_then_next(two_cores):
    images, labels = _data()
    pool = ShardedLoader(images, labels, 32, num_workers=2, seed=1)
    py = ShardedLoader(images, labels, 32, num_workers=0, seed=1)
    try:
        it = pool.epoch(0)
        next(it)
        it.close()  # a preemption's break: the pool drains
        got = [b.images.numpy() for b in pool.epoch(1)]
        want = [b.images.numpy() for b in py.epoch(1)]
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        assert len(got) == len(want) == 3
    finally:
        pool.close()
    pool.close()  # idempotent


@pytest.mark.parametrize("nbytes", [1 << 20, (1 << 20) - 1, 50_176])
@pytest.mark.parametrize("cores", [1, 2])
def test_gate_equals_jax(monkeypatch, nbytes, cores):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    assert ShardedLoader.POOL_MIN_BATCH_BYTES == JaxLoader.POOL_MIN_BATCH_BYTES
    assert (ShardedLoader.pool_would_engage(nbytes)
            == JaxLoader.pool_would_engage(nbytes))


def test_gate_off_is_logged(two_cores, caplog):
    """An MNIST batch (50 KB) and float data keep the Python gather, as
    JAX's loader does, and say so."""
    rng = np.random.default_rng(0)
    small = rng.integers(0, 256, size=(128, 28, 28, 1), dtype=np.uint8)
    labels = np.zeros(128, np.int32)
    with caplog.at_level(logging.INFO, logger="ddp_tpu_torch"):
        a = ShardedLoader(small, labels, 64, num_workers=2)
        b = ShardedLoader(small.astype(np.float32), labels, 64, num_workers=2)
    assert not a.pool_engaged and not b.pool_engaged
    text = caplog.text
    assert "auto-disabled: 50176-byte batches" in text
    assert "uint8-only" in text


def test_unavailable_native_is_logged(two_cores, monkeypatch, caplog):
    from ddp_tpu_torch import native

    monkeypatch.setattr(native, "available", lambda build=True: False)
    images, labels = _data()
    with caplog.at_level(logging.WARNING, logger="ddp_tpu_torch"):
        loader = ShardedLoader(images, labels, 32, num_workers=2)
    assert not loader.pool_engaged
    assert "native pipeline unavailable; using Python gather" in caplog.text
