"""Per-rank sharded batching with a copy one batch ahead
(``ddp_tpu/data/loader.py``).

Each rank materialises only its shard (``ShardSampler`` over the world,
strided): for every batch it gathers its rows of the uint8 images on the
host into a pinned buffer and copies them to the device with
``non_blocking=True``, so batch ``i+1`` crosses the bus while step ``i``
runs. A small ring of pinned buffers, each reused only after a CUDA event
says its last copy has finished, keeps the host from overwriting a batch
in flight. On the CPU the gather is the batch.

``num_workers`` > 0 gathers with the native worker pool
(``native/dataio.cpp``, the C++ analogue of ``DataLoader(num_workers=N)``)
under the JAX loader's gate (``loader.py:44-60``): uint8 images, batches
of at least 1 MiB (:data:`ShardedLoader.POOL_MIN_BATCH_BYTES`; a 224²
batch of 7 images, never an MNIST or CIFAR one) and a spare core. On the
card the pool writes each batch straight into the ring's pinned buffer;
the batches are the Python gather's, byte for byte. ``pool_batches``
counts the batches the pool produced.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ddp_tpu_torch.data.sampler import ShardSampler

logger = logging.getLogger("ddp_tpu_torch")

_RING = 3  # pinned buffers: one being filled, one in flight, one in use


class Batch(NamedTuple):
    images: torch.Tensor  # [b, H, W, C] uint8 (or [b, T, d] float), on the device
    labels: torch.Tensor  # [b] int32, on the device


class ShardedLoader:
    """Deterministic, epoch-reshuffled batch stream of one rank's shard."""

    # Below this many bytes per local batch the native pool is turned
    # off: its hand-off costs more than the gather it takes over.
    POOL_MIN_BATCH_BYTES = 1 << 20

    @classmethod
    def pool_would_engage(cls, batch_bytes: int) -> bool:
        """The native-pool gate: big-enough batches AND a spare core."""
        return (batch_bytes >= cls.POOL_MIN_BATCH_BYTES
                and (os.cpu_count() or 1) >= 2)

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        global_batch_size: int,
        *,
        rank: int = 0,
        world: int = 1,
        device="cpu",
        shuffle: bool = True,
        seed: int = 0,
        permutation=None,
        num_workers: int = 0,
    ):
        if global_batch_size % world:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by {world} ranks"
            )
        self.images, self.labels = images, labels
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // world
        self.device = torch.device(device)
        self.sampler = ShardSampler(
            num_examples=len(images), num_shards=world, shard_id=rank,
            shuffle=shuffle, seed=seed, permutation=permutation,
        )
        self._pinned = self.device.type == "cuda"
        self._ring = []
        self.pool_batches = 0
        self._prefetcher = self._native_pool(num_workers)

    def _native_pool(self, num_workers: int):
        """The native prefetcher when ``num_workers`` asks for it and the
        gate lets it engage, else None (logged, as JAX's loader logs)."""
        if num_workers <= 0:
            return None
        if self.images.dtype != np.uint8:
            logger.warning(
                "num_workers=%d requested but the native pipeline is "
                "uint8-only (%s data); using Python gather",
                num_workers, self.images.dtype)
            return None
        batch_bytes = self.local_batch_size * int(
            np.prod(self.images.shape[1:]))
        if not self.pool_would_engage(batch_bytes):
            logger.info(
                "num_workers=%d auto-disabled: %d-byte batches, %s host "
                "cores (pool threshold: %d bytes and >1 core)",
                num_workers, batch_bytes, os.cpu_count(),
                self.POOL_MIN_BATCH_BYTES)
            return None
        from ddp_tpu_torch import native

        if not native.available():
            logger.warning(
                "num_workers=%d requested but native pipeline "
                "unavailable; using Python gather", num_workers)
            return None
        return native.NativePrefetcher(
            self.images, self.labels, self.local_batch_size,
            num_workers=num_workers)

    @property
    def pool_engaged(self) -> bool:
        return self._prefetcher is not None

    def steps_per_epoch(self) -> int:
        # The final partial batch is dropped (static shapes; the JAX
        # loader does the same).
        return self.sampler.shard_size // self.local_batch_size

    def _buffers(self, slot: int):
        """Ring slot ``slot`` (pinned image and label buffers, the event
        of its last copy), once that copy has left it."""
        if len(self._ring) <= slot:
            lb = self.local_batch_size
            img = torch.empty((lb, *self.images.shape[1:]),
                              dtype=torch.from_numpy(self.images[:0]).dtype,
                              pin_memory=True)
            lbl = torch.empty((lb,), dtype=torch.int32, pin_memory=True)
            self._ring.append([img, lbl, None])
        buf = self._ring[slot]
        if buf[2] is not None:
            buf[2].synchronize()  # its previous copy has left the buffer
            buf[2] = None
        return buf

    def _to_device(self, buf) -> Batch:
        img, lbl, _ = buf
        batch = Batch(img.to(self.device, non_blocking=True),
                      lbl.to(self.device, non_blocking=True))
        buf[2] = torch.cuda.Event()
        buf[2].record()
        return batch

    def _python_batches(self, idx: np.ndarray) -> Iterator[Batch]:
        lb = self.local_batch_size
        for b in range(len(idx) // lb):
            sel = idx[b * lb:(b + 1) * lb]
            if not self._pinned:
                yield Batch(torch.from_numpy(self.images[sel]),
                            torch.from_numpy(self.labels[sel]))
                continue
            buf = self._buffers(b % _RING)
            np.take(self.images, sel, axis=0, out=buf[0].numpy())
            np.take(self.labels, sel, axis=0, out=buf[1].numpy())
            yield self._to_device(buf)

    def _pool_batches(self, idx: np.ndarray) -> Iterator[Batch]:
        def into(b):  # the ring slot the pool writes batch b into
            img, lbl, _ = self._buffers(b % _RING)
            return img.numpy(), lbl.numpy()

        gen = self._prefetcher.epoch(idx, out=into if self._pinned else None)
        try:
            for b, (img, lbl) in enumerate(gen):
                self.pool_batches += 1
                if self._pinned:
                    yield self._to_device(self._ring[b % _RING])
                else:
                    yield Batch(torch.from_numpy(img), torch.from_numpy(lbl))
        finally:
            gen.close()  # an abandoned epoch drains the pool

    def epoch(self, epoch: int, skip_batches: int = 0) -> Iterator[Batch]:
        """This rank's batches for ``epoch``, each copied one batch ahead.

        ``epoch`` plays ``sampler.set_epoch(epoch)``'s role: the same order
        on re-runs, reshuffled per epoch. ``skip_batches`` drops a consumed
        prefix of the deterministic plan.
        """
        idx = self.sampler.shard_indices(epoch)
        idx = idx[skip_batches * self.local_batch_size:]
        source = (self._pool_batches(idx) if self._prefetcher is not None
                  else self._python_batches(idx))
        pending = None
        try:
            for nxt in source:
                if pending is not None:
                    yield pending
                pending = nxt
            if pending is not None:
                yield pending
        finally:
            source.close()

    def close(self) -> None:
        """Stop the native pool's threads (idempotent)."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None
