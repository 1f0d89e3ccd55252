"""Per-rank sharded batching with a copy one batch ahead
(``ddp_tpu/data/loader.py``).

Each rank materialises only its shard (``ShardSampler`` over the world,
strided): for every batch it gathers its rows of the uint8 images on the
host into a pinned buffer and copies them to the device with
``non_blocking=True``, so batch ``i+1`` crosses the bus while step ``i``
runs. A small ring of pinned buffers, each reused only after a CUDA event
says its last copy has finished, keeps the host from overwriting a batch
in flight. On the CPU the gather is the batch.

The JAX package's native worker pool (``native/dataio.cpp``) engages only
for batches of at least 1 MiB; an MNIST batch of 64 is 50 KB, so it is
not ported with this path.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from ddp_tpu_torch.data.sampler import ShardSampler

_RING = 3  # pinned buffers: one being filled, one in flight, one in use


class Batch(NamedTuple):
    images: torch.Tensor  # [b, H, W, C] uint8, on the device
    labels: torch.Tensor  # [b] int32, on the device


class ShardedLoader:
    """Deterministic, epoch-reshuffled batch stream of one rank's shard."""

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

    def steps_per_epoch(self) -> int:
        # The final partial batch is dropped (static shapes; the JAX
        # loader does the same).
        return self.sampler.shard_size // self.local_batch_size

    def _buffers(self, slot: int):
        if len(self._ring) <= slot:
            lb = self.local_batch_size
            img = torch.empty((lb, *self.images.shape[1:]), dtype=torch.uint8,
                              pin_memory=True)
            lbl = torch.empty((lb,), dtype=torch.int32, pin_memory=True)
            self._ring.append([img, lbl, None])
        return self._ring[slot]

    def _put(self, sel: np.ndarray, slot: int) -> Batch:
        if not self._pinned:
            return Batch(torch.from_numpy(self.images[sel]),
                         torch.from_numpy(self.labels[sel]))
        buf = self._buffers(slot)
        img, lbl, done = buf
        if done is not None:
            done.synchronize()  # its previous copy has left the buffer
        np.take(self.images, sel, axis=0, out=img.numpy())
        np.take(self.labels, sel, axis=0, out=lbl.numpy())
        batch = Batch(img.to(self.device, non_blocking=True),
                      lbl.to(self.device, non_blocking=True))
        buf[2] = torch.cuda.Event()
        buf[2].record()
        return batch

    def epoch(self, epoch: int, skip_batches: int = 0) -> Iterator[Batch]:
        """This rank's batches for ``epoch``, each copied one batch ahead.

        ``epoch`` plays ``sampler.set_epoch(epoch)``'s role: the same order
        on re-runs, reshuffled per epoch. ``skip_batches`` drops a consumed
        prefix of the deterministic plan.
        """
        idx = self.sampler.shard_indices(epoch)
        lb = self.local_batch_size
        idx = idx[skip_batches * lb:]
        pending = None
        for b in range(len(idx) // lb):
            nxt = self._put(idx[b * lb:(b + 1) * lb], b % _RING)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending
