"""Deterministic per-rank data sharding (``ddp_tpu/data/sampler.py``).

``DistributedSampler`` semantics as the reference uses them: a per-epoch
permutation keyed ``seed + epoch``, padded to a multiple of the shard
count by wrapping from its start, shard ``r`` taking the strided slice
``indices[r::num_shards]``.

The permutation source is pluggable. By default it is a CPU
``torch.Generator`` seeded ``seed + epoch`` (the same plan on every
rank); ``permutation=fn(epoch) -> indices`` replaces it. The JAX
package permutes with threefry, whose bits torch cannot reproduce, so
the tests pass JAX's own plan.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def default_permutation(n: int, seed: int):
    """``epoch -> randperm(n)`` from a CPU generator seeded ``seed +
    epoch`` (the same plan on every rank)."""

    def plan(epoch: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(seed + int(epoch))
        return torch.randperm(n, generator=g)

    return plan


def rescale_per_shard_batch(
    global_batch: int, num_shards: int, *, grad_accum_steps: int = 1
) -> int:
    """Per-shard batch that preserves ``global_batch`` over
    ``num_shards``: shard ``r`` of N takes ``indices[r::N]``, so one
    step's union of per-shard slices is the same window of the global
    permutation at any divisor world size. Raises when the global batch
    cannot tile the shards evenly with at least one example each."""
    denom = num_shards * max(1, grad_accum_steps)
    per = global_batch // denom
    if per < 1 or per * denom != global_batch:
        raise ValueError(
            f"elastic resize: global batch {global_batch} cannot be "
            f"preserved over {num_shards} shard(s)"
            + (
                f" x {grad_accum_steps} accumulation steps"
                if grad_accum_steps > 1
                else ""
            )
            + " — it must divide evenly with >= 1 example per shard"
        )
    return per


@dataclasses.dataclass(frozen=True)
class ShardSampler:
    """Index plan for one shard of a dataset across an epoch."""

    num_examples: int
    num_shards: int
    shard_id: int
    shuffle: bool = True
    seed: int = 0
    permutation: Callable | None = None  # epoch -> indices; None: default

    def __post_init__(self):
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(f"shard_id {self.shard_id} not in [0,{self.num_shards})")

    @property
    def total_size(self) -> int:
        """Dataset size padded up to a multiple of num_shards."""
        per = -(-self.num_examples // self.num_shards)  # ceil div
        return per * self.num_shards

    @property
    def shard_size(self) -> int:
        return self.total_size // self.num_shards

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """Global index order for ``epoch`` (before shard slicing)."""
        if self.shuffle:
            plan = self.permutation or default_permutation(
                self.num_examples, self.seed
            )
            perm = np.asarray(plan(epoch), dtype=np.int64)
        else:
            perm = np.arange(self.num_examples)
        pad = self.total_size - self.num_examples
        if pad:
            perm = np.concatenate([perm, perm[:pad]])
        return perm

    def shard_indices(self, epoch: int) -> np.ndarray:
        """This shard's sample indices for ``epoch`` (strided slice)."""
        return self.epoch_indices(epoch)[self.shard_id :: self.num_shards]

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        if drop_last:
            return self.shard_size // batch_size
        return -(-self.shard_size // batch_size)
