"""The device mesh over ranks (``ddp_tpu/runtime/mesh.py``).

The JAX package lays its devices out as an N-D ``jax.sharding.Mesh``
whose named axes are the parallelism strategies. The port lays the
*ranks* of a ``torch.distributed`` world out the same way: rank ``r``
sits at the coordinates of ``r`` in the mesh's shape, axes in
:data:`AXIS_ORDER`, the innermost axis varying fastest — the device
placement ``make_mesh``'s reshape gives on CPU devices (``mesh.py:183``),
so a rank and the JAX device of the same index hold the same shard.

The axes (``mesh.py:10-39``): ``data`` shards the batch; ``fsdp``
shards the sequence models' parameters and moments (``parallel/seq_fsdp``)
and the batch too; ``expert`` shards MoE expert weights and the batch too
(a data axis for the dense layers); ``seq`` shards the tokens (ring or
Ulysses attention); ``model`` is Megatron tensor parallelism; ``pipe``
holds the stages of the pipelined models (``parallel/pipeline``): its
coordinate is the rank's stage, and activations and their cotangents
move point to point over its group. ``dcn`` is parsed and refused above
1, naming the ROADMAP item that brings it.

:class:`Mesh` answers where a rank sits and holds one communicator
(``runtime/dist``) for each group of axes a step reduces over: the
global ranks that share every other coordinate, in row-major order of
the group's own axes. :func:`dist_mesh` makes the subgroups with
``torch.distributed.new_group`` — every rank creates every slice's group,
in the same order, as ``new_group`` requires; a group of the whole world
is the default group — :func:`local_mesh` is one rank's, and
:func:`thread_mesh` makes them over a ``runtime/dist.ThreadWorld`` for
the tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

AXIS_ORDER = ("dcn", "pipe", "data", "fsdp", "expert", "seq", "model")
# Axes the port does not shard over yet, with the ROADMAP item that
# brings each.
REFUSED = {"dcn": "A4.2 (multi-slice, with MPMD)"}
# The groups of axes the steps reduce over: each axis alone (the ring,
# Megatron's f/g, the expert all-to-all, a sharded leaf's gather and
# reduce-scatter, ZeRO's bucket reduce-scatter over ``data``), the data
# axes (evaluation sums), the data axes with ``seq`` (replicated leaves'
# gradients and the step's metrics), and those less ``fsdp`` or
# ``expert`` (the gradients of leaves whose reduce-scatter or all-to-all
# already summed them over that axis), and ``pipe`` alone (the stages'
# point-to-point exchanges) and with ``data`` (the pipelined models'
# replicated ends: their gradients live on the end stages), with the
# batch axes and ``seq`` (the composed pipe step's ends, loss and count)
# and with ``seq`` (the pipelined LM's evaluation sums). A group's
# communicator is found by its axes of size above one.
GROUPS = (("seq",), ("model",), ("expert",), ("fsdp",), ("data",),
          ("pipe",), ("pipe", "data"),
          ("data", "fsdp", "expert"), ("data", "fsdp", "expert", "seq"),
          ("data", "expert", "seq"), ("data", "fsdp", "seq"),
          ("data", "seq"), ("pipe", "data", "fsdp", "expert", "seq"),
          ("pipe", "seq"))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; -1 on at most one axis means "all the rest".
    ``MeshSpec()`` is pure data parallelism (``mesh.py:49-83``)."""

    data: int = -1
    fsdp: int = 1
    expert: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    dcn: int = 1

    def resolve(self, num_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        bad = {a: s for a, s in sizes.items() if s < 1 and s != -1}
        if bad:
            raise ValueError(
                f"mesh axis sizes must be ≥ 1 (or -1 for 'the rest'): {bad}"
            )
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one -1 axis, got {unknown}")
        known = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if num_devices % known:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[unknown[0]] = num_devices // known
        elif known != num_devices:
            raise ValueError(f"mesh {sizes} needs {known} devices, have {num_devices}")
        return sizes


def check_supported(sizes: dict[str, int]) -> None:
    """Refuse an axis the port does not shard over yet, naming its item."""
    for axis, item in REFUSED.items():
        if sizes.get(axis, 1) > 1:
            raise ValueError(
                f"--mesh_{axis} {sizes[axis]}: the port does not shard over "
                f"the {axis!r} axis yet; it waits for ROADMAP {item}"
            )


def data_axes(mesh) -> tuple[str, ...]:
    """Axes over which the batch is sharded and gradients are averaged
    (``mesh.py:283``), of those the mesh has."""
    return tuple(a for a in ("dcn", "data", "fsdp", "expert")
                 if a in mesh.shape)


class Mesh:
    """The mesh of ``sizes`` (axis → size, every axis of
    :data:`AXIS_ORDER`) as rank ``rank`` sees it. ``comm_of(ranks)``
    builds the communicator of a group of global ranks; the groups of
    :data:`GROUPS` are built at construction, in one order on every
    rank."""

    def __init__(self, sizes: dict[str, int], rank: int,
                 comm_of: Callable[[list[int]], object] | None = None):
        self.shape = {a: int(sizes.get(a, 1)) for a in AXIS_ORDER}
        check_supported(self.shape)
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self._dims = tuple(self.shape[a] for a in AXIS_ORDER)
        self.coords = self.coords_of(rank)
        self._comms = {}
        if comm_of is not None:
            for axes in GROUPS:
                key = self._key(axes)
                if key not in self._comms:
                    self._comms[key] = comm_of(self.group_ranks(axes))

    def coords_of(self, rank: int) -> dict[str, int]:
        """Rank → {axis: index}, innermost axis fastest."""
        return dict(zip(AXIS_ORDER, (int(i) for i in
                                     np.unravel_index(rank, self._dims))))

    def rank_of(self, coords: dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in AXIS_ORDER), self._dims))

    def group_ranks(self, axes: Sequence[str], rank: int | None = None
                    ) -> list[int]:
        """The global ranks that share every coordinate of ``rank``
        (default: this one) outside ``axes``, ordered row-major over
        ``axes`` in :data:`AXIS_ORDER`."""
        base = self.coords_of(self.rank if rank is None else rank)
        axes = [a for a in AXIS_ORDER if a in axes]
        out = []
        for idx in np.ndindex(*(self.shape[a] for a in axes)):
            out.append(self.rank_of({**base, **dict(zip(axes, idx))}))
        return out

    def _key(self, axes) -> frozenset:
        return frozenset(a for a in axes if self.shape[a] > 1)

    def comm(self, *axes: str):
        """The communicator of the group over ``axes`` (one of
        :data:`GROUPS`, in any order, or one that equals one on this
        mesh: the axes of size one do not count)."""
        return self._comms[self._key(axes)]

    def seq_shard(self, x):
        """This rank's ``seq`` slice of dim 1 (the tokens) of ``x``."""
        n, r = self.shape["seq"], self.coords["seq"]
        T = x.shape[1]
        if T % n:
            raise ValueError(f"sequence length {T} not divisible by the seq "
                             f"axis size {n}")
        return x[:, r * (T // n):(r + 1) * (T // n)]

    @property
    def data_size(self) -> int:
        """Data replicas: the product of the data axes (data × fsdp ×
        expert)."""
        return math.prod(self.shape[a] for a in data_axes(self))

    @property
    def data_rank(self) -> int:
        """This rank's data replica, row-major over the data axes (the
        order JAX's batch sharding ``P(("data", "fsdp", "expert"))``
        takes)."""
        idx = 0
        for a in data_axes(self):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def mesh_sizes(world: int, *, seq: int = 1, model: int = 1, expert: int = 1,
               fsdp: int = 1, pipe: int = 1) -> dict[str, int]:
    """The axis sizes of a world: the named axes fixed, ``data`` the rest
    (raises when they do not tile the world)."""
    sizes = MeshSpec(data=-1, seq=seq, model=model, expert=expert,
                     fsdp=fsdp, pipe=pipe).resolve(world)
    check_supported(sizes)
    return sizes


def dist_mesh(sizes: dict[str, int], rank: int) -> Mesh:
    """The mesh of the running ``torch.distributed`` world: every rank
    calls this with the same ``sizes``; each group of :data:`GROUPS` over
    more than one rank is a ``new_group`` (made for every slice, in
    slice order, on every rank; the whole world's is the default
    group)."""
    import torch.distributed as tdist

    from ddp_tpu_torch.runtime.dist import DistComm, LocalComm

    probe = Mesh(sizes, rank)
    made = {}
    for axes in GROUPS:
        seen = set()
        for r in range(probe.size):
            ranks = tuple(probe.group_ranks(axes, r))
            if len(ranks) == 1 or ranks in seen or ranks in made:
                continue
            seen.add(ranks)
            made[ranks] = (tdist.group.WORLD if len(ranks) == probe.size
                           else tdist.new_group(list(ranks)))

    def comm_of(ranks):
        ranks = tuple(ranks)
        if len(ranks) == 1:
            return LocalComm()
        return DistComm(ranks, made[ranks], ranks.index(rank))

    return Mesh(sizes, rank, comm_of)


def local_mesh() -> Mesh:
    """The mesh of one rank: every axis of size one, every group a
    ``runtime/dist.LocalComm``."""
    from ddp_tpu_torch.runtime.dist import LocalComm

    return Mesh({}, 0, lambda ranks: LocalComm())


def thread_mesh(sizes: dict[str, int], world, rank: int) -> Mesh:
    """The mesh of rank ``rank`` of a ``runtime/dist.ThreadWorld``."""
    return Mesh(sizes, rank, lambda ranks: world.comm(ranks, rank))
