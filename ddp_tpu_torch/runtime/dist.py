"""Process-group bring-up, backend choice and teardown over
``torch.distributed`` (``ddp_tpu/runtime/dist.py:65-215``).

The reference's ``utils.py`` switch: nccl when the process runs on a
CUDA device, gloo on the CPU. Rendezvous is ``MASTER_ADDR`` /
``MASTER_PORT`` (a free local port when one process runs alone); each
rank pins its card (``torch.cuda.set_device``). A process group exists
at world 1 too, so the gradient average always goes through it. A pure
data-parallel world makes rank ``r`` of ``num_processes`` data shard
``r``; ``runtime/mesh`` lays the other axes (``seq``, ``model``,
``expert``) over the ranks and runs their collectives through the
communicators here.

A communicator is one axis slice's group seen from one rank: ``size``,
``rank`` (within the group), ``all_reduce_`` (a sum in place),
``all_gather(t, dim)``, ``reduce_scatter(t)`` (the sum over the group of
a flat tensor, of which member ``r`` keeps block ``r``: JAX's
``lax.psum_scatter(tiled=True)``; ``async_op=True`` returns a handle
whose ``wait()`` gives it), ``all_to_all(t, split_dim, concat_dim)`` (chunk
``i`` of ``split_dim`` goes to member ``i``; what member ``j`` sent lands
``j``-th along ``concat_dim``: ``lax.all_to_all(tiled=True)``) and
``shift(t, offset)`` (send to member ``rank + offset``, receive from
``rank - offset``, mod ``size``: ``lax.ppermute`` over a ring) and
``p2p(sends, recvs)`` (the pipeline's neighbour exchange: every
``(member, tag, tensor)`` of ``sends`` posted and every ``(member, tag,
shape, dtype, device)`` of ``recvs`` received, all at once, so that two
members that send to each other cannot deadlock; a send pairs with the
receive of the same tag from its sender, in the order both posted them;
a pipe has two stages or more, so a group of one has no ``p2p``).
:class:`LocalComm` is the group of one; :class:`DistComm` runs over a
``torch.distributed`` subgroup; ``ThreadWorld.comm`` over threads of one
process, for the tests. Under gloo a device tensor is staged through a
pinned host buffer for every collective (gloo's point-to-point and
all-to-all on CUDA tensors are not relied on); under nccl device tensors
go as they are. The reduce-scatter is nccl's ``reduce_scatter_tensor``;
under gloo it is written from ``all_to_all_single`` (member ``j`` sends
block ``r`` to member ``r``, which sums the ``n`` blocks in member order:
the bytes of a ring reduce-scatter, (n−1)/n of the tensor, and the same
bits on every backend), whatever gloo's own reduce-scatter takes.

Multi-host runs (``ddp_tpu/runtime/dist.py:94-170``) start each rank by
hand with ``coordinator_address`` (the rendezvous ``host:port``, which
rank 0 binds), ``num_processes`` (the world) and ``process_id`` (the
rank): :func:`multi_host_world` checks them as ``jax.distributed``
would, and a missing or inconsistent value raises rather than running a
world of one.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
from typing import Sequence

import torch
import torch.distributed as tdist

from ddp_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DistContext:
    backend: str  # "nccl" | "gloo", as the runtime resolved it
    process_id: int  # the rank: this process's data shard
    num_processes: int  # the world size
    device: torch.device
    coordinator_address: str | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that writes checkpoints and logs."""
        return self.process_id == 0


_ACTIVE: DistContext | None = None
_PICKS = 3  # tries of a free port for a world of one


def multi_host_world(coordinator_address: str | None,
                     num_processes: int | None,
                     process_id: int | None) -> tuple[str, int, int] | None:
    """The multi-host flags → (``host:port``, world, rank), or None when
    none of the three is given (a local run). Raises ValueError for a
    missing or inconsistent value: a world or a rank without an address,
    an address without both, a malformed address, a world below 1, a
    rank outside the world."""
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        return None
    missing = [flag for flag, v in zip(
        ("--coordinator_address", "--num_processes", "--process_id"), given)
        if v is None]
    if missing:
        raise ValueError(
            f"a multi-host rank needs --coordinator_address host:port, "
            f"--num_processes and --process_id; missing {missing}")
    host, sep, port = coordinator_address.rpartition(":")
    if not sep or not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"--coordinator_address must be host:port, got "
                         f"{coordinator_address!r}")
    if num_processes < 1:
        raise ValueError(f"--num_processes must be >= 1, got {num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is outside the world "
                         f"of --num_processes {num_processes}")
    return coordinator_address, num_processes, process_id


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def setup(
    rank: int | None = None,
    world_size: int | None = None,
    *,
    backend: str | None = None,
    device=None,
    coordinator_address: str | None = None,
) -> DistContext:
    """Bring up the process group and return its context.

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE`` (0 and 1);
    ``LOCAL_RANK`` (default: the rank) picks the card, modulo the cards
    present, unless ``device`` names one. ``coordinator_address``
    (``host:port``) is the rendezvous of a multi-host world, in place of
    ``MASTER_ADDR``/``MASTER_PORT``; the rank and world are then the
    caller's (:func:`multi_host_world`), and a rank whose card on its
    host is not its rank names it by ``LOCAL_RANK``. ``backend=None``
    chooses nccl on CUDA and gloo on the CPU; an explicit backend that
    the runtime resolves otherwise raises. nccl never puts two ranks on
    one card.
    """
    global _ACTIVE
    if tdist.is_initialized():
        raise RuntimeError("a process group is already up: call cleanup() first")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda" and device in (None, "cuda"):
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        if local_rank >= torch.cuda.device_count():
            raise ValueError(
                f"local rank {local_rank} has no card of its own "
                f"({torch.cuda.device_count()} present): nccl puts one rank "
                "on each card"
            )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is not None:
        addr, _, port = coordinator_address.rpartition(":")
    else:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
    if port is None and world > 1:
        raise ValueError(f"world {world} needs MASTER_ADDR/MASTER_PORT")
    # A port picked here (one process alone) can be taken by another
    # socket between free_port() and the store's bind: pick again.
    for attempt in range(_PICKS if port is None else 1):
        coordinator = f"{addr}:{port or free_port()}"
        try:
            tdist.init_process_group(want, init_method=f"tcp://{coordinator}",
                                     rank=rank, world_size=world)
            break
        except tdist.DistNetworkError as e:
            if port is not None or "EADDRINUSE" not in str(e) \
                    or attempt == _PICKS - 1:
                raise
    actual = tdist.get_backend()
    if backend is not None and actual != backend:
        tdist.destroy_process_group()
        raise RuntimeError(
            f"requested backend {backend!r} but torch.distributed resolved "
            f"{actual!r} — refusing to run on the wrong transport silently"
        )
    _ACTIVE = DistContext(actual, rank, world, dev, coordinator)
    return _ACTIVE


def current() -> DistContext:
    """The active context, bringing up a one-process group (on the GPU)
    if there is none."""
    return _ACTIVE if _ACTIVE is not None else setup()


def cleanup() -> None:
    """Tear the process group down (idempotent)."""
    global _ACTIVE
    _ACTIVE = None
    if tdist.is_initialized():
        tdist.destroy_process_group()


def sync_global_devices(tag: str = "") -> None:
    """Barrier over every rank (``dist.barrier()``); a no-op alone.
    ``tag`` names the barrier for readers of a hang."""
    del tag
    if tdist.is_initialized() and tdist.get_world_size() > 1:
        if tdist.get_backend() == "nccl":
            tdist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            tdist.barrier()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the world, in place; returns it."""
    tdist.all_reduce(t)
    return t


def world_comm(ctx: DistContext | None):
    """The communicator of the whole running world (a :class:`LocalComm`
    alone or without a process group)."""
    if ctx is None or ctx.num_processes == 1:
        return LocalComm()
    return DistComm(range(ctx.num_processes), tdist.group.WORLD,
                    ctx.process_id)


class LocalComm:
    """The communicator of a group of one rank: every collective is the
    identity (a copy where the group would return a new tensor)."""

    size, rank = 1, 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t.clone()

    def reduce_scatter(self, t: torch.Tensor, *, async_op: bool = False):
        return _done(t.clone(), async_op)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        return t.clone()

    def shift(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        return t.clone()


class _Done:
    """The handle of a collective that has already completed."""

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


def _done(value, async_op: bool):
    return _Done(value) if async_op else value


class _Pending:
    """The handle of an asynchronous collective: ``wait()`` waits for
    ``work`` and returns ``finish()``."""

    def __init__(self, work, finish):
        self.work, self.finish = work, finish

    def wait(self):
        self.work.wait()
        return self.finish()


def _blocks(t: torch.Tensor, n: int) -> torch.Tensor:
    """A flat tensor as [n, len/n], row ``r`` member ``r``'s block."""
    if t.dim() != 1 or t.numel() % n:
        raise ValueError(f"reduce_scatter: a flat tensor whose length "
                         f"divides by {n}, got {tuple(t.shape)}")
    return t.reshape(n, -1)


def _split_for_all_to_all(t: torch.Tensor, n: int, split_dim: int):
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks")
    return t.chunk(n, split_dim)


class DistComm:
    """One axis slice over ``torch.distributed``: ``ranks`` are the global
    ranks of the slice in member order, ``group`` its process group (made
    by ``new_group`` on every rank), ``rank`` this process's member index.
    Under gloo a CUDA tensor goes through a pinned host buffer (a blocking
    copy each way); under nccl it goes as it is."""

    def __init__(self, ranks: Sequence[int], group, rank: int):
        self.ranks, self.group = list(ranks), group
        self.size, self.rank = len(self.ranks), rank
        self.stage = tdist.get_backend(group) == "gloo"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        if self.stage and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t)
        return t.contiguous()

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        x = self._out(t)
        tdist.all_reduce(x, group=self.group)
        if x is not t:
            t.copy_(x)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        x = self._out(t)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        tdist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, *, async_op: bool = False):
        """This member's block of the sum of ``t`` (flat, its length a
        multiple of the group) over the group; a handle with
        ``async_op``."""
        blocks = _blocks(t, self.size)
        if not self.stage:  # nccl
            out = torch.empty_like(blocks[0])
            work = tdist.reduce_scatter_tensor(out, t.contiguous(),
                                               group=self.group,
                                               async_op=async_op)
            return _Pending(work, lambda: out) if async_op else out
        x = self._out(blocks)
        y = torch.empty_like(x)  # row j: member j's block of mine
        work = tdist.all_to_all_single(y, x, group=self.group,
                                       async_op=async_op)

        def finish():
            acc = y[0].clone()
            for j in range(1, self.size):
                acc += y[j]
            return acc.to(t.device)

        return _Pending(work, finish) if async_op else finish()

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        chunks = _split_for_all_to_all(t, self.size, split_dim)
        x = self._out(torch.stack(chunks))  # [n, ...], row i for member i
        y = torch.empty_like(x)
        tdist.all_to_all_single(y, x, group=self.group)
        return torch.cat(list(y.to(t.device).unbind(0)), concat_dim)

    def shift(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        x = self._out(t)
        y = torch.empty_like(x)
        dst = self.ranks[(self.rank + offset) % self.size]
        src = self.ranks[(self.rank - offset) % self.size]
        for work in tdist.batch_isend_irecv([
                tdist.P2POp(tdist.isend, x, dst),
                tdist.P2POp(tdist.irecv, y, src)]):
            work.wait()
        return y.to(t.device)

    def p2p(self, sends, recvs) -> list:
        """Post every send and receive as one batch, wait for all → the
        received tensors, in ``recvs``' order, on their devices. Under
        gloo a CUDA tensor goes through pinned host memory both ways."""
        ops, bufs = [], []
        for peer, tag, t in sends:
            ops.append(tdist.P2POp(tdist.isend, self._out(t),
                                   self.ranks[peer], self.group, tag))
        for peer, tag, shape, dtype, device in recvs:
            host = self.stage and torch.device(device).type == "cuda"
            buf = torch.empty(shape, dtype=dtype, pin_memory=host,
                              device="cpu" if host else device)
            ops.append(tdist.P2POp(tdist.irecv, buf, self.ranks[peer],
                                   self.group, tag))
            bufs.append((buf, device))
        if ops:
            for work in tdist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(dev) for b, dev in bufs]


class _Slots:
    """What the members of one in-process group share: a barrier and
    one slot a member."""

    def __init__(self, n: int, timeout: float):
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n
        self.timeout = timeout
        # Point to point: (sender, receiver, tag) → tensors in flight.
        self.mail: dict[tuple, list] = {}
        self.mail_cv = threading.Condition()
        self.aborted = False


class ThreadComm:
    """A communicator over threads of one process (``ThreadWorld.comm``):
    each collective posts this member's tensor, waits for every member,
    reads, and waits again before anyone posts the next one. Sums run in
    member order, so every member holds the same bits."""

    def __init__(self, shared: _Slots, rank: int):
        self._s, self.rank, self.size = shared, rank, len(shared.slots)

    def _exchange(self, value, read):
        s = self._s
        s.slots[self.rank] = value
        s.barrier.wait()
        out = read(s.slots)
        s.barrier.wait()  # nobody overwrites a slot still being read
        return out

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        def total(slots):
            acc = slots[0].clone()
            for other in slots[1:]:
                acc += other
            return acc

        return t.copy_(self._exchange(t.clone(), total))

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self._exchange(t.clone(), lambda slots: torch.cat(slots, dim))

    def reduce_scatter(self, t: torch.Tensor, *, async_op: bool = False):
        def mine(slots):
            acc = slots[0][self.rank].clone()
            for other in slots[1:]:
                acc += other[self.rank]
            return acc

        return _done(self._exchange(_blocks(t, self.size).clone(), mine),
                     async_op)

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        chunks = [c.clone() for c in
                  _split_for_all_to_all(t, self.size, split_dim)]
        return self._exchange(chunks, lambda slots: torch.cat(
            [slots[j][self.rank] for j in range(self.size)], concat_dim))

    def shift(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        return self._exchange(
            t.clone(),
            lambda slots: slots[(self.rank - offset) % self.size].clone())

    def p2p(self, sends, recvs) -> list:
        """Sends go to the receivers' mailboxes at once (they never
        block); each receive waits for its sender's tensor, and fails the
        run past the world's timeout instead of hanging it."""
        s, out = self._s, []
        with s.mail_cv:
            for peer, tag, t in sends:
                s.mail.setdefault((self.rank, peer, tag), []).append(
                    t.detach().clone())
            s.mail_cv.notify_all()
        for peer, tag, *_ in recvs:
            key = (peer, self.rank, tag)
            with s.mail_cv:
                if not s.mail_cv.wait_for(
                        lambda: s.aborted or s.mail.get(key), s.timeout):
                    raise TimeoutError(
                        f"member {self.rank}: no tensor from member {peer} "
                        f"(tag {tag}) within {s.timeout} s")
                if s.aborted and not s.mail.get(key):
                    raise RuntimeError("the thread world was aborted")
                out.append(s.mail[key].pop(0))
        return out


class ThreadWorld:
    """A world of ``n`` ranks inside one process, one thread each, for
    checks that hold a parallel step against a multi-device reference
    without processes: ``reduce(rank)`` is that rank's
    :func:`all_reduce_sum`, adding the ranks' tensors in rank order, so
    every rank holds the same bits; ``comm(ranks, rank)`` is the
    communicator of the group of global ``ranks`` (one shared group per
    list) as member ``rank`` sees it. A barrier that waits past
    ``timeout`` fails the run instead of hanging it."""

    def __init__(self, n: int, timeout: float = 120.0):
        self.n, self.timeout = n, timeout
        self._groups: dict[tuple, _Slots] = {}
        self._lock = threading.Lock()

    def comm(self, ranks: Sequence[int], rank: int):
        """The communicator of global ``ranks`` for global ``rank``
        (:class:`LocalComm` for a group of one)."""
        ranks = tuple(ranks)
        if len(ranks) == 1:
            return LocalComm()
        with self._lock:
            shared = self._groups.get(ranks)
            if shared is None:
                shared = self._groups[ranks] = _Slots(len(ranks), self.timeout)
        return ThreadComm(shared, ranks.index(rank))

    def reduce(self, rank: int):
        """Rank ``rank``'s sum over the whole world, in place."""
        return self.comm(range(self.n), rank).all_reduce_

    def _abort(self) -> None:
        with self._lock:
            for g in self._groups.values():
                g.barrier.abort()
                with g.mail_cv:
                    g.aborted = True
                    g.mail_cv.notify_all()

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank's thread → the results by rank; the
        first exception of any rank is raised here."""
        out, errs = [None] * self.n, []

        def body(rank):
            try:
                out[rank] = fn(rank)
            except Exception as e:  # re-raised below, in the caller
                errs.append(e)
                self._abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout)
        if any(t.is_alive() for t in threads):
            self._abort()
            raise TimeoutError(
                f"a rank of the thread world hung past {self.timeout} s")
        if errs:
            raise errs[0]
        return out
