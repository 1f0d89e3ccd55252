"""Process-group bring-up, backend choice and teardown over
``torch.distributed`` (``ddp_tpu/runtime/dist.py:65-215``).

The reference's ``utils.py`` switch: nccl when the process runs on a
CUDA device, gloo on the CPU. Rendezvous is ``MASTER_ADDR`` /
``MASTER_PORT`` (a free local port when one process runs alone); each
rank pins its card (``torch.cuda.set_device``). A process group exists
at world 1 too, so the gradient average always goes through it. The data
axis is the only mesh this slice has: rank ``r`` of ``num_processes`` is
data shard ``r``.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading

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
) -> DistContext:
    """Bring up the process group and return its context.

    ``rank``/``world_size`` default to ``RANK``/``WORLD_SIZE`` (0 and 1);
    ``LOCAL_RANK`` (default: the rank) picks the card, modulo the cards
    present, unless ``device`` names one. ``backend=None``
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


class ThreadWorld:
    """A world of ``n`` ranks inside one process, one thread each, for
    checks that hold a data-parallel step against a multi-device
    reference without processes: ``reduce(rank)`` is that rank's
    :func:`all_reduce_sum`, adding the ranks' tensors in rank order, so
    every rank holds the same bits."""

    def __init__(self, n: int, timeout: float = 120.0):
        self.n, self.timeout = n, timeout
        self.barrier = threading.Barrier(n, timeout=timeout)
        self.slots = [None] * n

    def reduce(self, rank: int):
        def fn(t: torch.Tensor) -> torch.Tensor:
            self.slots[rank] = t.clone()
            self.barrier.wait()
            total = self.slots[0].clone()
            for other in self.slots[1:]:
                total += other
            self.barrier.wait()  # nobody overwrites a slot still being read
            return t.copy_(total)

        return fn

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank's thread → the results by rank; the
        first exception of any rank is raised here."""
        out, errs = [None] * self.n, []

        def body(rank):
            try:
                out[rank] = fn(rank)
            except Exception as e:  # re-raised below, in the caller
                errs.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout)
        if any(t.is_alive() for t in threads):
            raise TimeoutError(
                f"a rank of the thread world hung past {self.timeout} s")
        if errs:
            raise errs[0]
        return out
