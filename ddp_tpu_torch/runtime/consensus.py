"""Cross-process agreement (``ddp_tpu/runtime/consensus.py``).

Rank-local signals (a SIGTERM that landed on one host, a watchdog close
to firing) must become a collective decision before anyone acts: the
actions (a checkpoint save, an epoch exit) are collectives themselves,
and a one-rank exit leaves every peer blocked in the next all-reduce.

``agree_any`` / ``agree_all`` are collective calls: every rank must
reach them the same number of times in the same order, at a
deterministic point (a fixed batch cadence, an epoch boundary). They
take a scalar flag or a flat sequence of flags, reduced elementwise, so
one call carries several decisions. Each is one
``torch.distributed.all_reduce`` (MAX for any, MIN for all) of a small
int32 tensor: on the card under nccl, on the CPU under gloo. A world of
one returns its flags and touches no collective.
"""

from __future__ import annotations

from typing import Sequence, overload

import torch
import torch.distributed as tdist


def _world() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def _reduce(flags: list[bool], op) -> list[bool]:
    device = (torch.device("cuda", torch.cuda.current_device())
              if tdist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                     device=device)
    tdist.all_reduce(t, op=op)
    return [bool(v) for v in t.tolist()]  # the agreement's one host read


def _agree(flags, op, num_processes):
    scalar = isinstance(flags, (bool, int))
    vec = [bool(flags)] if scalar else [bool(f) for f in flags]
    n = _world() if num_processes is None else num_processes
    agreed = vec if n <= 1 else _reduce(vec, op)
    return agreed[0] if scalar else agreed


@overload
def agree_any(flags: bool, *, num_processes: int | None = ...) -> bool: ...
@overload
def agree_any(
    flags: Sequence[bool], *, num_processes: int | None = ...
) -> list[bool]: ...


def agree_any(flags, *, num_processes=None):
    """Collective OR: True wherever any rank raised the flag. Scalar in,
    scalar out; a sequence in, an elementwise list out.
    ``num_processes`` overrides the process group's world size (the
    trainer passes its context's)."""
    return _agree(flags, tdist.ReduceOp.MAX, num_processes)


@overload
def agree_all(flags: bool, *, num_processes: int | None = ...) -> bool: ...
@overload
def agree_all(
    flags: Sequence[bool], *, num_processes: int | None = ...
) -> list[bool]: ...


def agree_all(flags, *, num_processes=None):
    """Collective AND: True only where every rank raised the flag."""
    return _agree(flags, tdist.ReduceOp.MIN, num_processes)
