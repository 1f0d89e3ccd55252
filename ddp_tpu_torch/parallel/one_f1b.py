"""1F1B (PipeDream-flush) with an O(S) activation stash
(``ddp_tpu/parallel/one_f1b.py``).

:func:`schedule_1f1b` is the JAX package's host simulator, copied: a
greedy prefer-backward policy where device d keeps at most S − d
microbatches in flight, which asserts the two transport invariants the
device program relies on (a cotangent hops exactly one slot a stage; at
most one unconsumed forward activation waits on a device). Its tables
are JAX's, entry for entry.

:func:`spmd_pipeline_1f1b` runs the table with ``parallel/pipeline``'s
executor in its hand-scheduled mode: a forward stashes its stage INPUT,
the backward slot rebuilds the stage from it (stage 0 from the raw
microbatch) and applies the received cotangent, and the loss runs inside
the last stage's backward. Stage S−1 also runs each forward, as JAX's
program does, whose output no one receives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ddp_tpu_torch.parallel.pipeline import (
    BWD,
    FWD,
    IDLE,
    StageFns,
    run_timetable,
)

# A deliberate fault for the controls: (stage, microbatch) whose backward
# consumes its cotangent and applies nothing (stage 0's, so no exchange
# goes missing).
FAULT: tuple[int, int] | None = None


class Schedule(NamedTuple):
    """Host-computed 1F1B timetable: ``op``/``mb`` [n_slots, S] int32 —
    what each device does a slot (0 idle, 1 forward, 2 backward) and on
    which microbatch."""

    op: np.ndarray
    mb: np.ndarray

    @property
    def n_slots(self) -> int:
        return self.op.shape[0]

    def bubble_fraction(self) -> float:
        """Measured idle fraction of the timetable."""
        return float((self.op == IDLE).sum()) / self.op.size


def schedule_1f1b(num_stages: int, num_microbatches: int) -> Schedule:
    """Greedy prefer-backward simulation of PipeDream-flush
    (``one_f1b.py:70``): device d keeps at most S − d microbatches in
    flight and takes a ready backward over a ready forward; the
    transport invariants are asserted."""
    S, M = num_stages, num_microbatches
    F_done = [[None] * S for _ in range(M)]
    B_done = [[None] * S for _ in range(M)]
    next_f, next_b = [0] * S, [0] * S
    ops, mbs = [], []
    t = 0
    while any(nb < M for nb in next_b):
        if t > 4 * (M + S) + 16:
            raise RuntimeError(f"1F1B schedule did not converge (S={S}, M={M})")
        row_op, row_mb = [IDLE] * S, [0] * S
        for d in range(S):
            m_b = next_b[d]
            can_b = m_b < M and (
                (d == S - 1 and F_done[m_b][d] is not None and F_done[m_b][d] < t)
                or (d < S - 1 and B_done[m_b][d + 1] is not None
                    and B_done[m_b][d + 1] < t)
            )
            m_f = next_f[d]
            can_f = (
                m_f < M
                and (d == 0 or (F_done[m_f][d - 1] is not None
                                and F_done[m_f][d - 1] < t))
                and m_f - next_b[d] < S - d
            )
            if can_b:
                row_op[d], row_mb[d] = BWD, m_b
                B_done[m_b][d] = t
                next_b[d] += 1
            elif can_f:
                row_op[d], row_mb[d] = FWD, m_f
                F_done[m_f][d] = t
                next_f[d] += 1
        ops.append(row_op)
        mbs.append(row_mb)
        t += 1
    # Transport invariant 1: cotangents hop exactly one slot.
    for m in range(M):
        for d in range(S - 1):
            assert B_done[m][d] == B_done[m][d + 1] + 1, (
                f"bwd({m},{d}) at {B_done[m][d]} != bwd({m},{d + 1}) "
                f"{B_done[m][d + 1]} + 1"
            )
    # Invariant 2: at most one unconsumed forward activation per device.
    for d in range(1, S):
        pending = []
        for m in range(M):
            pending.append((F_done[m][d - 1] + 1, F_done[m][d]))
        for (a1, c1), (a2, _) in zip(pending, pending[1:]):
            assert a2 > c1, (
                f"device {d}: activation for a later microbatch arrives at "
                f"{a2} before the previous one is consumed at {c1}"
            )
    return Schedule(np.asarray(ops, np.int32), np.asarray(mbs, np.int32))


def spmd_pipeline_1f1b(fns: StageFns, schedule: Schedule, *, comm, inputs,
                       labels, act_shape, act_dtype, device):
    """The combined forward and backward 1F1B timetable on this pipe rank
    (``one_f1b.py:139``) → (Σ loss, Σ aux) of the last stage's
    microbatches (zeros elsewhere); the gradients accumulate in the
    parameters, SUMS over the microbatches."""
    S = comm.size
    if S < 2:
        raise ValueError("1F1B needs a pipe axis of at least 2 stages")
    if schedule.op.shape[1] != S:
        raise ValueError(f"a timetable for {schedule.op.shape[1]} stages on "
                         f"a pipe of {S}")
    op, dropped = schedule.op, ()
    if FAULT is not None and FAULT[0] == comm.rank:
        stage, m = FAULT
        dropped = set(np.flatnonzero((op[:, stage] == BWD)
                                     & (schedule.mb[:, stage] == m)).tolist())
    return run_timetable(op, schedule.mb, np.zeros_like(op), fns, comm=comm,
                         inputs=inputs, labels=labels, act_shape=act_shape,
                         act_dtype=act_dtype, device=device, recompute=True,
                         dropped=dropped)
