"""Interleaved 1F1B: virtual pipeline stages cutting the bubble
(``ddp_tpu/parallel/interleaved.py``).

The model is cut into C = S·v chunks placed round-robin: chunk c lives on
pipe rank c mod S, so rank d holds chunks d, d + S, …, d + (v−1)·S (local
chunk k is global chunk k·S + d, the stacked layout [v, S, …]), and a
microbatch visits every rank v times, including the hop from S−1 back to
0. The pipe fills with v·M microbatch-chunks instead of M, so the bubble
shrinks toward (S−1)/(v·M+S−1).

The timetable is the JAX package's, copied: :func:`_device_op_sequence`
(Megatron's per-device order: warm-up forwards, 1B1F, cool-down) and
:func:`_simulate` (slot-synchronous, with the transport waits that make
the buffer depths a property of the table), tried shallow buffers first
by :func:`schedule_interleaved`. :func:`spmd_pipeline_interleaved` runs
it with ``parallel/pipeline``'s executor in its hand-scheduled mode, the
chunk index choosing the local chunk's parameters. The executor keys its
received tensors by (chunk, microbatch), so it needs no ring of
``ring_depth`` slots; the table's depths are kept, and checked equal to
JAX's, as what bounds the held activations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from ddp_tpu_torch.parallel.pipeline import (
    BWD,
    FWD,
    IDLE,
    StageFns,
    run_timetable,
)

# A deliberate fault for the controls: place chunks stage-major (chunk c
# on rank c // v) when a full state is cut into the ranks' chunks — it
# still trains, but computes another model (``chunk_of``).
FAULT: str | None = None


class InterleavedSchedule(NamedTuple):
    """Host-computed interleaved-1F1B timetable: ``op``/``mb``/``ck``
    [n_slots, S] int32 — per device per slot what to run (0 idle, 1
    forward, 2 backward), on which microbatch and which LOCAL chunk k
    (global chunk k·S + d); ``stash_depth`` and ``ring_depth``: the
    per-chunk buffer depths the table keeps within."""

    op: np.ndarray
    mb: np.ndarray
    ck: np.ndarray
    stash_depth: int
    ring_depth: int
    virtual_stages: int

    @property
    def n_slots(self) -> int:
        return self.op.shape[0]

    def bubble_fraction(self) -> float:
        """Measured idle fraction of the timetable."""
        return float((self.op == IDLE).sum()) / self.op.size


class _Deadlock(Exception):
    pass


def chunk_of(k: int, d: int, num_stages: int, virtual_stages: int) -> int:
    """The global chunk that pipe rank ``d`` holds as its local chunk
    ``k``: k·S + d (round-robin), or under :data:`FAULT` "stage_major"
    d·v + k."""
    if FAULT == "stage_major":
        return d * virtual_stages + k
    return k * num_stages + d


def _device_op_sequence(S: int, M: int, V: int) -> list[list[tuple]]:
    """The canonical Megatron interleaved op order per device
    (``interleaved.py:92``): forwards in groups of S microbatches, chunks
    ascending within a group; backwards mirror it with chunks descending;
    device d runs W = 2(S−d−1) + (v−1)S + 1 warm-up forwards, then strict
    1B1F, then cool-down backwards."""
    fo, bo = [], []
    for g in range(M // S):
        for k in range(V):
            for i in range(S):
                fo.append((g * S + i, k))
        for k in reversed(range(V)):
            for i in range(S):
                bo.append((g * S + i, k))
    seqs = []
    total = M * V
    for d in range(S):
        W = min((S - d - 1) * 2 + (V - 1) * S + 1, total)
        s = [(FWD, *fo[i]) for i in range(W)]
        fi, bi = W, 0
        while fi < total or bi < total:
            if bi < total:
                s.append((BWD, *bo[bi]))
                bi += 1
            if fi < total:
                s.append((FWD, *fo[fi]))
                fi += 1
        seqs.append(s)
    return seqs


def _simulate(S: int, M: int, V: int, Z: int, ring: int) -> InterleavedSchedule:
    """Slot-synchronous simulation of the canonical order with transport
    waits (``interleaved.py:132``); raises _Deadlock if the buffer depths
    cannot keep the order moving."""
    C = S * V
    seq = _device_op_sequence(S, M, V)
    ptr = [0] * S
    F_done = [[None] * C for _ in range(M)]
    pend_act = [[[None] * ring for _ in range(V)] for _ in range(S)]
    pend_cot = [[[None] * ring for _ in range(V)] for _ in range(S)]
    stash = [[set() for _ in range(V)] for _ in range(S)]

    ops, mbs, cks = [], [], []
    t = 0
    max_slots = 8 * (V * M + S) + 64
    while any(ptr[d] < len(seq[d]) for d in range(S)):
        if t > max_slots:
            raise _Deadlock(f"S={S} M={M} V={V} Z={Z} ring={ring}")
        row_op, row_mb, row_ck = [IDLE] * S, [0] * S, [0] * S
        effects = []  # arrivals land after every device chose
        for d in range(S):
            if ptr[d] >= len(seq[d]):
                continue
            opc, m, k = seq[d][ptr[d]]
            c = k * S + d
            if opc == FWD:
                if c > 0 and pend_act[d][k][m % ring] != m:
                    continue  # input not arrived yet
                if c > 0 and m % Z in stash[d][k]:
                    continue  # stash slot not yet freed
                if c < C - 1:
                    rd = (d + 1) % S
                    rk = k if d < S - 1 else k + 1
                    if pend_act[rd][rk][m % ring] is not None:
                        continue  # downstream ring slot still full
            else:
                if c == C - 1:
                    if not (F_done[m][c] is not None and F_done[m][c] < t):
                        continue
                elif pend_cot[d][k][m % ring] != m:
                    continue
                if c > 0:
                    rd = (d - 1) % S
                    rk = k if d > 0 else k - 1
                    if pend_cot[rd][rk][m % ring] is not None:
                        continue
            ptr[d] += 1
            row_op[d], row_mb[d], row_ck[d] = opc, m, k
            if opc == FWD:
                F_done[m][c] = t
                if c > 0:
                    pend_act[d][k][m % ring] = None  # consumed
                    stash[d][k].add(m % Z)
                if c < C - 1:
                    rd = (d + 1) % S
                    rk = k if d < S - 1 else k + 1
                    effects.append((pend_act, rd, rk, m))
            else:
                if c > 0:
                    stash[d][k].discard(m % Z)
                if c < C - 1:
                    pend_cot[d][k][m % ring] = None  # consumed
                if c > 0:
                    rd = (d - 1) % S
                    rk = k if d > 0 else k - 1
                    effects.append((pend_cot, rd, rk, m))
        for buf, rd, rk, m in effects:
            assert buf[rd][rk][m % ring] is None
            buf[rd][rk][m % ring] = m  # arrives end of slot t
        ops.append(row_op)
        mbs.append(row_mb)
        cks.append(row_ck)
        t += 1
    op_a = np.asarray(ops, np.int32)
    mb_a = np.asarray(mbs, np.int32)
    ck_a = np.asarray(cks, np.int32)
    for a in (op_a, mb_a, ck_a):  # the cached table is shared: read-only
        a.setflags(write=False)
    return InterleavedSchedule(op_a, mb_a, ck_a, Z, ring, V)


@functools.lru_cache(maxsize=64)
def schedule_interleaved(num_stages: int, num_microbatches: int,
                         virtual_stages: int) -> InterleavedSchedule:
    """Interleaved-1F1B timetable for S stages × v chunks, M microbatches
    (``interleaved.py:221``): (stash, ring) depths tried shallow-first,
    the first that completes returned."""
    S, M, V = num_stages, num_microbatches, virtual_stages
    if S < 2:
        raise ValueError("interleaved 1F1B needs a pipe axis of >= 2 stages")
    if V < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {V}")
    if M % S:
        raise ValueError(f"{M} microbatches not divisible by {S} stages")
    last = None
    for Z in (S, 2 * S, 4 * S, max(M, 1)):
        for ring in (2, 4):
            try:
                return _simulate(S, M, V, min(Z, max(M, 1)),
                                 min(ring, max(M, 1)))
            except _Deadlock as e:  # deepen the buffers and retry
                last = e
    raise RuntimeError(f"interleaved schedule did not converge: {last}")


def spmd_pipeline_interleaved(fns: StageFns, schedule: InterleavedSchedule,
                              *, comm, inputs, labels, act_shape, act_dtype,
                              device):
    """The combined forward and backward interleaved-1F1B timetable on this
    pipe rank (``interleaved.py:249``): ``fns.stage(k, x)`` runs local
    chunk k; chunk 0's front runs on rank 0, chunk C−1's back and loss on
    rank S−1 → (Σ loss, Σ aux); the gradients accumulate in the
    parameters, SUMS over the microbatches."""
    S = comm.size
    if S < 2:
        raise ValueError("interleaved 1F1B needs a pipe axis of >= 2 stages")
    if schedule.op.shape[1] != S:
        raise ValueError(f"a timetable for {schedule.op.shape[1]} stages on "
                         f"a pipe of {S}")
    return run_timetable(schedule.op, schedule.mb, schedule.ck, fns,
                         comm=comm, inputs=inputs, labels=labels,
                         act_shape=act_shape, act_dtype=act_dtype,
                         device=device, recompute=True,
                         virtual_stages=schedule.virtual_stages)
