"""Continuous-batching decode engine over fixed slots.

The PyTorch counterpart of ``ddp_tpu/serve/engine.py``'s fixed-lane
engine. It owns S decode **slots** — lanes of one ``SlotCache`` — and
every step:

1. retires finished and expired requests, evicts expired queued ones;
2. binds queue heads to free slots (FIFO, ``serve/scheduler.py``);
3. ingests prompt chunks (power-of-two buckets, Sarathi-style chunked
   prefill) within a per-step token budget, so running lanes never
   stall behind a long prompt;
4. advances ALL S lanes one token and samples each lane's next token
   on the device (``slot_decode_sample_step``; decode attention is the
   CUDA flash-decode kernel on the GPU);
5. reads back the PREVIOUS step's [S] token vector — the only
   steady-state device→host transfer, copied asynchronously into
   pinned memory when it was dispatched, so the host waits only for
   work it already queued a step ago.

Paged KV, prefix caching, speculative decoding, request tracing, SLOs,
compile introspection and hot-swap are features of the JAX engine that
later slices bring over.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ddp_tpu_torch.models.generate import (
    SlotCache,
    init_slot_cache,
    prefill_chunk,
    slot_decode_sample_step,
)
from ddp_tpu_torch.models.lm import CausalLM, LMSpec
from ddp_tpu_torch.ops import decode as decode_ops
from ddp_tpu_torch.serve.scheduler import (
    Admission,
    Request,
    Scheduler,
    next_pow2,
    prev_pow2,
)
from ddp_tpu_torch.utils.metrics import MetricsWriter, StatSummary

# Completion statuses.
COMPLETE = "complete"
TIMEOUT_EVICTED = "timeout_evicted"  # deadline hit while decoding
TIMEOUT_QUEUE = "timeout_queue"  # deadline hit while queued
REJECTED_TOO_LONG = "rejected_too_long"  # slipped past the front door


@dataclass
class Completion:
    """One finished request: everything the frontend returns. ``ttft``
    is None for requests that never produced a token."""

    rid: int
    status: str
    prompt: list[int]
    tokens: list[int]
    ttft: Optional[float]  # seconds, submit → first token observed
    decode_seconds: float  # first token → finish
    submitted: float
    finished: float
    queue_s: Optional[float] = None  # submit → lane bind

    @property
    def decode_tokens_per_s(self) -> float:
        n = len(self.tokens) - 1  # tokens after the prefill token
        return n / self.decode_seconds if self.decode_seconds > 0 else 0.0

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token (decode only); None before a second
        token."""
        n = len(self.tokens) - 1
        if n <= 0 or self.decode_seconds <= 0:
            return None
        return self.decode_seconds / n


@dataclass
class _Slot:
    """Host-side bookkeeping for one lane."""

    request: Optional[Request] = None
    tokens: list[int] = field(default_factory=list)
    # Tokens SCHEDULED on device for this request, including ones whose
    # values the host has not fetched yet.
    emitted: int = 0
    prefill_pos: int = 0  # prompt tokens ingested so far
    first_token_at: Optional[float] = None
    queue_s: Optional[float] = None

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        return (
            self.request is not None
            and self.prefill_pos < len(self.request.prompt)
        )

    @property
    def decoding(self) -> bool:
        return (
            self.request is not None
            and self.prefill_pos >= len(self.request.prompt)
        )


def drain_eta_s(retire_times: list[float], depth: int) -> Optional[float]:
    """Seconds until ``depth`` queued requests drain at the measured
    retirement rate; None when the window cannot support a rate."""
    if len(retire_times) < 2:
        return None
    span = retire_times[-1] - retire_times[0]
    if span <= 0:
        return None
    rate = (len(retire_times) - 1) / span
    return max(1, depth) / rate


def resolve_engine_knobs(
    spec: LMSpec,
    *,
    device: torch.device,
    slots: int = 4,
    prefill_len: Optional[int] = None,
    prefill_chunk: Optional[int] = None,
    min_bucket: Optional[int] = None,
    step_token_budget: Optional[int] = None,
    decode_attn: str = "auto",
    kv_dtype: str = "fp32",
) -> dict:
    """Validate + resolve the engine's knobs (the fixed-lane subset of
    the JAX rule set, same messages and defaults)."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    prefill_len = prefill_len or max(1, spec.total_len // 2)
    if not 0 < prefill_len <= spec.total_len - 1:
        raise ValueError(
            f"prefill_len {prefill_len} must leave room to decode "
            f"inside total_len {spec.total_len}"
        )
    if kv_dtype not in ("fp32", "int8"):
        raise ValueError(f"kv_dtype must be fp32|int8, got {kv_dtype!r}")
    # The path for this model's cache: ``auto`` takes the plain version
    # on the card where the kernel does not take the shape.
    shape = (spec.num_heads, spec.kv_heads, spec.head_dim,
             torch.int8 if kv_dtype == "int8" else torch.float32)
    resolved = decode_ops.resolve_impl(decode_attn, device, shape)
    chunk = next_pow2(
        prefill_chunk if prefill_chunk else min(next_pow2(prefill_len), 64)
    )
    # A chunk's write region must fit the cache at start 0, and the
    # smallest bucket must fit at ANY admissible start (max start =
    # prefill_len - 1), or a clamped write would shift over live lines.
    chunk = min(chunk, prev_pow2(spec.total_len))
    min_bucket = min(
        chunk,
        next_pow2(min_bucket) if min_bucket else min(8, chunk),
        prev_pow2(spec.total_len - prefill_len + 1),
    )
    step_token_budget = step_token_budget or chunk + slots
    if step_token_budget < min_bucket + slots:
        raise ValueError(
            f"step_token_budget {step_token_budget} cannot sustain "
            f"prefill progress: needs >= min_bucket ({min_bucket}) + "
            f"slots ({slots}) x decode tokens per lane (1)"
        )
    return {
        "prefill_len": prefill_len,
        "decode_attn": resolved,
        "decode_attn_requested": decode_attn,
        "kv_dtype": kv_dtype,
        "chunk": chunk,
        "min_bucket": min_bucket,
        "step_token_budget": step_token_budget,
    }


def _snapshot(t: torch.Tensor):
    """Copy a device value for a later host read. On the GPU the copy
    goes to pinned memory without blocking and an event marks its end;
    later in-place writes to ``t`` cannot reach it."""
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return host, event
    return t.clone(), None


class ServeEngine:
    """Fixed-slot continuous-batching engine for one ``CausalLM``.

    Runs on the model's device. ``decode_attn`` is ``auto`` (the CUDA
    flash-decode kernel on the GPU where it takes the model's head shape,
    the plain version elsewhere), ``flash`` or ``reference``; ``kv_dtype`` is ``fp32`` or ``int8``.
    The other knobs are the JAX engine's: ``slots``, ``prefill_len``
    (admission ceiling), ``prefill_chunk``, ``min_bucket``,
    ``step_token_budget``, ``max_queue``; ``clock`` is injectable.
    """

    def __init__(
        self,
        model: CausalLM,
        *,
        slots: int = 4,
        prefill_len: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        min_bucket: Optional[int] = None,
        step_token_budget: Optional[int] = None,
        max_queue: int = 64,
        metrics: Optional[MetricsWriter] = None,
        clock: Callable[[], float] = time.monotonic,
        decode_attn: str = "auto",
        kv_dtype: str = "fp32",
    ):
        spec = model.spec
        self.device = model.device
        knobs = resolve_engine_knobs(
            spec,
            device=self.device,
            slots=slots,
            prefill_len=prefill_len,
            prefill_chunk=prefill_chunk,
            min_bucket=min_bucket,
            step_token_budget=step_token_budget,
            decode_attn=decode_attn,
            kv_dtype=kv_dtype,
        )
        self.spec = spec
        self.model = model
        self.num_slots = slots
        self.prefill_len = knobs["prefill_len"]
        self.prefill_chunk = knobs["chunk"]
        self.min_bucket = knobs["min_bucket"]
        self.step_token_budget = knobs["step_token_budget"]
        self.decode_attn = knobs["decode_attn"]
        # Passed to every decode step: ``auto`` routes (and counts) per
        # call, as ops/decode.decode_attention does.
        self._attn_impl = knobs["decode_attn_requested"]
        self.kv_dtype = knobs["kv_dtype"]
        self.clock = clock
        self.metrics = metrics or MetricsWriter(None)
        self.scheduler = Scheduler(
            max_queue=max_queue,
            prefill_len=self.prefill_len,
            total_len=spec.total_len,
            vocab_size=spec.vocab_size,
            chunk=self.prefill_chunk,
            min_bucket=self.min_bucket,
            token_budget=self.step_token_budget,
            clock=clock,
        )
        self.buckets = self.scheduler.bucket_list()
        self._slots = [_Slot() for _ in range(slots)]
        dev = self.device
        self._cache: SlotCache = init_slot_cache(
            spec, slots,
            dtype=torch.int8 if self.kv_dtype == "int8" else torch.float32,
            device=dev,
        )
        # Device-resident decode state: the token vector (output of one
        # step, input to the next) and per-slot sampling state, written
        # at refill by the chunk path, never re-uploaded per step.
        self._toks = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._seeds = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._sample_steps = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._temps = torch.zeros(slots, dtype=torch.float32, device=dev)
        self._top_ps = torch.ones(slots, dtype=torch.float32, device=dev)
        # Dispatched values not yet read back:
        # ("first", snapshot, slot) | ("decode", snapshot, lanes).
        self._pending: list[tuple[str, tuple, object]] = []
        self._completed: dict[int, Completion] = {}
        self._started_at = clock()
        self._steps = 0
        self.decode_steps = 0  # fused decode+sample dispatches
        self.ttft = StatSummary()
        self.decode_rate = StatSummary()
        self.step_latency = StatSummary()
        self.queue_wait = StatSummary()
        self.tpot = StatSummary()
        self.tokens_emitted_total = 0
        self._retire_times: deque = deque(maxlen=32)
        self.reject_counts: dict[str, int] = {}
        self.status_counts: dict[str, int] = {}
        if self.decode_attn == "flash" and dev.type == "cuda":
            # Build the kernel now, not inside the first request.
            decode_ops.build()

    # ---- frontend surface ------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        timeout: Optional[float] = None,
    ) -> Admission:
        """Admission-checked enqueue; rejections carry a reason."""
        adm = self.scheduler.submit(
            prompt,
            max_new_tokens,
            temperature=temperature,
            top_p=top_p,
            seed=seed,
            timeout=timeout,
        )
        if not adm.accepted:
            self.reject_counts[adm.reason] = (
                self.reject_counts.get(adm.reason, 0) + 1
            )
            self.metrics.write(
                "serve_reject",
                reason=adm.reason,
                queue_depth=self.scheduler.depth,
            )
        return adm

    def result(self, rid: int) -> Optional[Completion]:
        return self._completed.get(rid)

    def pop_result(self, rid: int) -> Optional[Completion]:
        return self._completed.pop(rid, None)

    @property
    def active(self) -> int:
        return sum(1 for s in self._slots if not s.free)

    @property
    def pending(self) -> bool:
        return self.active > 0 or self.scheduler.depth > 0

    def cache_bytes_per_slot(self) -> int:
        return self._cache.nbytes() // self.num_slots

    def queue_drain_eta_s(self) -> Optional[float]:
        return drain_eta_s(list(self._retire_times), self.scheduler.depth)

    def stats(self) -> dict:
        """JSON-ready operational snapshot (the /stats endpoint)."""
        return {
            "slots": self.num_slots,
            "active": self.active,
            "queue_depth": self.scheduler.depth,
            "steps": self._steps,
            "decode_steps": self.decode_steps,
            "completed": len(self._completed),
            "tokens_total": self.tokens_emitted_total,
            "ttft_s": self.ttft.snapshot(),
            "tpot_s": self.tpot.snapshot(ndigits=6),
            "queue_s": self.queue_wait.snapshot(ndigits=6),
            "decode_tokens_per_s": self.decode_rate.snapshot(),
            "step_latency_s": self.step_latency.snapshot(ndigits=6),
            "rejects": dict(self.reject_counts),
            "requests_by_status": dict(self.status_counts),
            "prefill": {
                "chunk": self.prefill_chunk,
                "min_bucket": self.min_bucket,
                "buckets": list(self.buckets),
                "step_token_budget": self.step_token_budget,
            },
            "decode_path": {
                "attn_impl": self.decode_attn,
                "kv_dtype": self.kv_dtype,
                "cache_bytes_per_slot": self.cache_bytes_per_slot(),
            },
            "device": str(self.device),
        }

    # ---- engine loop ------------------------------------------------

    def step(self) -> int:
        """One engine iteration → number of tokens scheduled (see the
        module docstring for the order of its phases)."""
        now = self.clock()
        t_step = time.perf_counter()
        evictions = 0
        for slot in self._slots:
            req = slot.request
            if req is None:
                continue
            if slot.emitted >= req.max_new_tokens:
                self._drain()  # the completion needs its token values
                self._finish(slot, COMPLETE)
            elif req.expired(now):
                self._drain()
                self._finish(slot, TIMEOUT_EVICTED)
                evictions += 1
        for req in self.scheduler.evict_expired():
            c = Completion(
                rid=req.rid, status=TIMEOUT_QUEUE, prompt=req.prompt,
                tokens=[], ttft=None, decode_seconds=0.0,
                submitted=req.submitted, finished=self.clock(),
            )
            self._completed[req.rid] = c
            self._record_request(c)
            evictions += 1

        for slot in self._slots:
            if not slot.free or self.scheduler.depth == 0:
                continue
            req = self.scheduler.next_request()
            if req is None:
                break
            self._admit_to_slot(slot, req)

        prev_pending = self._pending
        self._pending = []
        produced = 0
        t_dispatch = time.perf_counter()

        prefilling = [
            (i, s.prefill_pos, len(s.request.prompt) - s.prefill_pos)
            for i, s in enumerate(self._slots)
            if s.prefilling
        ]
        # plan_chunks' FIFO contract is ADMISSION order, not slot order.
        prefilling.sort(key=lambda t: self._slots[t[0]].request.rid)
        decode_lanes = [i for i, s in enumerate(self._slots) if s.decoding]
        chunk_tokens = 0
        for i, width in self.scheduler.plan_chunks(
            prefilling, len(decode_lanes)
        ):
            slot = self._slots[i]
            req = slot.request
            start = slot.prefill_pos
            live = min(width, len(req.prompt) - start)
            final = start + live == len(req.prompt)
            buf = torch.zeros(width, dtype=torch.int64)
            buf[:live] = torch.as_tensor(req.prompt[start : start + live])
            first = prefill_chunk(
                self.model, self._cache, self._toks, self._seeds,
                self._sample_steps, self._temps, self._top_ps,
                i, buf.to(self.device), start, live, final,
                req.seed, req.temperature, req.top_p,
                # First chunk: self-contained causal attention; later
                # chunks attend the full lane under the banded mask.
                lane_attend=start != 0,
            )
            slot.prefill_pos = start + live
            chunk_tokens += live
            if final:
                slot.emitted = 1
                produced += 1
                self._pending.append(("first", _snapshot(first), i))
                decode_lanes.append(i)

        emit_lanes = [
            i
            for i in decode_lanes
            if self._slots[i].emitted < self._slots[i].request.max_new_tokens
        ]
        # Dispatch only when some lane will actually emit.
        if emit_lanes:
            reqs = [self._slots[i].request for i in emit_lanes]
            self._toks = slot_decode_sample_step(
                self.model, self._cache, self._toks, self._seeds,
                self._sample_steps, self._temps, self._top_ps,
                attn_impl=self._attn_impl,
                sampling=any(r.temperature > 0 for r in reqs),
                nucleus=any(r.temperature > 0 and r.top_p < 1 for r in reqs),
            )
            self.decode_steps += 1
            for i in emit_lanes:
                self._slots[i].emitted += 1
            self._pending.append(("decode", _snapshot(self._toks), emit_lanes))
            produced += len(emit_lanes)

        dispatch_s = time.perf_counter() - t_dispatch
        t_retire = time.perf_counter()
        self._drain(prev_pending)
        retire_s = time.perf_counter() - t_retire

        self._steps += 1
        self.tokens_emitted_total += produced
        self.step_latency.add(time.perf_counter() - t_step)
        self.metrics.write(
            "serve_step",
            step=self._steps,
            queue_depth=self.scheduler.depth,
            active_slots=self.active,
            slot_occupancy=round(self.active / self.num_slots, 4),
            evictions=evictions,
            tokens=produced,
            prefill_chunk_tokens=chunk_tokens,
            dispatch_s=round(dispatch_s, 6),
            retire_s=round(retire_s, 6),
        )
        return produced

    def run(self, *, max_steps: Optional[int] = None) -> list[Completion]:
        """Drive ``step()`` until idle (or ``max_steps``) → completions
        retired during this call, in finish order."""
        before = set(self._completed)
        steps = 0
        while self.pending and (max_steps is None or steps < max_steps):
            self.step()
            steps += 1
        return sorted(
            (c for r, c in self._completed.items() if r not in before),
            key=lambda c: c.finished,
        )

    # ---- internals --------------------------------------------------

    def _admit_to_slot(self, slot: _Slot, req: Request) -> str:
        """Bind a popped request to a lane → "bound" | "rejected"."""
        if len(req.prompt) > min(self.prefill_len, self.spec.total_len - 1):
            c = Completion(
                rid=req.rid, status=REJECTED_TOO_LONG, prompt=req.prompt,
                tokens=[], ttft=None, decode_seconds=0.0,
                submitted=req.submitted, finished=self.clock(),
            )
            self._completed[req.rid] = c
            self._record_request(c)
            return "rejected"
        slot.request = req
        slot.tokens = []
        slot.emitted = 0
        slot.prefill_pos = 0
        slot.first_token_at = None
        slot.queue_s = max(0.0, self.clock() - req.submitted)
        self.queue_wait.add(slot.queue_s)
        return "bound"

    def _drain(self, items: Optional[list] = None) -> int:
        """Read dispatched-but-unread token values → tokens appended.
        Each item is a decode step's [S] vector or a first-token scalar,
        never logits."""
        if items is None:
            items = self._pending
            self._pending = []
        appended = 0
        for kind, (host, event), meta in items:
            if event is not None:
                event.synchronize()
            vals = host.tolist()
            if kind == "first":
                slot = self._slots[meta]
                slot.tokens.append(int(vals))
                appended += 1
                slot.first_token_at = self.clock()
                if slot.request is not None:
                    self.ttft.add(slot.first_token_at - slot.request.submitted)
            else:
                for i in meta:
                    self._slots[i].tokens.append(int(vals[i]))
                    appended += 1
        return appended

    def _finish(self, slot: _Slot, status: str) -> None:
        req = slot.request
        now = self.clock()
        first = slot.first_token_at
        c = Completion(
            rid=req.rid,
            status=status,
            prompt=req.prompt,
            tokens=list(slot.tokens),
            ttft=(first - req.submitted) if first is not None else None,
            decode_seconds=(now - first) if first is not None else 0.0,
            submitted=req.submitted,
            finished=now,
            queue_s=slot.queue_s,
        )
        self._completed[req.rid] = c
        self._retire_times.append(now)
        if len(c.tokens) > 1:
            self.decode_rate.add(c.decode_tokens_per_s)
        if c.tpot_s is not None:
            self.tpot.add(c.tpot_s)
        self._record_request(c)
        slot.request = None
        slot.tokens = []
        slot.emitted = 0
        slot.prefill_pos = 0
        slot.first_token_at = None
        slot.queue_s = None

    def _record_request(self, c: Completion) -> None:
        self.status_counts[c.status] = self.status_counts.get(c.status, 0) + 1
        fields = dict(
            rid=c.rid,
            status=c.status,
            prompt_len=len(c.prompt),
            new_tokens=len(c.tokens),
            decode_tokens_per_s=round(c.decode_tokens_per_s, 2),
        )
        if c.ttft is not None:
            fields["ttft_s"] = round(c.ttft, 4)
        if c.queue_s is not None:
            fields["queue_s"] = round(c.queue_s, 6)
        if c.tpot_s is not None:
            fields["tpot_s"] = round(c.tpot_s, 6)
        self.metrics.write("serve_request", **fields)
