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

With ``spec_tokens`` γ > 0 (speculative decoding) step 4 becomes a
ROUND: a draft model proposes γ greedy tokens per lane (γ
``slot_decode_step`` calls on its own fixed-lane fp32 cache, the
flash-decode kernel B4 on the GPU), and ``slot_verify_step`` scores
them in one target step. Each lane emits its accepted prefix plus the
target's correction, 1..γ tokens, and the streams are exactly the
non-speculative ones. The emit counts are data-dependent, so the host
reads the round's [S, γ] tokens and [S] match counts in the same step
(this step's first-token scalars first, to keep each stream in order).

With ``page_size`` > 0 the cache is paged (``PagedSlotCache``): K/V
live in a pool of pages that lanes map through int32 page tables, and a
radix prefix index (``serve/pages.PrefixCache``) lets prompts that share
a prefix prefill it once and map its pages copy-free. Admission then
counts free pages; the decode attention reads the pool through the
tables (the paged CUDA kernel on the GPU).

The model lifecycle (``engine.py:977-1048``): ``pause_admission``
holds queued requests in the queue (nothing is dropped) while bound
lanes decode to completion, and ``install_params`` swaps the serving
weights in place at that barrier (``serve/lifecycle.py`` verifies the
checkpoint first, ``serve/server.py`` runs the whole reload). Each
completion carries the ``model_version`` it was served under.

Observability (``ddp_tpu_torch/obs``), all off by default: a span
``tracer`` whose measuring mode waits on the engine's stream before it
closes each ``serve.prefill_chunk`` / ``serve.decode`` /
``serve.spec_verify`` / ``serve.sample`` span (so spans cover device
work, and the dispatch/retire overlap is given up); per-request tracing
(``reqtrace``: events stamped only where the engine already touches the
host, so it adds no device wait); an ``SLOEngine`` fed by every retired
request; and a flight recorder that receives SLO breach records.

The compile contract (``serve/programs.py``): every step's device
work is one program of a bounded set — the fused decode+sample program,
a first-chunk and a continuation-chunk program per bucket width, and
with speculation the draft's chunk programs, one draft-decode and one
verify program — over static inputs and engine-owned state. On the card
each program is a captured CUDA graph (``cuda_graphs=False`` runs the
same functions eagerly); ``warmup()`` prepares the whole set on an idle
engine, ``compile_counts()`` and ``compile_budget()`` keep the JAX
engine's keys and counts, and no request mix adds a program after
warmup. A graph reads every tensor at the address it had at capture:
weights change only by an in-place copy (``install_params``), and no
engine state is ever rebound.

The page export/install of disaggregated serving is a feature of the
JAX engine that a later slice brings over.
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ddp_tpu_torch.models.generate import (
    init_paged_slot_cache,
    init_slot_cache,
    prefill_chunk_device,
    slot_decode_sample_step,
    slot_decode_step,
    slot_verify_step,
)
from ddp_tpu_torch.models.lm import CausalLM, LMSpec
from ddp_tpu_torch.obs.recorder import FlightRecorder, build_info
from ddp_tpu_torch.obs.reqtrace import RequestTracer, parse_trace_context
from ddp_tpu_torch.obs.tracer import Tracer
from ddp_tpu_torch.ops import decode as decode_ops
from ddp_tpu_torch.serve.pages import PrefixCache, page_demand
from ddp_tpu_torch.serve.programs import ProgramSet
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
    # Paged engines: prompt tokens served from cached prefix pages (0 =
    # a miss); None on fixed-lane engines.
    prefix_hit_tokens: Optional[int] = None
    # Speculative engines: the fraction of this request's draft tokens
    # the target accepted; None when no verify round ran for it.
    spec_acceptance: Optional[float] = None
    # The serving weights' label (None on an engine that has none).
    model_version: Optional[str] = None
    # Request tracing: the per-completion digest (RequestTrace.summary);
    # None when tracing is off.
    trace: Optional[dict] = None

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

    index: int = -1
    request: Optional[Request] = None
    tokens: list[int] = field(default_factory=list)
    # Tokens SCHEDULED on device for this request, including ones whose
    # values the host has not fetched yet.
    emitted: int = 0
    prefill_pos: int = 0  # prompt tokens ingested so far
    first_token_at: Optional[float] = None
    queue_s: Optional[float] = None
    # Paged mode: the page ids the lane's table maps (prefix + private,
    # in position order) and the prompt tokens its prefix hit covered.
    pages: list[int] = field(default_factory=list)
    matched_tokens: int = 0
    # Speculative rounds: draft tokens proposed for / accepted by this
    # request.
    spec_drafted: int = 0
    spec_accepted: int = 0

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
    page_size: int = 0,
    kv_pages: Optional[int] = None,
    spec_tokens: int = 0,
    draft_spec: Optional[LMSpec] = None,
) -> dict:
    """Validate + resolve the engine's knobs (the JAX rule set, same
    messages and defaults; ``draft_spec`` is the draft model's)."""
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
    if kv_pages is not None and not page_size:
        raise ValueError(
            "--kv_pages needs --page_size (the page pool only "
            "exists in paged mode)"
        )
    paged = bool(page_size)
    page_size = int(page_size)
    lane_pages = resolved_kv_pages = None
    if paged:
        if page_size < 1 or (page_size & (page_size - 1)):
            raise ValueError(
                f"--page_size must be a power of two, got {page_size}"
            )
        if spec.total_len % page_size:
            raise ValueError(
                f"--page_size {page_size} must divide the model's "
                f"total_len {spec.total_len}: a partial tail page "
                "would break the page-granular tail-chunk "
                "invariant (every chunk write maps through whole "
                "pages)"
            )
        lane_pages = spec.total_len // page_size
        # Capacity-neutral default: the fixed-lane layout's lines plus
        # the scratch page, so any sharing is headroom.
        resolved_kv_pages = int(
            kv_pages if kv_pages is not None else slots * lane_pages + 1
        )
        if resolved_kv_pages < lane_pages + 1:
            raise ValueError(
                f"--kv_pages {resolved_kv_pages} cannot hold one "
                f"full-context lane: needs >= total_len/"
                f"--page_size + 1 scratch = {lane_pages + 1}"
                " (a maximal request could never bind — permanent "
                "queue head starvation)"
            )
    if spec_tokens:
        if spec_tokens < 1:
            raise ValueError(f"spec_tokens must be >= 1, got {spec_tokens}")
        if draft_spec is None:
            raise ValueError(
                "speculative decoding needs a draft_model alongside "
                "spec_tokens"
            )
        if draft_spec.vocab_size != spec.vocab_size:
            raise ValueError(
                f"draft vocab {draft_spec.vocab_size} != target "
                f"vocab {spec.vocab_size}"
            )
        if draft_spec.total_len != spec.total_len:
            raise ValueError(
                f"draft total_len {draft_spec.total_len} != target "
                f"total_len {spec.total_len} (the caches track the "
                "same positions)"
            )
        if spec_tokens >= spec.total_len - prefill_len:
            raise ValueError(
                f"spec_tokens {spec_tokens} leaves no decode room "
                f"past prefill_len {prefill_len} in total_len "
                f"{spec.total_len}"
            )
    spec_tokens = int(spec_tokens)
    # Admission context ceiling: the verify round's K-1 reserve comes off
    # the budget check, never the cache geometry.
    ctx_len = spec.total_len - max(0, spec_tokens - 1)
    # Decode-path tokens dispatched per running lane per step: 1 plain,
    # γ under speculation (the verify step runs γ positions a lane).
    tokens_per_decode = max(1, spec_tokens)
    # The path for this model's cache: ``auto`` takes the plain version
    # on the card where the kernel does not take the shape.
    shape = (spec.num_heads, spec.kv_heads, spec.head_dim,
             torch.int8 if kv_dtype == "int8" else torch.float32)
    resolved = decode_ops.resolve_impl(decode_attn, device, shape)
    # The draft decodes on its own fixed-lane fp32 cache: its own shape
    # (an explicit ``flash`` the kernel cannot take raises here too).
    draft_resolved = None
    if spec_tokens:
        draft_resolved = decode_ops.resolve_impl(
            decode_attn, device,
            (draft_spec.num_heads, draft_spec.kv_heads, draft_spec.head_dim,
             torch.float32))
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
    step_token_budget = step_token_budget or chunk + slots * tokens_per_decode
    if step_token_budget < min_bucket + slots * tokens_per_decode:
        raise ValueError(
            f"step_token_budget {step_token_budget} cannot sustain "
            f"prefill progress: needs >= min_bucket ({min_bucket}) + "
            f"slots ({slots}) x decode tokens per lane "
            f"({tokens_per_decode})"
        )
    return {
        "prefill_len": prefill_len,
        "decode_attn": resolved,
        "decode_attn_requested": decode_attn,
        "kv_dtype": kv_dtype,
        "chunk": chunk,
        "min_bucket": min_bucket,
        "step_token_budget": step_token_budget,
        "paged": paged,
        "page_size": page_size,
        "lane_pages": lane_pages,
        "kv_pages": resolved_kv_pages,
        "spec_tokens": spec_tokens,
        "draft_decode_attn": draft_resolved,
        "ctx_len": ctx_len,
        "tokens_per_decode": tokens_per_decode,
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


def _upload(dst: torch.Tensor, host: torch.Tensor) -> None:
    """Copy a host tensor into a static device buffer. On the GPU it
    goes through pinned memory without blocking (the allocator keeps the
    pinned block until the copy has run), ordered on the stream before
    the programs that read ``dst``."""
    if dst.device.type == "cuda":
        dst.copy_(host.pin_memory(), non_blocking=True)
    else:
        dst.copy_(host)


class ServeEngine:
    """Fixed-slot continuous-batching engine for one ``CausalLM``.

    Runs on the model's device. ``decode_attn`` is ``auto`` (the CUDA
    flash-decode kernel on the GPU where it takes the model's head shape,
    the plain version elsewhere), ``flash`` or ``reference``; ``kv_dtype`` is ``fp32`` or ``int8``.
    The other knobs are the JAX engine's: ``slots``, ``prefill_len``
    (admission ceiling), ``prefill_chunk``, ``min_bucket``,
    ``step_token_budget``, ``max_queue``; ``clock`` is injectable.

    ``page_size`` > 0 (a power of two dividing ``total_len``) makes the
    cache paged: a pool of ``kv_pages`` pages (default slots ·
    total_len/page_size + 1, the fixed-lane capacity plus the scratch
    page), lanes mapping pages through an int32 table, and a radix
    prefix index whose hits skip the matched tokens' prefill. Greedy
    streams stay token-identical to the fixed-lane engine.

    ``spec_tokens`` γ > 0 with a ``draft_model`` (same vocab and
    total_len, on the target's device) turns on speculative decoding:
    γ draft proposals and one batched verify per step, with each stream
    exactly the non-speculative one. The draft keeps its own fixed-lane
    fp32 cache whatever the target's is; admission keeps γ-1 positions
    (and on a paged engine their pages) in reserve for the verify
    writes. On a prefix hit the draft lane is not prefilled over the
    matched tokens: that can lower acceptance there, never change a
    token.

    Observability, as the JAX engine's: ``tracer`` (an enabled
    ``obs.tracer.Tracer`` turns on the measuring mode of the module
    docstring), ``reqtrace`` with ``reqtrace_keep`` retired timelines
    (``request_timeline``, ``emit_request_spans``), ``trace_seed`` for
    the trace ids (default os.urandom; ids equal the JAX engine's for
    the same seed and rid), ``slo`` (an ``obs.slo.SLOEngine``; its
    breaches become ``slo_breach`` records in ``metrics`` and in
    ``recorder``, an ``obs.recorder.FlightRecorder``).

    ``cuda_graphs`` (default True) captures each step program as a CUDA
    graph on the card; False runs the same programs eagerly (always the
    case on the CPU). See the module docstring's compile contract.
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
        page_size: int = 0,
        kv_pages: Optional[int] = None,
        spec_tokens: int = 0,
        draft_model: Optional[CausalLM] = None,
        model_version: Optional[str] = None,
        tracer: Optional[Tracer] = None,
        reqtrace: bool = False,
        reqtrace_keep: int = 512,
        trace_seed: Optional[int] = None,
        slo=None,
        recorder: Optional[FlightRecorder] = None,
        cuda_graphs: bool = True,
    ):
        spec = model.spec
        self.device = model.device
        if (spec_tokens and draft_model is not None
                and draft_model.device != self.device):
            raise ValueError(
                f"draft model on {draft_model.device} but the target on "
                f"{self.device}: build the draft on the target's device"
            )
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
            page_size=page_size,
            kv_pages=kv_pages,
            spec_tokens=spec_tokens,
            draft_spec=draft_model.spec if draft_model is not None else None,
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
        self.paged = knobs["paged"]
        self.page_size = knobs["page_size"]
        self.kv_pages = knobs["kv_pages"]
        self._lane_pages = knobs["lane_pages"]
        self.spec_tokens = knobs["spec_tokens"]
        self.draft_model = draft_model if self.spec_tokens else None
        self.draft_decode_attn = knobs["draft_decode_attn"]
        self._tokens_per_decode = knobs["tokens_per_decode"]
        self.clock = clock
        self.metrics = metrics or MetricsWriter(None)
        # Span tracing: disabled by default and free when off; enabled,
        # each span waits on the engine's stream before it closes.
        self.tracer = tracer or Tracer()
        # Trace ids: deterministic when the caller seeds them, apart
        # across replicas when left to entropy.
        if trace_seed is None:
            trace_seed = int.from_bytes(os.urandom(8), "little")
        # Request tracing: every recording site guards on one ``is not
        # None`` check, so a disabled engine keeps no per-request state.
        self._reqtrace = (
            RequestTracer(keep=reqtrace_keep) if reqtrace else None)
        # Inbound trace contexts adopted (valid) and orphaned (malformed:
        # counted, never fatal).
        self.trace_propagated = 0
        self.trace_orphaned = 0
        self._recorder = recorder if recorder is not None else (
            FlightRecorder(None))
        self._slo = slo
        self._user_breach_cb = None
        if slo is not None:
            prev = slo.on_breach
            # A fresh engine over the same SLOEngine adopts the caller's
            # original hook, not the dead engine's interceptor.
            if getattr(prev, "__func__", None) is ServeEngine._on_slo_breach:
                prev = prev.__self__._user_breach_cb
            self._user_breach_cb = prev
            slo.on_breach = self._on_slo_breach
        self._build_info = build_info(self.device)
        self.scheduler = Scheduler(
            max_queue=max_queue,
            prefill_len=self.prefill_len,
            total_len=knobs["ctx_len"],
            vocab_size=spec.vocab_size,
            chunk=self.prefill_chunk,
            min_bucket=self.min_bucket,
            token_budget=self.step_token_budget,
            trace_seed=trace_seed,
            clock=clock,
        )
        self.buckets = self.scheduler.bucket_list()
        self._slots = [_Slot(index=i) for i in range(slots)]
        dev = self.device
        cache_dtype = torch.int8 if self.kv_dtype == "int8" else torch.float32
        if self.paged:
            self._cache = init_paged_slot_cache(
                spec, slots, num_pages=self.kv_pages,
                page_size=self.page_size, dtype=cache_dtype, device=dev,
            )
            self._prefix = PrefixCache(self.kv_pages, self.page_size)
            # Host mirror of the device page table: mutated at bind and
            # retire, uploaded once before the next dispatch.
            self._table_np = np.zeros((slots, self._lane_pages), np.int32)
            self._table_dirty = False
            # Binds refused because the FIFO head's page demand outran
            # the pool (requeued at the front, retried next step).
            self.page_starved_binds = 0
        else:
            self._cache = init_slot_cache(
                spec, slots, dtype=cache_dtype, device=dev,
            )
        # Device-resident decode state: the token vector (output of one
        # step, input to the next) and per-slot sampling state, written
        # at refill by the chunk path, never re-uploaded per step.
        self._toks = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._seeds = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._sample_steps = torch.zeros(slots, dtype=torch.int64, device=dev)
        self._temps = torch.zeros(slots, dtype=torch.float32, device=dev)
        self._top_ps = torch.ones(slots, dtype=torch.float32, device=dev)
        if self.spec_tokens:
            # The draft's own fp32 fixed-lane cache (it tracks the same
            # token history at its own width) and dummy sampling state
            # for prefill_chunk: the draft proposes greedily, so none of
            # it is read.
            self._draft_cache = init_slot_cache(
                self.draft_model.spec, slots, device=dev)
            self._d_state = [
                torch.zeros(slots, dtype=torch.int64, device=dev)
                for _ in range(3)
            ] + [torch.zeros(slots, device=dev), torch.ones(slots, device=dev)]
            # A round's outputs: the [S, γ] proposals, then each lane's γ
            # target tokens and its match count.
            self._drafts = torch.zeros(slots, self.spec_tokens,
                                       dtype=torch.int64, device=dev)
            self._verify_out = torch.zeros(slots, self.spec_tokens + 1,
                                           dtype=torch.int64, device=dev)
            self._never = torch.zeros((), dtype=torch.int64, device=dev)
        # The step programs' static inputs: per bucket width the chunk's
        # tokens, then slot, start, length, final and seed; the
        # request's temperature and top_p.
        self._chunk_in = {
            w: torch.zeros(w + 5, dtype=torch.int64, device=dev)
            for w in self.buckets
        }
        self._chunk_f = torch.zeros(2, dtype=torch.float32, device=dev)
        self._programs = ProgramSet(dev, graphs=cuda_graphs)
        self.cuda_graphs = self._programs.graphs
        # Speculative tallies, engine-wide (the /stats source) and of
        # the current step (the serve_step record's).
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        self.accept_rate = StatSummary()  # per-request acceptance
        self._step_spec = (0, 0)
        # Dispatched values not yet read back:
        # ("first", snapshot, slot) | ("decode", snapshot, lanes).
        self._pending: list[tuple[str, tuple, object]] = []
        self._completed: dict[int, Completion] = {}
        self._started_at = clock()
        self._steps = 0
        # Target decode dispatches: fused decode+sample steps, or the
        # verify steps of speculative rounds (each after γ draft steps).
        self.decode_steps = 0
        self.ttft = StatSummary()
        self.decode_rate = StatSummary()
        self.step_latency = StatSummary()
        self.queue_wait = StatSummary()
        self.tpot = StatSummary()
        self.tokens_emitted_total = 0
        self._retire_times: deque = deque(maxlen=32)
        self.reject_counts: dict[str, int] = {}
        self.status_counts: dict[str, int] = {}
        # Model lifecycle: the serving weights' label, the swaps made and
        # rolled back, and the hot-swap barrier.
        self.model_version = model_version
        self.reloads_total = 0
        self.rollbacks_total = 0
        self._admission_paused = False
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
        trace: Optional[str] = None,
    ) -> Admission:
        """Admission-checked enqueue; rejections carry a reason.

        ``trace`` is an inbound trace-context line
        (``00-<trace>-<span>-<parent>``): a valid one is adopted — the
        request's trace id becomes the caller's, its parent span the
        caller's span — and counted ``trace_propagated``; a malformed one
        is counted ``trace_orphaned`` and the engine mints its own id, as
        if nothing arrived (a peer's garbage never rejects a request).
        """
        adopted = None
        if trace is not None:
            adopted = parse_trace_context(trace)
            if adopted is None:
                self.trace_orphaned += 1
            else:
                self.trace_propagated += 1
        adm = self.scheduler.submit(
            prompt,
            max_new_tokens,
            temperature=temperature,
            top_p=top_p,
            seed=seed,
            timeout=timeout,
            trace_id=adopted[0] if adopted else None,
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
        if self._reqtrace is not None:
            # The admit event: submit is already a host-side touch point.
            self._reqtrace.admit(
                adm.request.rid, adm.request.trace_id,
                parent=f"{adopted[1]:016x}" if adopted else None,
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
        # Paused at the hot-swap barrier, queued work is not steppable:
        # only running lanes keep the loop busy.
        if self._admission_paused:
            return self.active > 0
        return self.active > 0 or self.scheduler.depth > 0

    # ---- model lifecycle (serve/lifecycle.py) ---------------------------

    def pause_admission(self) -> None:
        """Stop binding queued requests to lanes (``step()`` skips the
        admit phase) while bound lanes decode to completion: the
        drain-to-a-barrier half of a hot-swap. Submissions still queue;
        nothing is dropped."""
        self._admission_paused = True

    def resume_admission(self) -> None:
        self._admission_paused = False

    def install_params(
        self,
        state: dict,
        *,
        model_version: Optional[str] = None,
        invalidate_prefix: bool = False,
    ) -> None:
        """Swap the serving weights for ``state`` (a CausalLM state dict)
        in place, so every cache, buffer and captured CUDA graph stays
        valid: a graph reads each weight at its address at capture, so a
        weight must never be rebound, only copied into. Needs a drained
        engine (``active == 0``). Any key, shape or dtype skew raises
        ``ValueError("spec_skew: ...")`` before anything changes; a copy
        that fails midway restores the old weights and re-raises. The copy has finished on the device when
        this returns. ``invalidate_prefix`` flushes the prefix index and
        the page table of a paged engine: its K/V was computed under the
        old weights (a same-version reinstall keeps it). The draft model
        is left alone, as the JAX engine leaves it.
        """
        if self.active:
            raise RuntimeError(
                "install_params() requires a drained engine "
                f"({self.active} lanes still bound — pause admission and "
                "wait for retirement)"
            )
        live = self.model.state_dict()
        if set(state) != set(live):
            diff = sorted(set(state) ^ set(live))
            raise ValueError(
                f"spec_skew: parameter names differ from the serving "
                f"model's: {diff[:5]}"
            )
        for k, old in live.items():
            new = state[k]
            if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
                raise ValueError(
                    f"spec_skew: {k} {tuple(new.shape)}/{new.dtype} != "
                    f"serving {tuple(old.shape)}/{old.dtype}"
                )
        backup = {k: v.clone() for k, v in live.items()}
        try:
            with torch.no_grad():
                for k, v in live.items():
                    v.copy_(state[k])
        except BaseException:
            with torch.no_grad():
                for k, v in live.items():
                    v.copy_(backup[k])
            raise
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if model_version is not None:
            self.model_version = model_version
        self.reloads_total += 1
        if invalidate_prefix and self.paged:
            # No lane owns a page at the barrier, so every mapped page
            # belongs to the stale index: rebuild it and zero the table,
            # the startup state.
            self._prefix = PrefixCache(self.kv_pages, self.page_size)
            self._table_np[:] = 0
            self._table_dirty = True

    def cache_bytes_per_slot(self) -> int:
        return self._cache.nbytes() // self.num_slots

    def queue_drain_eta_s(self) -> Optional[float]:
        return drain_eta_s(list(self._retire_times), self.scheduler.depth)

    def page_stats(self) -> Optional[dict]:
        """The pool and prefix index (None on fixed-lane engines).
        ``effective_slots_multiplier`` is the reuse win: the pages that
        lane copies would keep resident (Σ per-lane mappings) over the
        unique mapped pages — 1.0 with no sharing, > 1 when prefix pages
        are forked."""
        if not self.paged:
            return None
        refs = self._prefix.mapped_page_refs
        uniq = self._prefix.mapped_pages
        return {
            **self._prefix.stats(),
            "lane_pages": self._lane_pages,
            "pages_mapped": uniq,
            "page_starved_binds": self.page_starved_binds,
            "effective_slots_multiplier": (
                round(refs / uniq, 3) if uniq else None
            ),
        }

    def spec_acceptance_rate(self) -> Optional[float]:
        """Lifetime draft-acceptance fraction; None before any verify
        round (or when speculation is off)."""
        if not self.spec_drafted_total:
            return None
        return self.spec_accepted_total / self.spec_drafted_total

    def stats(self, *, include_states: bool = False) -> dict:
        """JSON-ready operational snapshot (the /stats endpoint); the
        ``paged`` block only on paged engines, the speculative keys of
        ``decode_path`` only on speculative ones, ``slo`` only with an
        SLO engine, ``reqtrace`` only with request tracing on.
        ``include_states`` adds the latency summaries' mergeable states
        (what /statusz serves, so an aggregator merges exactly)."""
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
            "build_info": dict(self._build_info),
            **({"summary_states": {
                "ttft_s": self.ttft.to_state(),
                "tpot_s": self.tpot.to_state(),
                "queue_s": self.queue_wait.to_state(),
                "decode_tokens_per_s": self.decode_rate.to_state(),
            }} if include_states else {}),
            **({"slo": self._slo.state()} if self._slo is not None else {}),
            **({"reqtrace": {
                "live": self._reqtrace.live_count,
                "retained": self._reqtrace.retired_count,
                # Only once a trace context has arrived.
                **({"propagated": self.trace_propagated,
                    "orphaned": self.trace_orphaned}
                   if self.trace_propagated or self.trace_orphaned
                   else {}),
            }} if self._reqtrace is not None else {}),
            "compile_counts": self.compile_counts(),
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
                **({
                    "spec_tokens": self.spec_tokens,
                    "draft_attn_impl": self.draft_decode_attn,
                    "spec_acceptance": self.spec_acceptance_rate(),
                    "spec_drafted_total": self.spec_drafted_total,
                    "spec_accepted_total": self.spec_accepted_total,
                    # The lifetime ratio hides stragglers; one cold
                    # request in a warm fleet shows up here.
                    "spec_acceptance_per_request":
                        self.accept_rate.snapshot(),
                } if self.spec_tokens else {}),
            },
            "device": str(self.device),
            **({"paged": self.page_stats()} if self.paged else {}),
            # Absent until a version is set or a swap has happened.
            **({"lifecycle": {
                **({"model_version": self.model_version}
                   if self.model_version is not None else {}),
                "reloads_total": self.reloads_total,
                "rollbacks_total": self.rollbacks_total,
            }} if self.model_version is not None or self.reloads_total
                or self.rollbacks_total else {}),
        }

    # ---- the compile contract (serve/programs.py) ---------------------

    def compile_counts(self) -> dict[str, int]:
        """Prepared programs per engine function, JAX's keys (the
        static-shape pin: after ``warmup()`` these never grow;
        prefill_first and prefill_chunk are each bounded by
        ``len(self.buckets)``). Speculative engines add the draft chunk
        programs (same bound), one draft-decode and one verify
        program."""
        names = ["prefill_first", "prefill_chunk", "decode"]
        if self.spec_tokens:
            names += ["draft_prefill_first", "draft_prefill_chunk",
                      "draft_decode", "spec_verify"]
        return {n: self._programs.prepared(n) for n in names}

    def compile_budget(self) -> int:
        """The whole program set's ceiling: 2 chunk programs per bucket
        + 1 decode, and as many again + draft-decode + verify when
        speculating."""
        base = 2 * len(self.buckets) + 1
        if self.spec_tokens:
            base += 2 * len(self.buckets) + 2
        return base

    def warmup(self) -> dict[str, int]:
        """Prepare the engine's whole program set → ``compile_counts()``.

        On the card each program runs once and is captured as a CUDA
        graph, so no request meets a capture; on the CPU (or without
        graphs) the programs are only registered. Needs an idle engine:
        the warm runs write garbage K/V into lane 0 (on a paged engine
        into the scratch page its zeroed table row maps), which the
        refill invariant makes harmless only while no request owns a
        lane.
        """
        if self.active:
            raise RuntimeError("warmup() requires an idle engine")
        self._sync_table()
        chunks = ["prefill_first", "prefill_chunk"]
        if self.spec_tokens:
            chunks += ["draft_prefill_first", "draft_prefill_chunk"]
        for kind in chunks:
            for w in self.buckets:
                # JAX's warmup inputs: lane 0, start 0, a full chunk of
                # zeros, not final, greedy.
                self._stage_chunk(w, [], 0, 0, False, 0, 0.0, 1.0,
                                  length=w)
                self._program(kind, w).prepare()
        self._program("decode").prepare()
        if self.spec_tokens:
            self._program("draft_decode").prepare()
            self._program("spec_verify").prepare()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.compile_counts()

    def graph_pool_bytes(self) -> Optional[int]:
        """Bytes the step graphs' memory pool holds on the card (0
        without graphs)."""
        return self._programs.pool_bytes()

    def capture_seconds(self) -> float:
        """Seconds spent preparing programs (warm run + capture)."""
        return self._programs.capture_seconds()

    def _program(self, name: str, width: Optional[int] = None):
        return self._programs.get(name, width,
                                  lambda: self._program_fn(name, width))

    def _program_fn(self, name: str, width: Optional[int]):
        """The function of program ``name`` (at bucket ``width`` for the
        chunk programs): engine-owned tensors in, results written into
        them in place. Module functions are looked up at each call, so
        an eager program runs what the module holds then."""
        if name == "decode":
            def fn():
                self._toks.copy_(slot_decode_sample_step(
                    self.model, self._cache, self._toks, self._seeds,
                    self._sample_steps, self._temps, self._top_ps,
                    attn_impl=self._attn_impl))
        elif name == "draft_decode":
            def fn():
                with torch.no_grad():
                    self._draft_cache.pos.copy_(self._cache.pos)
                    t = self._toks
                    for j in range(self.spec_tokens):
                        logits = slot_decode_step(
                            self.draft_model, self._draft_cache, t,
                            attn_impl=self._attn_impl)
                        t = torch.argmax(logits, dim=-1)
                        self._drafts[:, j].copy_(t)
        elif name == "spec_verify":
            def fn():
                nxt, target, matched = slot_verify_step(
                    self.model, self._cache, self._toks, self._drafts,
                    self._seeds, self._sample_steps, self._temps,
                    self._top_ps)
                with torch.no_grad():
                    self._toks.copy_(nxt)
                    self._verify_out[:, :-1].copy_(target)
                    self._verify_out[:, -1].copy_(matched)
        else:
            buf, f = self._chunk_in[width], self._chunk_f
            chunk, slot, start, length, final, seed = (
                buf[:width], *buf[width:].unbind())
            draft = name.startswith("draft_")
            lane_attend = name.endswith("prefill_chunk")
            if draft:
                def fn():
                    prefill_chunk_device(
                        self.draft_model, self._draft_cache, *self._d_state,
                        slot, chunk, start, length, self._never, seed,
                        f[0], f[1], lane_attend=lane_attend)
            else:
                def fn():
                    prefill_chunk_device(
                        self.model, self._cache, self._toks, self._seeds,
                        self._sample_steps, self._temps, self._top_ps,
                        slot, chunk, start, length, final, seed, f[0], f[1],
                        lane_attend=lane_attend)
        return fn

    def _stage_chunk(self, width, tokens, slot, start, final, seed,
                     temperature, top_p, *, length=None) -> None:
        """Upload one chunk's static inputs: ``tokens`` zero-padded to
        ``width``, then slot, start, length (default ``len(tokens)``),
        final and seed; the temperature and top_p."""
        host = torch.zeros(width + 5, dtype=torch.int64)
        host[: len(tokens)] = torch.as_tensor(tokens, dtype=torch.int64)
        host[width:] = torch.tensor(
            [slot, start, len(tokens) if length is None else length,
             int(final), seed])
        _upload(self._chunk_in[width], host)
        _upload(self._chunk_f, torch.tensor([temperature, top_p],
                                            dtype=torch.float32))

    def _sync_table(self) -> None:
        """Paged mode: upload the host mirror of the page table once,
        before any dispatch, if a bind or retire changed it. The copy is
        of a fresh host tensor, so later edits of the mirror cannot reach
        a copy still in flight."""
        if self.paged and self._table_dirty:
            _upload(self._cache.table, torch.from_numpy(self._table_np.copy()))
            self._table_dirty = False

    # ---- engine loop ------------------------------------------------

    def step(self) -> int:
        """One engine iteration → number of tokens scheduled (see the
        module docstring for the order of its phases)."""
        now = self.clock()
        t_step = time.perf_counter()
        traced = self.tracer.enabled
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
            self._retire_trace(c)
            self._record_request(c)
            evictions += 1

        for slot in self._slots:
            # Paused at the hot-swap barrier: queue heads stay queued.
            if self._admission_paused:
                break
            if not slot.free or self.scheduler.depth == 0:
                continue
            req = self.scheduler.next_request()
            if req is None:
                break
            if self._admit_to_slot(slot, req) == "starved":
                # The FIFO head went back to the queue front: later
                # requests must not overtake it.
                break

        # Paged mode: the binds above and the retires at the top of this
        # step upload the table once, before any dispatch. The copy is of
        # a fresh host tensor, so later edits of the mirror cannot reach
        # a copy still in flight.
        self._sync_table()

        prev_pending = self._pending
        self._pending = []
        produced = 0
        self._step_spec = (0, 0)  # (drafted, accepted) this step
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
        # A decoding lane costs tokens_per_decode budget tokens: 1 on
        # the plain path, γ under speculation (the verify step runs γ
        # positions a lane).
        for i, width in self.scheduler.plan_chunks(
            prefilling, len(decode_lanes) * self._tokens_per_decode
        ):
            slot = self._slots[i]
            req = slot.request
            start = slot.prefill_pos
            live = min(width, len(req.prompt) - start)
            final = start + live == len(req.prompt)
            t0 = time.perf_counter()
            self._stage_chunk(width, req.prompt[start : start + live],
                              i, start, final, req.seed, req.temperature,
                              req.top_p)
            # First chunk: self-contained causal attention; later chunks
            # attend the full lane under the banded mask.
            kind = "prefill_chunk" if start else "prefill_first"
            self._program(kind, width).run()
            if self.spec_tokens:
                # The same chunk into the draft's lane, never final: the
                # request's first token is the target's draw. After a
                # prefix hit the lane starts at ``matched``, as the
                # target's does.
                self._program("draft_" + kind, width).run()
            slot.prefill_pos = start + live
            chunk_tokens += live
            if traced:
                self._wait_device()
            chunk_dur = time.perf_counter() - t0
            self.tracer.complete(
                "serve.prefill_chunk", t0, chunk_dur,
                {"rid": req.rid, "slot": i, "start": start, "width": width,
                 "final": final} if traced else None,
            )
            if self._reqtrace is not None:
                tr = self._reqtrace.get(req.rid)
                if tr is not None:
                    tr.prefill_chunk(t0, chunk_dur, start=start,
                                     bucket=width, tokens=live, final=final)
            if final:
                slot.emitted = 1
                produced += 1
                self._pending.append(("first", _snapshot(self._toks[i]), i))
                decode_lanes.append(i)

        emit_lanes = [
            i
            for i in decode_lanes
            if self._slots[i].emitted < self._slots[i].request.max_new_tokens
        ]
        # Dispatch only when some lane will actually emit.
        if emit_lanes and self.spec_tokens:
            produced += self._spec_round(emit_lanes)
        elif emit_lanes:
            t0 = time.perf_counter()
            self._program("decode").run()
            self.decode_steps += 1
            if traced:
                self._wait_device()
            self.tracer.complete(
                "serve.decode", t0, time.perf_counter() - t0,
                {"lanes": len(decode_lanes)} if traced else None,
            )
            for i in emit_lanes:
                self._slots[i].emitted += 1
                if self._reqtrace is not None:
                    # One counter bump a lane a step, folded into ONE
                    # req.decode span at retire.
                    tr = self._reqtrace.get(self._slots[i].request.rid)
                    if tr is not None:
                        tr.decode_step(t0)
            self._pending.append(("decode", _snapshot(self._toks), emit_lanes))
            produced += len(emit_lanes)

        dispatch_s = time.perf_counter() - t_dispatch
        t_retire = time.perf_counter()
        self._drain(prev_pending)
        retire_s = time.perf_counter() - t_retire

        self._steps += 1
        self.tokens_emitted_total += produced
        self.step_latency.add(time.perf_counter() - t_step)
        # Speculative and paged fields only on such engines: the plain
        # fixed-lane record keeps its schema.
        extra = {}
        if self.spec_tokens:
            drafted, accepted = self._step_spec
            extra = dict(
                spec_drafted=drafted,
                spec_accepted=accepted,
                spec_acceptance=(
                    round(accepted / drafted, 4) if drafted else None
                ),
            )
        if self.paged:
            p = self._prefix
            hr = p.hit_rate()
            extra.update(
                pages_free=p.free_pages,
                pages_resident=p.resident_pages,
                pages_shared=p.shared_pages,
                prefix_hit_rate=None if hr is None else round(hr, 4),
            )
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
            **extra,
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

    def _draft_propose(self) -> torch.Tensor:
        """The ``draft_decode`` program → the [S, γ] greedy proposals
        (``_drafts``), on the device. The first draft step adopts the
        target's positions (the draft advanced γ last round, the target
        only as far as acceptance went); every step is
        ``slot_decode_step`` on the draft's cache (the flash-decode
        kernel B4 on the GPU)."""
        self._program("draft_decode").run()
        return self._drafts

    def _verify(self) -> torch.Tensor:
        """The ``spec_verify`` program (one ``slot_verify_step`` of the
        target over ``_drafts``) → [S, γ + 1] int64 on the device: each
        lane's γ target tokens, then its match count. ``_toks``, ``pos``
        and the sampling steps advance on the device."""
        self._program("spec_verify").run()
        return self._verify_out

    def _spec_round(self, emit_lanes: list[int]) -> int:
        """One speculative round → tokens emitted (1..γ a lane): γ draft
        proposals, one batched verify, then ONE synchronous read of the
        [S, γ] target tokens and [S] match counts (small integers, never
        logits) — the emit counts depend on the data, so speculation
        trades the one-step-late read for up to γ tokens a target step.
        Each lane emits min(matched + 1, γ, budget left) tokens."""
        gamma = self.spec_tokens
        # First-token scalars of THIS step's final chunks land before
        # the verify tokens: slot.tokens is in stream order.
        self._drain()
        t0 = time.perf_counter()
        self._draft_propose()
        out = self._verify().cpu().tolist()
        round_dur = time.perf_counter() - t0
        self.decode_steps += 1
        produced = drafted = accepted = 0
        for i in emit_lanes:
            slot = self._slots[i]
            *target, m = out[i]
            n = min(m + 1, gamma, slot.request.max_new_tokens - slot.emitted)
            slot.tokens.extend(target[:n])
            slot.emitted += n
            slot.spec_drafted += gamma
            slot.spec_accepted += m
            produced += n
            drafted += gamma
            accepted += m
            if self._reqtrace is not None:
                tr = self._reqtrace.get(slot.request.rid)
                if tr is not None:
                    tr.spec_round(t0, round_dur, drafted=gamma, accepted=m,
                                  emitted=n)
        self.spec_drafted_total += drafted
        self.spec_accepted_total += accepted
        self._step_spec = (drafted, accepted)
        # The read above waited for the round: no extra wait to trace it.
        self.tracer.complete(
            "serve.spec_verify", t0, round_dur,
            {"lanes": len(emit_lanes), "drafted": drafted,
             "accepted": accepted} if self.tracer.enabled else None,
        )
        return produced

    def _admit_to_slot(self, slot: _Slot, req: Request) -> str:
        """Bind a popped request to a lane → "bound" | "rejected" |
        "starved" (paged only: the pool cannot hold the request's page
        demand even after LRU eviction; the request went back to the
        queue front)."""
        if len(req.prompt) > min(self.prefill_len, self.spec.total_len - 1):
            c = Completion(
                rid=req.rid, status=REJECTED_TOO_LONG, prompt=req.prompt,
                tokens=[], ttft=None, decode_seconds=0.0,
                submitted=req.submitted, finished=self.clock(),
            )
            self._completed[req.rid] = c
            self._retire_trace(c)
            self._record_request(c)
            return "rejected"
        matched = 0
        pids: list[int] = []
        if self.paged:
            # The lane must own every page it could write: prompt + the
            # decode budget + the verify round's γ-1 reserve, in pages.
            got = self._prefix.acquire(
                req.prompt,
                page_demand(len(req.prompt), req.max_new_tokens,
                            self.page_size, total_len=self.spec.total_len,
                            reserve=max(0, self.spec_tokens - 1)),
            )
            if got is None:
                self.page_starved_binds += 1
                self.scheduler.push_front(req)
                return "starved"
            pids, matched = got
        slot.request = req
        slot.tokens = []
        slot.emitted = 0
        slot.prefill_pos = matched
        slot.first_token_at = None
        slot.pages = pids
        slot.matched_tokens = matched
        slot.spec_drafted = slot.spec_accepted = 0
        if self.paged:
            self._table_np[slot.index] = 0
            self._table_np[slot.index, : len(pids)] = pids
            self._table_dirty = True
            # Position floor at the matched length, on the device before
            # any dispatch: idle-shape decode steps write at each lane's
            # pos between chunks, and pos >= matched keeps those writes
            # out of the shared prefix pages. The first chunk then starts
            # at ``matched`` as a continuation chunk.
            self._cache.pos[slot.index] = matched
        slot.queue_s = max(0.0, self.clock() - req.submitted)
        self.queue_wait.add(slot.queue_s)
        if self._reqtrace is not None:
            tr = self._reqtrace.get(req.rid)
            if tr is not None:
                tr.bind(self._reqtrace.clock())
        return "bound"

    def _drain(self, items: Optional[list] = None) -> int:
        """Read dispatched-but-unread token values → tokens appended.
        Each item is a decode step's [S] vector or a first-token scalar,
        never logits."""
        if items is None:
            items = self._pending
            self._pending = []
        if not items:
            return 0
        t0 = time.perf_counter()
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
        self.tracer.complete(
            "serve.sample", t0, time.perf_counter() - t0,
            {"tokens": appended} if self.tracer.enabled else None,
        )
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
            prefix_hit_tokens=slot.matched_tokens if self.paged else None,
            spec_acceptance=(
                round(slot.spec_accepted / slot.spec_drafted, 4)
                if slot.spec_drafted else None
            ),
            model_version=self.model_version,
        )
        self._completed[req.rid] = c
        self._retire_times.append(now)
        if len(c.tokens) > 1:
            self.decode_rate.add(c.decode_tokens_per_s)
        if c.tpot_s is not None:
            self.tpot.add(c.tpot_s)
        if c.spec_acceptance is not None:
            self.accept_rate.add(c.spec_acceptance)
        self._retire_trace(c)
        self._record_request(c)
        if self.paged and slot.pages:
            # Publish the prompt's fully prefilled pages into the index
            # (decode output stays private) and unmap the lane's pages;
            # the zeroed table row points the idle lane at the scratch
            # page, so its decode writes never reach a freed page.
            self._prefix.release(req.prompt, slot.pages, slot.prefill_pos)
            self._table_np[slot.index] = 0
            self._table_dirty = True
        slot.request = None
        slot.tokens = []
        slot.emitted = 0
        slot.prefill_pos = 0
        slot.first_token_at = None
        slot.queue_s = None
        slot.pages = []
        slot.matched_tokens = 0
        slot.spec_drafted = slot.spec_accepted = 0

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
        if c.spec_acceptance is not None:
            fields["spec_acceptance"] = c.spec_acceptance
        if c.queue_s is not None:
            fields["queue_s"] = round(c.queue_s, 6)
        if c.tpot_s is not None:
            fields["tpot_s"] = round(c.tpot_s, 6)
        if c.trace is not None:
            fields["trace_id"] = c.trace["trace_id"]
        if c.prefix_hit_tokens is not None:
            fields["prefix_hit_tokens"] = c.prefix_hit_tokens
        if c.model_version is not None:
            fields["model_version"] = c.model_version
        self.metrics.write("serve_request", **fields)
        # The SLIs are host floats already in hand. Availability counts
        # every service-terminal status (a timeout is unavailability);
        # a prompt rejected as too long is the client's fault and burns
        # no budget.
        if self._slo is not None and c.status != REJECTED_TOO_LONG:
            self._slo.observe(ttft_s=c.ttft, tpot_s=c.tpot_s,
                              queue_s=c.queue_s, ok=c.status == COMPLETE)

    def _wait_device(self) -> None:
        """The tracer's measuring mode: wait for the work queued on the
        engine's stream, so a span covers device time."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _retire_trace(self, c: Completion) -> None:
        """Close the request's trace (if tracing) and hang its digest on
        the completion — called from every retirement path."""
        if self._reqtrace is None:
            return
        t = self._reqtrace.retire(c.rid, c.status, tracer=self.tracer)
        if t is not None:
            c.trace = t.summary()

    def _on_slo_breach(self, state: dict) -> None:
        """SLO alert transition: one ``slo_breach`` record into the
        metrics stream and one into the flight recorder's ring, then the
        caller's hook if any."""
        fields = dict(
            objective=state["name"],
            target=state["target"],
            current=state["current"],
            burn_rate_fast=state["burn_rate_fast"],
            burn_rate_slow=state["burn_rate_slow"],
            window_n=state["window_n"],
        )
        self.metrics.write("slo_breach", **fields)
        self._recorder.record("slo_breach", **fields)
        if self._user_breach_cb is not None:
            self._user_breach_cb(state)

    def request_timeline(self, key) -> Optional[dict]:
        """One request's event timeline by rid or hex trace id (the
        /requestz payload); None when unknown or tracing is off."""
        if self._reqtrace is None:
            return None
        t = self._reqtrace.lookup(key)
        if t is None:
            return None
        doc = t.timeline()
        doc["live"] = t.retire_t is None
        return doc

    def emit_request_spans(self) -> int:
        """Emit retired request traces into the span tracer after the
        fact (→ count): a timed run keeps the measuring mode off and
        exports the request spans afterwards, with the stamps taken
        live."""
        if self._reqtrace is None:
            return 0
        return self._reqtrace.emit_all(self.tracer)
