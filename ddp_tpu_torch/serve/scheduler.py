"""Request queue with admission control — the serving front door.

The engine (serve/engine.py) owns a FIXED number of decode slots; this
module owns everything that happens before a request reaches one:

- **Admission control**: a request is validated at submit time against
  the engine's static limits (prompt fits the prefill width, prompt +
  budget fits the position table, budget positive) and the queue
  bound. Rejection is an explicit ``Admission`` with a machine-readable
  reason — the backpressure contract is *reject-with-reason at the
  door*, never queue-without-bound and OOM later.
- **FIFO with deadline eviction**: queued requests past their deadline
  are evicted (status ``timeout_queue``) rather than prefilled after
  they stopped mattering; the engine applies the same deadline to
  RUNNING requests (status ``timeout_evicted``), freeing the slot for
  the queue head.
- **Chunked-prefill planning**: the engine ingests prompts in
  power-of-two-bucketed chunks co-scheduled with decode steps
  (Sarathi-style stall-free prefill); ``plan_chunks`` decides which
  mid-prefill slots advance this step, accounting each chunk's width
  plus one token per decoding lane against a per-step token budget so
  one long prompt can never head-of-line-block the running lanes.

A copy of ``ddp_tpu/serve/scheduler.py`` (pure host code), kept in
the port so that it imports nothing of the JAX package. ``clock`` is
injectable so tests drive time explicitly.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ddp_tpu_torch.obs.reqtrace import derive_trace_id


# Machine-readable rejection reasons (the HTTP layer maps these to 4xx
# bodies; tests assert on them).
QUEUE_FULL = "queue_full"
PROMPT_EMPTY = "prompt_empty"
PROMPT_TOO_LONG = "prompt_too_long"
BUDGET_NONPOSITIVE = "max_new_tokens_nonpositive"
BUDGET_EXCEEDS_CONTEXT = "budget_exceeds_context"
TOKEN_OUT_OF_RANGE = "token_out_of_range"
TOP_P_OUT_OF_RANGE = "top_p_out_of_range"
TOP_P_WITHOUT_SAMPLING = "top_p_without_sampling"
SEED_OUT_OF_RANGE = "seed_out_of_range"


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def prev_pow2(n: int) -> int:
    """Largest power of two <= n (requires n >= 1)."""
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def classify_prompt(
    prompt_len: int, page_size: int, *, cutoff_tokens: int
) -> str:
    """Disaggregated-dispatch classification → "prefill" |
    "decode".

    Long prompts are the requests whose prefill steals step budget
    from every co-located decode lane, so they route through the
    prefill tier; short prompts prefill in one or two chunks and go
    straight to a decode replica. The cutoff is compared against the
    prompt's PAGE-ALIGNED length: only full pages ever migrate
    (serve/pages.release publishes full pages only), so a prompt
    whose page-aligned length is below the cutoff would ship fewer
    pages than the threshold promises. ``cutoff_tokens <= 0`` sends
    everything to the decode tier (disaggregation by role only, no
    length split). Pure — the router calls it, tests pin it.
    """
    if cutoff_tokens <= 0:
        return "decode"
    aligned = (
        (prompt_len // page_size) * page_size
        if page_size > 0
        else prompt_len
    )
    return "prefill" if aligned >= cutoff_tokens else "decode"


@dataclass
class Request:
    """One admitted generate request."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    deadline: Optional[float] = None  # absolute, in clock() time
    submitted: float = 0.0
    # 64-bit distributed-tracing id, assigned AT ADMISSION
    # (obs/reqtrace.derive_trace_id): the one key that follows the
    # request through the HTTP response, the metrics stream, the
    # Perfetto trace and /requestz. 0 = unassigned (bare schedulers
    # constructed without a trace seed in tests).
    trace_id: int = 0
    # Multi-model routing label: which registered
    # model this request named (``model=`` in the body). None — every
    # pre-lifecycle client — means the default model; the server
    # routes on it, and per-model engines each run their own scheduler
    # so slot/page accounting stays per-model by construction.
    model: Optional[str] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


@dataclass
class Admission:
    """Submit outcome: ``request`` on accept, ``reason`` on reject."""

    accepted: bool
    reason: Optional[str] = None
    request: Optional[Request] = None


@dataclass
class Scheduler:
    """Bounded FIFO queue + admission control for the serve engine.

    ``prefill_len``/``total_len`` mirror the engine's static shapes:
    a prompt longer than the prefill width can never be prefilled
    (one compiled prefill shape is the whole point), and prompt +
    max_new_tokens beyond the position table would decode garbage —
    both are admission errors, not runtime surprises.
    """

    max_queue: int
    prefill_len: int
    total_len: int
    vocab_size: int = 0  # 0 = skip the token-range check
    # Chunked-prefill policy (the engine sets these from its bucket
    # config; the defaults keep a bare Scheduler usable in tests).
    chunk: int = 0  # 0 = one prefill_len-wide chunk per prompt
    min_bucket: int = 0  # 0 = no bucketing below the chunk width
    token_budget: int = 0  # 0 = unlimited (no co-scheduling bound)
    # Seed for the per-request 64-bit trace ids (obs/reqtrace.py):
    # deterministic in (seed, rid) so tests can pin ids; a serving
    # process seeds from os.urandom so two replicas' id spaces don't
    # collide in a merged fleet trace.
    trace_seed: int = 0
    clock: Callable[[], float] = time.monotonic
    _queue: deque = field(default_factory=deque)
    _ids: "itertools.count" = field(default_factory=itertools.count)

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        top_p: float = 1.0,
        seed: int = 0,
        timeout: Optional[float] = None,
        trace_id: Optional[int] = None,
        model: Optional[str] = None,
    ) -> Admission:
        """Validate + enqueue → Admission (never raises on bad input).

        ``trace_id`` overrides the locally-derived id with one ADOPTED
        from an inbound fleet trace context (the router's), so the
        replica's whole timeline hangs off the router's span instead
        of a freshly-minted id; None/0 keeps the local derivation.
        """
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            # Non-numeric tokens: same front-door contract as a
            # numeric token outside the vocab — reject, don't raise.
            return Admission(False, TOKEN_OUT_OF_RANGE)
        if not prompt:
            return Admission(False, PROMPT_EMPTY)
        if len(prompt) > self.prefill_len:
            return Admission(False, PROMPT_TOO_LONG)
        if max_new_tokens < 1:
            return Admission(False, BUDGET_NONPOSITIVE)
        if len(prompt) + max_new_tokens > self.total_len:
            return Admission(False, BUDGET_EXCEEDS_CONTEXT)
        if self.vocab_size and not all(
            0 <= t < self.vocab_size for t in prompt
        ):
            return Admission(False, TOKEN_OUT_OF_RANGE)
        if not 0.0 < float(top_p) <= 1.0:
            return Admission(False, TOP_P_OUT_OF_RANGE)
        if float(temperature) <= 0.0 and float(top_p) < 1.0:
            # generate() refuses this combination for the same reason:
            # greedy decoding ignores the nucleus filter, and refusing
            # beats silently recording a setting that had no effect.
            return Admission(False, TOP_P_WITHOUT_SAMPLING)
        if not -(2**31) <= int(seed) < 2**31:
            # The engine threads seeds through int32 device state, and
            # generate()'s own jnp.asarray(seed) overflows past int32 —
            # out-of-range seeds can never sample the documented
            # stream, so they are a front-door error.
            return Admission(False, SEED_OUT_OF_RANGE)
        if len(self._queue) >= self.max_queue:
            return Admission(False, QUEUE_FULL)
        now = self.clock()
        rid = next(self._ids)
        req = Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            top_p=float(top_p),
            seed=int(seed),
            deadline=None if timeout is None else now + float(timeout),
            submitted=now,
            trace_id=(
                int(trace_id)
                if trace_id
                else derive_trace_id(self.trace_seed, rid)
            ),
            model=model,
        )
        self._queue.append(req)
        return Admission(True, request=req)

    # ---- chunked-prefill planning -----------------------------------

    def bucket_list(self) -> list[int]:
        """The compiled chunk-width set, ascending: {min_bucket · 2^i}
        up to and including ``chunk``. Bounded, warmup-enumerable."""
        chunk = self.chunk or next_pow2(self.prefill_len)
        widths = []
        w = min(self.min_bucket or chunk, chunk)
        while w < chunk:
            widths.append(w)
            w *= 2
        widths.append(chunk)
        return widths

    def chunk_width(
        self,
        start: int,
        remaining: int,
        budget: Optional[int] = None,
    ) -> Optional[int]:
        """Compiled width for the next chunk at position ``start`` with
        ``remaining`` prompt tokens left; None if nothing fits
        ``budget``.

        Preference: the smallest bucket covering ``remaining`` (a
        short prompt/tail pays bucket-sized compute, not
        ``prefill_len``-sized). Two fit constraints shrink it:

        - ``start + width <= total_len`` ALWAYS — a wider chunk's pad
          positions would overrun the cache, and a clamped write
          would silently shift the whole write
          over live lines (the engine's min_bucket clamp guarantees at
          least one bucket fits any admissible start);
        - ``width <= budget`` when given — rather than stalling a
          prompt whose covering bucket exceeds the step's leftover
          budget, ingest the largest budget-fitting bucket now and the
          rest on later steps (the chunk is simply non-final).
        """
        cap = self.total_len - start
        if budget is not None:
            cap = min(cap, budget)
        fitting = [w for w in self.bucket_list() if w <= cap]
        if not fitting:
            return None
        for w in fitting:
            if w >= remaining:
                return w
        return fitting[-1]

    def plan_chunks(
        self,
        prefilling: Sequence[tuple[int, int, int]],
        decoding: int,
    ) -> list[tuple[int, int]]:
        """Which mid-prefill slots advance this step → [(slot, width)].

        ``prefilling``: (slot, start, remaining-prompt-tokens) in
        refill order; ``decoding``: decode TOKENS dispatched this step
        — one per running lane on the plain path, lanes × γ under
        speculative verify (the engine multiplies; the verify program
        really does run γ positions per lane). Sarathi-style
        accounting: every planned chunk's width plus the decode tokens
        must fit ``token_budget``, so a long prompt is ingested across steps
        while running lanes keep decoding — never a full-prompt
        stall. Order is preserved (no short prompt overtakes within a
        step); a tight budget shrinks the head's chunk rather than
        starving it. Liveness: when nothing is decoding and the
        budget would starve even the first chunk, one unbudgeted
        chunk is planned anyway — an idle engine must make prefill
        progress.

        Paged engines need no per-step PAGE accounting here:
        a lane's whole page demand — every chunk's live tokens, the
        decode budget, and the speculative γ-1 write reserve — is
        acquired at BIND (serve/pages.page_demand), so any chunk this
        planner schedules writes into pages the lane already owns
        (pad overhang past the demand falls into the scratch page).
        The token budget stays the compute-side constraint; pages
        are the residency-side one.
        """
        budget = (
            self.token_budget - decoding
            if self.token_budget > 0
            else None
        )
        plan: list[tuple[int, int]] = []
        for slot, start, remaining in prefilling:
            width = self.chunk_width(start, remaining, budget)
            if width is None:
                break  # FIFO: later slots wait with the blocked head
            plan.append((slot, width))
            if budget is not None:
                budget -= width
        if not plan and prefilling and decoding == 0:
            slot, start, remaining = prefilling[0]
            width = self.chunk_width(start, remaining)
            if width is not None:  # None: no bucket fits this config
                plan.append((slot, width))
        return plan

    def evict_expired(self) -> list[Request]:
        """Drop queued requests past their deadline → the evicted."""
        now = self.clock()
        expired = [r for r in self._queue if r.expired(now)]
        if expired:
            dead = {r.rid for r in expired}
            self._queue = deque(
                r for r in self._queue if r.rid not in dead
            )
        return expired

    def next_request(self) -> Optional[Request]:
        """Pop the FIFO head, None when empty.

        Callers run ``evict_expired()`` first (the engine does, every
        step) — this only pops; an expired head that slipped between
        the two calls is still caught by the engine's running-request
        deadline check on its first decode step.
        """
        return self._queue.popleft() if self._queue else None

    def push_front(self, req: Request) -> None:
        """Return a popped request to the queue HEAD, order intact.

        The paged engine's admission backpressure: with a
        paged KV cache the binding resource is FREE PAGES, not lanes ×
        ctx_len — a popped head whose page demand (serve/pages.
        page_demand, γ-reserve included) cannot be satisfied even
        after LRU eviction goes back to the front and admission stops
        for the step, so a big request is delayed, never starved by
        smaller ones overtaking it. Deliberately exempt from the
        ``max_queue`` bound: the request was already admitted once.
        """
        self._queue.appendleft(req)

    @property
    def depth(self) -> int:
        return len(self._queue)
