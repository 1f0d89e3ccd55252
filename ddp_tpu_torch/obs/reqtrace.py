"""Per-request distributed tracing for the serve path.

A copy of ``ddp_tpu/obs/reqtrace.py`` (pure host code, the single-engine
half; the fleet's hop reconstruction waits for the fleet's port). The
span tracer (obs/tracer.py) answers "what was the ENGINE doing at time
T"; this module answers the question an operator triaging one slow
completion asks: "where did request X spend its 900 ms". Every request
gets a **64-bit trace id at admission** (derived deterministically from
the scheduler's request id, so the same seed and rid give the same id
as the JAX engine; the id survives across the HTTP response, the
metrics stream, the Perfetto trace and the /requestz endpoint), and the
engine hangs lightweight event records off the slot bookkeeping it
already keeps:

    admit -> queue -> prefill_chunk[i] (bucket, tokens)
          -> spec_round[j] (drafted/accepted) -> decode (steps, tokens)
          -> retire (reason)

Events are stamped ONLY at points where the engine already touches the
host (submit, slot bind, chunk/decode dispatch, the one-step-behind
retirement): request tracing adds **no device wait** (pinned on the card
by chip_smoke.py's phase 4e, which counts synchronizing calls).

Export rides the span tracer as Perfetto **nestable async spans** (ph
``b``/``e``/``n``, ``cat: "request"``, ``id`` = the hex trace id), and
:func:`reconstruct_requests` + :func:`validate_request_timeline`
rebuild and causally check any request's timeline from an exported
document.

Disabled mode (the default) is free: the engine skips every recording
call behind one ``is None`` check; no per-request objects exist.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Optional

# Span taxonomy (the JAX package's docs/OBSERVABILITY.md).
REQUEST_SPAN = "request"  # the admit->retire umbrella
ADMIT = "req.admit"
QUEUE = "req.queue"
PREFILL_CHUNK = "req.prefill_chunk"
SPEC_ROUND = "req.spec_round"
DECODE = "req.decode"
RETIRE = "req.retire"

ASYNC_CAT = "request"

# Bound on retired timelines kept for /requestz (per engine) — a
# week-long serving process must not grow a timeline per request
# forever, same discipline as the tracer ring.
DEFAULT_KEEP = 512


def splitmix64(x: int) -> int:
    """SplitMix64 finalizer: a cheap, well-mixed 64-bit hash."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def derive_trace_id(seed: int, rid: int) -> int:
    """The request's 64-bit trace id, assigned at admission.

    Deterministic in (seed, rid) so tests can pin ids; a serving
    process seeds from os.urandom (the engine's default) so two replicas'
    id spaces don't collide in a merged fleet trace. Never zero —
    0 is the "no id" sentinel everywhere downstream.
    """
    return splitmix64((int(seed) & 0xFFFFFFFFFFFFFFFF) ^ (int(rid) << 1)) or 1


def format_trace_id(trace_id: int) -> str:
    """Canonical hex form (the Perfetto ``id`` and /requestz key)."""
    return f"0x{int(trace_id) & 0xFFFFFFFFFFFFFFFF:016x}"


def derive_span_id(trace_id: int, salt: int) -> int:
    """A span id under ``trace_id`` (one per router attempt / hop).

    Deterministic in (trace_id, salt) for the same reason
    :func:`derive_trace_id` is; never zero (0 = "no parent")."""
    return splitmix64(
        (int(trace_id) & 0xFFFFFFFFFFFFFFFF) ^ ((int(salt) << 1) | 1)
    ) or 1


def encode_trace_context(
    trace_id: int, span_id: int, parent_span_id: int = 0
) -> str:
    """One-line traceparent-style context: ``00-<trace>-<span>-<parent>``.

    64-bit ids in fixed 16-hex (the house trace-id width), version
    pinned to ``00``. This single line is what rides the /generate JSON
    body (the JAX fleet also puts it on its page and activation wires)
    — the receiver's parent is this line's ``span`` field.
    """
    return "00-{:016x}-{:016x}-{:016x}".format(
        int(trace_id) & 0xFFFFFFFFFFFFFFFF,
        int(span_id) & 0xFFFFFFFFFFFFFFFF,
        int(parent_span_id) & 0xFFFFFFFFFFFFFFFF,
    )


def parse_trace_context(line) -> Optional[tuple]:
    """Parse a trace-context line into ``(trace_id, span_id, parent)``.

    Returns ``None`` on ANY malformation (wrong type, field count,
    version, width, non-hex, zero trace id) — never raises. A peer
    sending garbage must cost the receiver one counter bump
    (``trace_orphaned``), not a crash or a rejected request.
    """
    if not isinstance(line, str):
        return None
    parts = line.strip().split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    if any(len(p) != 16 for p in parts[1:]):
        return None
    try:
        trace_id, span_id, parent = (int(p, 16) for p in parts[1:])
    except ValueError:
        return None
    if trace_id == 0:
        return None
    return trace_id, span_id, parent


class RequestTrace:
    """One request's event record, hung off the engine's bookkeeping.

    Pure host state: a list of (name, t0_perf, dur_s, args) tuples
    plus the aggregate decode counters the per-step loop bumps in
    place of per-step events (one span per request, not one per
    token — the record stays O(chunks + spec rounds)).
    """

    __slots__ = (
        "rid", "trace_id", "events", "admit_t", "bind_t", "retire_t",
        "decode_t0", "decode_end", "decode_steps", "decode_tokens",
        "chunks", "spec_rounds", "reason", "emitted", "parent",
    )

    def __init__(
        self, rid: int, trace_id: int, admit_t: float,
        parent: Optional[str] = None,
    ):
        self.rid = rid
        self.trace_id = int(trace_id)
        self.parent = parent  # hex span id of the router attempt
        self.admit_t = admit_t  # perf_counter domain
        self.bind_t: Optional[float] = None
        self.retire_t: Optional[float] = None
        self.decode_t0: Optional[float] = None
        self.decode_end: Optional[float] = None
        self.decode_steps = 0
        self.decode_tokens = 0
        self.chunks = 0
        self.spec_rounds = 0
        self.reason: Optional[str] = None
        self.emitted = False
        self.events: list[tuple] = [(ADMIT, admit_t, 0.0, {"rid": rid})]

    # ---- recording (called from the engine's host-touch points) -----

    def bind(self, t: float) -> None:
        """Queue head popped into a lane: the queue span closes."""
        self.bind_t = t
        self.events.append((QUEUE, self.admit_t, t - self.admit_t, None))

    def prefill_chunk(
        self, t0: float, dur_s: float, *, start: int, bucket: int,
        tokens: int, final: bool,
    ) -> None:
        self.events.append((
            PREFILL_CHUNK, t0, dur_s,
            {"i": self.chunks, "start": start, "bucket": bucket,
             "tokens": tokens, "final": final},
        ))
        self.chunks += 1

    def spec_round(
        self, t0: float, dur_s: float, *, drafted: int, accepted: int,
        emitted: int,
    ) -> None:
        self.events.append((
            SPEC_ROUND, t0, dur_s,
            {"j": self.spec_rounds, "drafted": drafted,
             "accepted": accepted, "emitted": emitted},
        ))
        self.spec_rounds += 1
        self._decode_step(t0, emitted)

    def decode_step(self, t0: float, tokens: int = 1) -> None:
        """One decode dispatch covering this lane (aggregate — the
        per-request decode record is ONE span, closed at retire)."""
        self._decode_step(t0, tokens)

    def _decode_step(self, t0: float, tokens: int) -> None:
        if self.decode_t0 is None:
            self.decode_t0 = t0
        self.decode_end = t0
        self.decode_steps += 1
        self.decode_tokens += tokens

    def retire(self, t: float, reason: str) -> None:
        self.retire_t = t
        self.reason = reason
        if self.decode_t0 is not None:
            self.events.append((
                DECODE, self.decode_t0, t - self.decode_t0,
                {"steps": self.decode_steps, "tokens": self.decode_tokens},
            ))
        self.events.append((RETIRE, t, 0.0, {"reason": reason}))

    # ---- views ------------------------------------------------------

    def summary(self) -> dict:
        """The per-completion digest (``Completion.trace``)."""
        end = self.retire_t if self.retire_t is not None else self.admit_t
        out: dict[str, Any] = {
            "trace_id": format_trace_id(self.trace_id),
            **({"parent": self.parent} if self.parent else {}),
            "queue_s": round(
                (self.bind_t if self.bind_t is not None else end)
                - self.admit_t, 6,
            ),
            "prefill_chunks": self.chunks,
            "decode_steps": self.decode_steps,
            "total_s": round(end - self.admit_t, 6),
        }
        chunk_events = [e for e in self.events if e[0] == PREFILL_CHUNK]
        if chunk_events:
            first = chunk_events[0]
            last = chunk_events[-1]
            out["prefill_s"] = round(last[1] + last[2] - first[1], 6)
        if self.decode_t0 is not None:
            out["decode_s"] = round(end - self.decode_t0, 6)
        if self.spec_rounds:
            drafted = sum(
                e[3]["drafted"] for e in self.events if e[0] == SPEC_ROUND
            )
            accepted = sum(
                e[3]["accepted"] for e in self.events if e[0] == SPEC_ROUND
            )
            out["spec"] = {
                "rounds": self.spec_rounds,
                "drafted": drafted,
                "accepted": accepted,
                "acceptance": (
                    round(accepted / drafted, 4) if drafted else None
                ),
            }
        if self.reason is not None:
            out["reason"] = self.reason
        return out

    def timeline(self) -> dict:
        """The full JSON-ready event list (the /requestz payload)."""
        return {
            "rid": self.rid,
            "trace_id": format_trace_id(self.trace_id),
            "events": [
                {
                    "name": name,
                    "t_s": round(t0 - self.admit_t, 6),
                    "dur_s": round(dur, 6),
                    **({"args": args} if args else {}),
                }
                for name, t0, dur, args in self.events
            ],
            "summary": self.summary(),
        }

    def emit(self, tracer) -> None:
        """Write the record into the span tracer as Perfetto nestable
        async events (id = the hex trace id) — called at retire (a
        point the engine already owns the host) or retroactively via
        ``ServeEngine.emit_request_spans()``; timestamps are the
        stamps recorded when the events happened, so emission cost
        never sits inside a measured window."""
        if self.emitted or not tracer.enabled:
            return
        aid = format_trace_id(self.trace_id)
        end = self.retire_t if self.retire_t is not None else self.admit_t

        def _args(a):
            # An adopted request stamps its router-attempt parent span
            # onto EVERY event so a merged fleet document can tell the
            # hedge winner's decode path from the cancelled loser's —
            # both hang off the same trace id. Absent when not adopted.
            if self.parent is None:
                return a
            return {**(a or {}), "parent": self.parent}

        tracer.async_complete(
            REQUEST_SPAN, self.admit_t, end - self.admit_t, aid,
            _args({"rid": self.rid, "reason": self.reason}),
        )
        for name, t0, dur, args in self.events:
            if dur > 0.0:
                tracer.async_complete(name, t0, dur, aid, _args(args))
            else:
                tracer.async_instant(name, t0, aid, _args(args))
        self.emitted = True


class RequestTracer:
    """The engine's request-trace registry: live traces keyed by rid,
    a bounded ring of retired ones for /requestz, and the trace-id ↔
    rid index. All host dict ops; the engine guards every call on the
    feature flag so disabled mode allocates nothing."""

    def __init__(self, *, keep: int = DEFAULT_KEEP, clock=time.perf_counter):
        self.keep = max(1, int(keep))
        self.clock = clock
        self._live: dict[int, RequestTrace] = {}
        self._retired: "OrderedDict[int, RequestTrace]" = OrderedDict()

    def admit(
        self, rid: int, trace_id: int, parent: Optional[str] = None
    ) -> RequestTrace:
        t = RequestTrace(rid, trace_id, self.clock(), parent=parent)
        self._live[rid] = t
        return t

    def get(self, rid: int) -> Optional[RequestTrace]:
        return self._live.get(rid)

    def retire(self, rid: int, reason: str, tracer=None) -> Optional[RequestTrace]:
        t = self._live.pop(rid, None)
        if t is None:
            return None
        t.retire(self.clock(), reason)
        if tracer is not None:
            t.emit(tracer)
        self._retired[rid] = t
        while len(self._retired) > self.keep:
            self._retired.popitem(last=False)
        return t

    def lookup(self, key) -> Optional[RequestTrace]:
        """By rid (int / decimal string) or hex trace id ("0x…")."""
        s = str(key)
        if s.lower().startswith("0x"):
            try:
                tid = int(s, 16)
            except ValueError:
                return None
            for t in self._live.values():
                if t.trace_id == tid:
                    return t
            for t in reversed(self._retired.values()):
                if t.trace_id == tid:
                    return t
            return None
        try:
            rid = int(s)
        except ValueError:
            return None
        return self._live.get(rid) or self._retired.get(rid)

    def recent(self, limit: int = 32) -> list[dict]:
        out = []
        for t in list(reversed(self._retired.values()))[:limit]:
            out.append({
                "rid": t.rid,
                "trace_id": format_trace_id(t.trace_id),
                "reason": t.reason,
            })
        return out

    def emit_all(self, tracer) -> int:
        """Retroactively emit every not-yet-emitted retired trace —
        the timed path: its window runs with the tracer's measuring
        mode off (span fidelity would destroy the overlap being
        measured), then exports the request spans after."""
        n = 0
        for t in self._retired.values():
            if not t.emitted:
                t.emit(tracer)
                n += 1
        return n

    @property
    def live_count(self) -> int:
        return len(self._live)

    @property
    def retired_count(self) -> int:
        return len(self._retired)


# ---- reconstruction from exported traces -----------------------------


def reconstruct_requests(
    events: list[dict], cat: str = ASYNC_CAT
) -> dict[str, list[dict]]:
    """Group a trace document's async request events by trace id.

    Input is ``traceEvents`` (one rank's file or a merged document);
    output maps hex trace id → that request's events as
    ``{"name", "ph", "ts", "dur"?, "args"?}`` sorted by (ts, begin-
    before-end). ``b``/``e`` pairs are folded into one entry carrying
    ``dur`` (matched per (pid, id, name) as a stack, the nestable-
    async contract — pid scopes the fold so two PROCESSES emitting
    the same span name under one trace id, a hedge winner and its
    cancelled loser, never cross-pair in a merged document);
    unmatched begins surface with ``dur: None`` so a torn ring still
    reconstructs partially instead of raising. ``cat`` selects the
    async category — "request" (default, the engine's lifecycle
    events); the JAX fleet's router and MPMD stages write others.
    """
    by_id: dict[str, list[dict]] = {}
    open_spans: dict[tuple, list[dict]] = {}
    order = {"b": 0, "n": 1, "e": 2}
    for ev in sorted(
        (e for e in events if e.get("cat") == cat
         and e.get("ph") in ("b", "e", "n")),
        key=lambda e: (e.get("ts", 0), order.get(e.get("ph"), 3)),
    ):
        aid = str(ev.get("id"))
        ph = ev["ph"]
        if ph == "n":
            by_id.setdefault(aid, []).append({
                "name": ev["name"], "ph": "n", "ts": ev["ts"],
                **({"args": ev["args"]} if ev.get("args") else {}),
            })
        elif ph == "b":
            entry = {
                "name": ev["name"], "ph": "X", "ts": ev["ts"],
                "dur": None,
                **({"args": ev["args"]} if ev.get("args") else {}),
            }
            by_id.setdefault(aid, []).append(entry)
            open_spans.setdefault(
                (ev.get("pid"), aid, ev["name"]), []
            ).append(entry)
        else:  # "e"
            stack = open_spans.get((ev.get("pid"), aid, ev["name"]))
            if stack:
                entry = stack.pop()
                entry["dur"] = round(ev["ts"] - entry["ts"], 3)
    for evs in by_id.values():
        evs.sort(key=lambda e: e["ts"])
    return by_id


def validate_request_timeline(timeline: list[dict]) -> dict:
    """Causal-ordering check for one reconstructed request.

    Raises ``ValueError`` naming the violated invariant; returns a
    summary on success. The invariants are exactly the engine's
    lifecycle contract:

    - one umbrella ``request`` span bounding everything;
    - ``req.admit`` first, ``req.retire`` last (by timestamp);
    - the queue span starts at admit and ends before any prefill
      chunk runs;
    - prefill chunks are sequential: indices 0..n-1 ascending, each
      chunk ends (ts+dur) before the next begins;
    - decode/spec activity starts only after the LAST chunk started
      (the final chunk's lane joins the decode batch the same step),
      and ends by retire.

    Timestamps are µs with 1e-3 rounding; comparisons use a 1 µs
    epsilon so rounding can never fail a genuinely ordered timeline.
    """
    eps = 1.0  # µs
    if not timeline:
        raise ValueError("empty timeline")
    named = {}
    for ev in timeline:
        named.setdefault(ev["name"], []).append(ev)
    for required in (REQUEST_SPAN, ADMIT, RETIRE):
        if required not in named:
            raise ValueError(f"missing {required} event")
    umbrella = named[REQUEST_SPAN][0]
    if umbrella["dur"] is None:
        raise ValueError("unclosed request umbrella span")
    t_admit = named[ADMIT][0]["ts"]
    t_retire = named[RETIRE][-1]["ts"]
    if t_retire + eps < t_admit:
        raise ValueError("retire precedes admit")
    for ev in timeline:
        if ev["ts"] + eps < t_admit:
            raise ValueError(f"{ev['name']} precedes admit")
        if ev["ts"] - eps > t_retire:
            raise ValueError(f"{ev['name']} follows retire")
    chunks = named.get(PREFILL_CHUNK, [])
    idxs = [c.get("args", {}).get("i") for c in chunks]
    if idxs != sorted(idxs) or len(set(idxs)) != len(idxs):
        raise ValueError(f"prefill chunk indices out of order: {idxs}")
    for a, b in zip(chunks, chunks[1:]):
        if a["dur"] is not None and a["ts"] + a["dur"] - eps > b["ts"]:
            raise ValueError(
                f"prefill chunks overlap: chunk {a.get('args')} runs "
                f"past chunk {b.get('args')}"
            )
    queue = named.get(QUEUE, [None])[0]
    if queue is not None and chunks:
        if queue["dur"] is not None and (
            queue["ts"] + queue["dur"] - eps > chunks[0]["ts"]
        ):
            raise ValueError("queue span runs past the first prefill chunk")
    decode = named.get(DECODE, [None])[0]
    if decode is not None:
        if chunks and decode["ts"] + eps < chunks[-1]["ts"]:
            raise ValueError("decode starts before the final prefill chunk")
        if decode["dur"] is not None and (
            decode["ts"] + decode["dur"] - eps > t_retire
        ):
            raise ValueError("decode span runs past retire")
    for r in named.get(SPEC_ROUND, []):
        if decode is None:
            raise ValueError("spec round outside any decode span")
        if r["ts"] + eps < decode["ts"]:
            raise ValueError("spec round precedes the decode span")
    retire_args = named[RETIRE][-1].get("args", {})
    return {
        "reason": retire_args.get("reason"),
        "chunks": len(chunks),
        "spec_rounds": len(named.get(SPEC_ROUND, [])),
        "queue_us": queue["dur"] if queue else None,
        "total_us": round(t_retire - t_admit, 3),
    }


def requestz_events(doc: dict) -> list[dict]:
    """A ``/requestz`` timeline → the events :func:`reconstruct_requests`
    makes of an exported trace, for :func:`validate_request_timeline`:
    spans with their ``dur``, instants as ``"n"``, the ``request``
    umbrella from the digest's ``total_s``.

    The wire rounds each ``t_s`` and ``dur_s`` to 1 µs on its own, so a
    span's rounded end can pass a later instant's rounded time by 1 µs;
    times are rebuilt here as whole µs (``round(t_s * 1e6)``), where that
    overrun is exactly 1 and inside the validator's epsilon. Rebuilt as
    floats (``t_s * 1e6``), their sum can land a hair past it.
    """
    def us(seconds: float) -> int:
        return round(seconds * 1e6)

    out = [{"name": REQUEST_SPAN, "ph": "X", "ts": 0,
            "dur": us(doc["summary"]["total_s"])}]
    for e in doc["events"]:
        ev = {"name": e["name"], "ts": us(e["t_s"]),
              **({"args": e["args"]} if e.get("args") else {})}
        if e["dur_s"] > 0:
            ev.update(ph="X", dur=us(e["dur_s"]))
        else:
            ev["ph"] = "n"
        out.append(ev)
    return sorted(out, key=lambda e: e["ts"])
