"""In-process span tracer → Perfetto/Chrome ``trace_event`` JSON.

A copy of ``ddp_tpu/obs/tracer.py`` (pure host code), kept in the port
so that it imports nothing of the JAX package. ``torch.profiler``
answers "which kernel is slow" but costs a heavyweight capture and says
nothing about the *host* side: scheduler stalls, the token read-back,
admission. This tracer is the complement: host-level spans with bounded
memory (a ring of the last N events), thread-safe begin/end, and an
export any Perfetto/``chrome://tracing`` instance loads directly.

Design constraints, in priority order:

1. **Disabled mode is free.** ``span()`` on a disabled tracer returns
   one cached null context manager — the SAME object every call — and
   every other recording call returns immediately: no allocation, no
   device wait (pinned by tests/test_torch_obs.py).
2. **Enabled mode is bounded.** Events live in a ``deque(maxlen=
   ring_events)``: a week-long serving process holds at most the ring.
   Per-span-name duration summaries (utils/metrics.StatSummary) are
   capped at ``MAX_SUMMARY_NAMES`` distinct names so a cardinality bug
   upstream cannot grow memory either.
3. **Export is crash-safe.** ``export()`` writes to a temp file in the
   target directory and ``os.replace``s it — a crash mid-export leaves
   the previous trace intact, never a half-written JSON.

Timestamps are Unix-epoch microseconds (``perf_counter`` deltas pinned
to ``time.time`` at construction) so per-rank traces from different
processes merge onto one comparable timeline (the JAX package's
``scripts/trace_merge.py`` reads these files as it reads its own).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

from ddp_tpu_torch.utils.metrics import StatSummary

DEFAULT_RING_EVENTS = 65536
MAX_SUMMARY_NAMES = 256

# Canonical per-rank trace filename (trace_merge globs this pattern).
RANK_TRACE_FILENAME = "trace_rank{rank}.trace.json"


class _NullSpan:
    """The disabled-mode context manager: one shared immutable object."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records duration on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._end_span(self.name, self._t0, self.args)
        return False


class Tracer:
    """Thread-safe bounded span/instant recorder.

    ``enabled=False`` (the default) makes every method a constant-cost
    no-op. ``process_id`` becomes the Chrome ``pid`` so merged
    multi-rank traces show one track group per rank.
    """

    def __init__(
        self,
        *,
        enabled: bool = False,
        ring_events: int = DEFAULT_RING_EVENTS,
        process_id: int = 0,
    ):
        from collections import deque

        self.enabled = bool(enabled)
        self.process_id = int(process_id)
        self.ring_events = max(1, int(ring_events))
        self._events: Any = deque(maxlen=self.ring_events)
        self._lock = threading.Lock()
        self._summaries: dict[str, StatSummary] = {}
        self._dropped = 0
        # perf_counter→unix pin: exported ts are absolute µs, so traces
        # from different ranks/processes align on one timeline.
        self._unix_base = time.time() - time.perf_counter()

    # ---- recording --------------------------------------------------

    def span(self, name: str, args: Optional[dict] = None):
        """Context manager timing one span. ``args`` (a plain dict or
        None — not kwargs, to keep the disabled path allocation-free)
        lands in the event's Perfetto ``args`` pane."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """A zero-duration marker event."""
        if not self.enabled:
            return
        now = time.perf_counter()
        self._record("i", name, now, 0.0, args)

    def counter(self, name: str, values: dict) -> None:
        """A Perfetto counter sample (``ph: "C"``): ``values`` maps
        series name → number and renders as a counter track (the HBM
        used/high-water track rides this). Free when disabled, like
        every recording path."""
        if not self.enabled:
            return
        self._record("C", name, time.perf_counter(), 0.0, values)

    def complete(
        self,
        name: str,
        start_perf: float,
        dur_s: float,
        args: Optional[dict] = None,
    ) -> None:
        """Record a span retroactively from stamps already in hand
        (``start_perf`` from ``time.perf_counter``) — the attribution
        path measures first and records after, so the recording cost
        never sits inside the measured window."""
        if not self.enabled:
            return
        self._record("X", name, start_perf, max(0.0, dur_s), args)

    def async_complete(
        self,
        name: str,
        start_perf: float,
        dur_s: float,
        aid: str,
        args: Optional[dict] = None,
        *,
        cat: str = "request",
    ) -> None:
        """A nestable async span (Perfetto ph ``b``/``e``) recorded
        retroactively. ``aid`` is the async id — events sharing
        (cat, id) land on one async track, which is how per-request
        lifecycle spans group across engine steps (obs/reqtrace.py).
        Free when disabled, like every recording path."""
        if not self.enabled:
            return
        self._record("b", name, start_perf, 0.0, args, aid=aid, cat=cat)
        self._record(
            "e", name, start_perf + max(0.0, dur_s), 0.0, None,
            aid=aid, cat=cat,
        )

    def async_instant(
        self,
        name: str,
        t_perf: float,
        aid: str,
        args: Optional[dict] = None,
        *,
        cat: str = "request",
    ) -> None:
        """A nestable async instant (ph ``n``) at an explicit stamp."""
        if not self.enabled:
            return
        self._record("n", name, t_perf, 0.0, args, aid=aid, cat=cat)

    def _end_span(self, name: str, t0: float, args: Optional[dict]) -> None:
        now = time.perf_counter()
        self._record("X", name, t0, now - t0, args)

    def _record(
        self, ph: str, name: str, t0: float, dur_s: float,
        args: Optional[dict],
        aid: Optional[str] = None,
        cat: Optional[str] = None,
    ) -> None:
        tid = threading.get_ident()
        with self._lock:
            if len(self._events) == self.ring_events:
                self._dropped += 1
            self._events.append((ph, name, t0, dur_s, tid, args, aid, cat))
            if ph == "X":
                summ = self._summaries.get(name)
                if summ is None:
                    if len(self._summaries) >= MAX_SUMMARY_NAMES:
                        return
                    summ = self._summaries[name] = StatSummary()
                summ.add(dur_s)

    # ---- export -----------------------------------------------------

    def _event_dicts(self, limit: Optional[int] = None) -> list[dict]:
        with self._lock:
            raw = list(self._events)
        if limit is not None:
            raw = raw[-limit:]
        out = []
        for ph, name, t0, dur_s, tid, args, aid, cat in raw:
            ev: dict[str, Any] = {
                "ph": ph,
                "name": name,
                "ts": round((self._unix_base + t0) * 1e6, 3),
                "pid": self.process_id,
                "tid": tid,
            }
            if ph == "X":
                ev["dur"] = round(dur_s * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if ph in ("b", "e", "n"):
                # Nestable async events: matched per (pid, cat, id) —
                # the per-request lifecycle tracks (obs/reqtrace.py).
                ev["cat"] = cat or "request"
                ev["id"] = aid
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def summaries(self) -> dict[str, dict]:
        """Per-span-name duration snapshots (seconds)."""
        with self._lock:
            names = list(self._summaries.items())
        return {n: s.snapshot(ndigits=6) for n, s in names}

    def summary_states(self) -> dict[str, dict]:
        """Mergeable per-name StatSummary states (trace_merge's input)."""
        with self._lock:
            names = list(self._summaries.items())
        return {n: s.to_state() for n, s in names}

    def snapshot(self, *, limit: Optional[int] = 512) -> dict:
        """Live, JSON-ready view for the server's /statusz route."""
        return {
            "enabled": self.enabled,
            "traceEvents": self._event_dicts(limit),
            "dropped_events": self._dropped,
            "span_summaries": self.summaries(),
        }

    def trace_document(self) -> dict:
        """The full exportable Chrome/Perfetto trace object."""
        meta = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": self.process_id,
                "tid": 0,
                "args": {"name": f"ddp_tpu rank {self.process_id}"},
            }
        ]
        return {
            "traceEvents": meta + self._event_dicts(),
            "displayTimeUnit": "ms",
            "ddp_tpu": {
                "rank": self.process_id,
                "dropped_events": self._dropped,
                "span_summaries": self.summary_states(),
            },
        }

    def export(self, path: str) -> str:
        """Crash-safe write of the trace document to ``path``."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.trace_document(), f)
        os.replace(tmp, path)
        return path

    def export_to_dir(self, trace_dir: str) -> str:
        return self.export(
            os.path.join(
                trace_dir,
                RANK_TRACE_FILENAME.format(rank=self.process_id),
            )
        )


# ---- schema validation (shared by tests and trace_merge) -------------


def validate_trace_file(path: str) -> dict:
    """Load ``path`` and check the Chrome ``trace_event`` essentials.

    Raises ``ValueError`` with a precise reason on any violation —
    this is what the smoke tier runs against an emitted trace so an
    exporter regression fails tier-1 fast, and what trace_merge runs
    on every input before merging. Returns the parsed document.
    """
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not valid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: top level must be an object")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: event {i} is not an object")
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            raise ValueError(f"{path}: event {i} missing ph")
        if not isinstance(ev.get("name"), str):
            raise ValueError(f"{path}: event {i} missing name")
        if ph == "M":
            continue  # metadata events carry no timestamp
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"{path}: event {i} missing numeric ts")
        if not isinstance(ev.get("pid"), int) or not isinstance(
            ev.get("tid"), int
        ):
            raise ValueError(f"{path}: event {i} missing pid/tid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"{path}: complete event {i} needs dur >= 0"
                )
        if ph in ("b", "e", "n"):
            # Nestable async events (the per-request lifecycle spans):
            # Perfetto matches them per (pid, cat, id) — both fields
            # are load-bearing, so their absence is a schema error.
            if not isinstance(ev.get("id"), (str, int)):
                raise ValueError(
                    f"{path}: async event {i} missing id"
                )
            if not isinstance(ev.get("cat"), str):
                raise ValueError(
                    f"{path}: async event {i} missing cat"
                )
    return doc
