"""Declarative serving SLOs with multi-window burn-rate alerting.

The serve path's user-facing objectives, stated the way an SRE would
write them and evaluated live inside the serving process:

    --slo "ttft_p99<0.5s,tpot_p50<80ms,availability>0.999"

Each objective is an SLI over the per-request observations the engine
already retires (TTFT, TPOT = decode seconds per output token, queue
wait, request success), evaluated over **two rolling windows** in the
SRE multi-window style: a fast window (default 5 m) that reacts, and a
slow window (default 1 h) that keeps a transient blip from paging.
For a percentile objective ``ttft_p99<0.5s`` the error budget is the
percentile's complement (1% of requests may exceed 0.5 s); the **burn
rate** is the fraction of budget-violating requests in a window over
that budget — burn 1.0 consumes exactly the budget, burn 14.4 on a 5 m
window is the classic "page now" threshold. An objective **breaches**
when its current windowed value violates the target; it **alerts**
when BOTH windows burn past the alert threshold, and the False→True
transition fires the breach hook exactly once (the engine routes it to
the metrics stream and the flight recorder).

A copy of ``ddp_tpu/obs/slo.py`` (pure host code), kept in the port so
that it imports nothing of the JAX package. Surfaced as: ``/statusz``
state (``stats.slo``) and linted
``ddp_tpu_slo_{target,current,burn_rate,breached}`` gauges on
``/metricsz`` (obs/promtext.py). Pure host-side Python,
clock-injectable; memory is bounded by a ring of observations.
"""

from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

FAST_WINDOW_S = 300.0  # the SRE fast window: 5 minutes
SLOW_WINDOW_S = 3600.0  # the slow window: 1 hour

# Latency metrics an objective may target, mapped to the observation
# field; "availability" is the success-fraction special case.
_METRICS = ("ttft", "tpot", "queue")
_UNITS = {"s": 1.0, "ms": 1e-3}

_OBJ_RE = re.compile(
    r"^(?P<metric>[a-z]+)(?:_p(?P<pct>[0-9]+(?:\.[0-9]+)?))?"
    r"(?P<op>[<>])(?P<value>[0-9]*\.?[0-9]+)(?P<unit>ms|s)?$"
)

# Bounded observation ring: at serving rates the slow window can hold
# more requests than a process should keep — the burn estimate then
# rides the most recent N, which is the end that matters.
MAX_OBSERVATIONS = 65536


@dataclass(frozen=True)
class Objective:
    """One parsed objective, e.g. ttft_p99<0.5s."""

    name: str  # "ttft_p99" | "availability" | ...
    metric: str  # ttft|tpot|queue|availability
    percentile: Optional[float]  # None for availability
    op: str  # "<" (latency) or ">" (availability)
    target: float  # seconds, or a fraction for availability
    raw: str  # the exact spec text, for display

    @property
    def budget(self) -> float:
        """Error budget: the fraction of requests ALLOWED to violate."""
        if self.metric == "availability":
            return max(1e-9, 1.0 - self.target)
        return max(1e-9, 1.0 - self.percentile / 100.0)


def parse_slo(spec: str) -> list[Objective]:
    """``"ttft_p99<0.5s,availability>0.999"`` → objectives.

    Raises ``ValueError`` naming the offending clause — a mistyped
    objective must fail at the CLI, not render an empty gauge set.
    """
    objectives: list[Objective] = []
    seen: set[str] = set()
    for clause in str(spec).split(","):
        clause = clause.strip()
        if not clause:
            continue
        m = _OBJ_RE.match(clause)
        if not m:
            raise ValueError(
                f"bad SLO clause {clause!r} (want e.g. ttft_p99<0.5s, "
                f"tpot_p50<80ms, availability>0.999)"
            )
        metric = m.group("metric")
        pct = m.group("pct")
        op = m.group("op")
        value = float(m.group("value"))
        unit = m.group("unit")
        if metric == "availability":
            if pct is not None or unit is not None or op != ">":
                raise ValueError(
                    f"{clause!r}: availability objectives are "
                    f"availability>FRACTION (no percentile, no unit)"
                )
            if not 0.0 < value < 1.0:
                raise ValueError(
                    f"{clause!r}: availability target must be in (0, 1)"
                )
            name = "availability"
            target, percentile = value, None
        else:
            if metric not in _METRICS:
                raise ValueError(
                    f"{clause!r}: unknown metric {metric!r} "
                    f"(one of {', '.join(_METRICS)}, availability)"
                )
            if pct is None or op != "<":
                raise ValueError(
                    f"{clause!r}: latency objectives are "
                    f"METRIC_pNN<BOUND[s|ms]"
                )
            percentile = float(pct)
            if not 0.0 < percentile < 100.0:
                raise ValueError(
                    f"{clause!r}: percentile must be in (0, 100)"
                )
            target = value * _UNITS[unit or "s"]
            if target <= 0.0:
                raise ValueError(f"{clause!r}: bound must be positive")
            pname = pct
            if "." in pname:  # 99.0 -> 99, 99.9 stays (50 stays 50)
                pname = pname.rstrip("0").rstrip(".")
            name = f"{metric}_p{pname}"
        if name in seen:
            raise ValueError(f"duplicate objective {name!r}")
        seen.add(name)
        objectives.append(
            Objective(
                name=name, metric=metric, percentile=percentile,
                op=op, target=target, raw=clause,
            )
        )
    if not objectives:
        raise ValueError(f"empty SLO spec {spec!r}")
    return objectives


def parse_model_slos(spec: str) -> dict:
    """Multi-model SLO spec → {model_name_or_None: clause string}.

    ``;``-separated groups, each optionally prefixed ``name:`` —
    e.g. ``"ttft_p99<0.5s;draft:ttft_p99<0.2s,availability>0.99"``
    gives the default model its own objectives and the registered
    model ``draft`` another set (per-model SLO engines, per-model burn
    gauges). The bare form (no ``;``, no prefix) parses to
    ``{None: spec}`` — every pre-lifecycle ``--slo`` value is
    unchanged. Each group's clause string is validated by
    ``parse_slo`` here, so a typo in any group fails at the CLI.
    """
    out: dict = {}
    for group in str(spec).split(";"):
        group = group.strip()
        if not group:
            continue
        name: Optional[str] = None
        head, sep, tail = group.partition(":")
        # A ":" only introduces a model name when the head looks like
        # one (an objective clause can't contain ":").
        if sep and re.fullmatch(r"[A-Za-z0-9_.-]+", head.strip()):
            name = head.strip()
            group = tail.strip()
        if name in out:
            raise ValueError(
                f"duplicate SLO group for "
                f"{'the default model' if name is None else name!r}"
            )
        parse_slo(group)  # validate now, fail at the CLI
        out[name] = group
    if not out:
        raise ValueError(f"empty SLO spec {spec!r}")
    return out


def _percentile(values: list[float], q: float) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    rank = max(0, min(len(s) - 1, round(q / 100.0 * (len(s) - 1))))
    return s[rank]


class SLOEngine:
    """Rolling-window evaluator + breach latch for a set of objectives.

    ``observe()`` is called once per retired request (host floats
    only); evaluation is throttled to ``min_eval_interval_s`` so
    neither a high request rate nor a hot scrape target pays a
    percentile sort per call — ``state()`` inside the interval serves
    the last evaluation. ``on_breach`` fires once per
    False→True alert transition per objective (multi-window burn:
    both the fast and slow window burning past ``burn_alert``), and
    re-arms when the objective stops alerting.
    """

    def __init__(
        self,
        objectives: "list[Objective] | str",
        *,
        fast_window_s: float = FAST_WINDOW_S,
        slow_window_s: float = SLOW_WINDOW_S,
        burn_alert: float = 1.0,
        min_eval_interval_s: float = 1.0,
        max_observations: int = MAX_OBSERVATIONS,
        clock: Callable[[], float] = time.monotonic,
        on_breach: Optional[Callable[[dict], None]] = None,
    ):
        if isinstance(objectives, str):
            objectives = parse_slo(objectives)
        if not objectives:
            raise ValueError("SLOEngine needs at least one objective")
        if fast_window_s <= 0 or slow_window_s < fast_window_s:
            raise ValueError(
                f"windows must satisfy 0 < fast ({fast_window_s}) <= "
                f"slow ({slow_window_s})"
            )
        self.objectives = list(objectives)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_alert = float(burn_alert)
        self.min_eval_interval_s = float(min_eval_interval_s)
        self.clock = clock
        self.on_breach = on_breach
        # (t, ttft, tpot, queue, ok) — latency fields None when the
        # request never produced them (queue timeouts etc.).
        self._obs: deque = deque(maxlen=max(1, int(max_observations)))
        self._alerting: dict[str, bool] = {
            o.name: False for o in self.objectives
        }
        self.breach_counts: dict[str, int] = {
            o.name: 0 for o in self.objectives
        }
        self._last_eval = -float("inf")
        self._last_states: list[dict] = self._evaluate(self.clock())

    @property
    def spec(self) -> str:
        return ",".join(o.raw for o in self.objectives)

    # ---- feeding ----------------------------------------------------

    def observe(
        self,
        *,
        ttft_s: Optional[float] = None,
        tpot_s: Optional[float] = None,
        queue_s: Optional[float] = None,
        ok: bool = True,
    ) -> None:
        """One retired request's SLI fields. Cheap: an append plus a
        throttled evaluation (the breach hook must fire from live
        traffic, not wait for the next scrape)."""
        now = self.clock()
        self._obs.append((now, ttft_s, tpot_s, queue_s, bool(ok)))
        if now - self._last_eval >= self.min_eval_interval_s:
            self._evaluate(now)

    # ---- evaluation -------------------------------------------------

    def _window(self, now: float, horizon_s: float) -> list[tuple]:
        cutoff = now - horizon_s
        return [o for o in self._obs if o[0] > cutoff]

    def _evaluate(self, now: float) -> list[dict]:
        self._last_eval = now
        fast = self._window(now, self.fast_window_s)
        slow = self._window(now, self.slow_window_s)
        field = {"ttft": 1, "tpot": 2, "queue": 3}
        states: list[dict] = []
        for obj in self.objectives:
            if obj.metric == "availability":
                f_vals = [o[4] for o in fast]
                s_vals = [o[4] for o in slow]
                current = (
                    sum(f_vals) / len(f_vals) if f_vals else None
                )
                bad_fast = (
                    (len(f_vals) - sum(f_vals)) / len(f_vals)
                    if f_vals else 0.0
                )
                bad_slow = (
                    (len(s_vals) - sum(s_vals)) / len(s_vals)
                    if s_vals else 0.0
                )
                breached = current is not None and current < obj.target
            else:
                i = field[obj.metric]
                f_vals = [o[i] for o in fast if o[i] is not None]
                s_vals = [o[i] for o in slow if o[i] is not None]
                current = _percentile(f_vals, obj.percentile)
                bad_fast = (
                    sum(1 for v in f_vals if v >= obj.target) / len(f_vals)
                    if f_vals else 0.0
                )
                bad_slow = (
                    sum(1 for v in s_vals if v >= obj.target) / len(s_vals)
                    if s_vals else 0.0
                )
                breached = current is not None and current >= obj.target
            burn_fast = bad_fast / obj.budget
            burn_slow = bad_slow / obj.budget
            alerting = (
                burn_fast >= self.burn_alert
                and burn_slow >= self.burn_alert
                and bool(f_vals)
            )
            state = {
                "name": obj.name,
                "objective": obj.raw,
                "metric": obj.metric,
                "target": obj.target,
                "current": (
                    round(current, 6) if current is not None else None
                ),
                "burn_rate_fast": round(burn_fast, 4),
                "burn_rate_slow": round(burn_slow, 4),
                "breached": bool(breached),
                "alerting": bool(alerting),
                "window_n": len(f_vals),
                "breaches": self.breach_counts[obj.name],
            }
            if alerting and not self._alerting[obj.name]:
                self.breach_counts[obj.name] += 1
                state["breaches"] = self.breach_counts[obj.name]
                if self.on_breach is not None:
                    self.on_breach(dict(state))
            self._alerting[obj.name] = alerting
            states.append(state)
        self._last_states = states
        return states

    def state(self) -> dict:
        """JSON-ready snapshot (the /statusz and stats() view).

        Rides the same ``min_eval_interval_s`` throttle as
        ``observe()``: a scrape inside the interval serves the cached
        states instead of paying window scans + percentile sorts over
        the observation ring under the server lock — a hot Prometheus
        target must not stall the admission path.
        """
        now = self.clock()
        if now - self._last_eval >= self.min_eval_interval_s:
            states = self._evaluate(now)
        else:
            states = self._last_states
        return {
            "spec": self.spec,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_alert": self.burn_alert,
            "observations": len(self._obs),
            "objectives": states,
            "breached": any(s["breached"] for s in states),
            "alerting": any(s["alerting"] for s in states),
        }
