"""Prometheus text exposition of the serve engine's live counters.

A copy of ``ddp_tpu/obs/promtext.py``'s serving half (pure host code),
kept in the port so that it imports nothing of the JAX package; the
metric names are the JAX exporter's (``ddp_tpu_serve_*``,
``ddp_tpu_slo_*``, ``ddp_tpu_build_info``), so one dashboard reads
either package. Renders ``ServeEngine.stats()`` in the Prometheus text
format (version 0.0.4), served at ``GET /metricsz`` on the serve HTTP
frontend (serve/server.py). Keys a stats dict does not carry render
nothing: absent is not zero.

Zero dependencies: the format is lines of ``# HELP`` / ``# TYPE``
comments and ``name{label="v"} value`` samples. :func:`validate_promtext`
is the matching lint — metric/label name validity, quote escaping, no
duplicate samples, TYPE-before-samples.

StatSummary snapshots render as Prometheus ``summary`` families:
``name{quantile="0.5"|"0.95"}``, ``name_sum``, ``name_count`` (plus
``name_min``/``name_max`` gauges — the snapshot carries exact
extremes, and dropping them would waste the only exact tail signal a
reservoir summary has).
"""

from __future__ import annotations

import re
from typing import Optional

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)(\s+-?\d+)?$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)
_TYPES = ("counter", "gauge", "summary", "histogram", "untyped")

CONTENT_TYPE = "text/plain; version=0.0.4"


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class PromBuilder:
    """Accumulate samples per metric family, render once.

    Families keep insertion order; samples within a family keep theirs.
    ``add`` validates names eagerly (a bad series should fail where it
    was written, not at scrape time) and rejects duplicate
    (name, labelset) samples — the lint's rules, enforced at build.
    """

    def __init__(self):
        # name -> {"type": str, "help": str|None, "samples": [(labels, v)]}
        self._families: dict[str, dict] = {}
        self._seen: set = set()

    def add(
        self,
        name: str,
        value,
        *,
        labels: Optional[dict] = None,
        metric_type: str = "gauge",
        help: Optional[str] = None,
    ) -> "PromBuilder":
        if value is None:
            return self  # absent metric, not zero — same rule as MFU
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        if metric_type not in _TYPES:
            raise ValueError(f"bad metric type {metric_type!r}")
        labels = dict(labels or {})
        for k in labels:
            if not _LABEL_NAME_RE.match(k):
                raise ValueError(f"bad label name {k!r} on {name}")
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        if key in self._seen:
            raise ValueError(f"duplicate sample {name} {labels}")
        self._seen.add(key)
        fam = self._families.setdefault(
            name, {"type": metric_type, "help": help, "samples": []}
        )
        if fam["type"] != metric_type:
            raise ValueError(
                f"{name}: conflicting types {fam['type']} vs {metric_type}"
            )
        fam["samples"].append((labels, float(value)))
        return self

    def summary(
        self,
        name: str,
        snapshot: Optional[dict],
        *,
        labels: Optional[dict] = None,
        help: Optional[str] = None,
    ) -> "PromBuilder":
        """A StatSummary ``snapshot()`` → one summary family (+ exact
        min/max gauges). Empty snapshots render count 0 only."""
        snap = snapshot or {}
        count = int(snap.get("count", 0))
        base = dict(labels or {})
        self.add(
            f"{name}_count", count, labels=base,
            metric_type="counter", help=help,
        )
        if count == 0:
            return self
        # Prefer the exact running sum; mean×count is the fallback for
        # foreign snapshots and is NOT monotone under mean rounding.
        total = (
            float(snap["sum"])
            if "sum" in snap
            else float(snap["mean"]) * count
        )
        self.add(f"{name}_sum", total, labels=base, metric_type="counter")
        for q, field in (("0.5", "p50"), ("0.95", "p95")):
            if field in snap:
                self.add(
                    name, snap[field],
                    labels={**base, "quantile": q},
                    metric_type="summary",
                )
        for ext in ("min", "max"):
            if ext in snap:
                self.add(f"{name}_{ext}", snap[ext], labels=base)
        return self

    def render(self) -> str:
        lines: list[str] = []
        for name, fam in self._families.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for labels, value in fam["samples"]:
                if labels:
                    body = ",".join(
                        f'{k}="{_escape(v)}"'
                        for k, v in sorted(labels.items())
                    )
                    lines.append(f"{name}{{{body}}} {_fmt_value(value)}")
                else:
                    lines.append(f"{name} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


def validate_promtext(text: str) -> int:
    """Lint a text exposition; → sample count, raises ValueError.

    Checks the rules scrapers actually break on: name/label validity,
    quote escaping (labels must reconstruct exactly), float-parseable
    values, no duplicate (name, labelset) samples, at most one TYPE
    per family and declared before its samples, trailing newline.
    """
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    samples = 0
    seen: set = set()
    typed: dict[str, str] = {}
    sampled_names: set[str] = set()
    for n, line in enumerate(text.split("\n"), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                mname = parts[2]
                if not _METRIC_NAME_RE.match(mname):
                    raise ValueError(f"line {n}: bad metric name {mname!r}")
                if parts[1] == "TYPE":
                    if len(parts) < 4 or parts[3] not in _TYPES:
                        raise ValueError(f"line {n}: bad TYPE line")
                    if mname in typed:
                        raise ValueError(f"line {n}: duplicate TYPE {mname}")
                    if mname in sampled_names:
                        raise ValueError(
                            f"line {n}: TYPE {mname} after its samples"
                        )
                    typed[mname] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {n}: unparseable sample {line!r}")
        name, _, labelbody, value, _ts = m.groups()
        pairs: tuple = ()
        if labelbody:
            found = _LABEL_PAIR_RE.findall(labelbody)
            rebuilt = ",".join(f'{k}="{v}"' for k, v in found)
            if rebuilt != labelbody.rstrip(","):
                raise ValueError(f"line {n}: malformed labels {labelbody!r}")
            names = [k for k, _ in found]
            if len(set(names)) != len(names):
                raise ValueError(f"line {n}: repeated label name")
            pairs = tuple(sorted(found))
        if value not in ("NaN", "+Inf", "-Inf"):
            try:
                float(value)
            except ValueError:
                raise ValueError(f"line {n}: bad value {value!r}")
        # quantile/le label participates in dedup — identical full
        # labelsets are what scrapers reject.
        key = (name, pairs)
        if key in seen:
            raise ValueError(f"line {n}: duplicate sample {name} {pairs}")
        seen.add(key)
        # A summary's name_sum/name_count samples belong to family
        # `name`; approximate by exact-name tracking (enough to catch
        # TYPE-after-sample for the family head).
        sampled_names.add(name)
        samples += 1
    return samples


# ---- renderers -------------------------------------------------------


def _render_build_info(b: PromBuilder, bi: Optional[dict], name: str) -> None:
    """The ``ddp_tpu_build_info`` provenance gauge (value 1, identity
    in the labels — the Prometheus *_info idiom). Shared by both
    exporters so a fleet scrape spots version skew in one query;
    absent when the snapshot carries no block (pre-build-info
    streams stay byte-identical)."""
    if not bi:
        return
    b.add(
        name, 1,
        labels={k: str(v) for k, v in sorted(bi.items())},
        help="package/torch/backend provenance (value is always 1)",
    )


def _render_slo(b: PromBuilder, slo: Optional[dict]) -> None:
    """SLO gauges (obs/slo.py): target/current/burn-rate/breached per
    objective. Absent-key gated — an engine without --slo renders no
    ddp_tpu_slo_* series at all."""
    if not slo:
        return
    for obj in slo.get("objectives") or []:
        labels = {"objective": obj["name"]}
        b.add(
            "ddp_tpu_slo_target", obj.get("target"), labels=labels,
            help="objective bound (seconds, or fraction for "
            "availability)",
        )
        b.add(
            "ddp_tpu_slo_current", obj.get("current"), labels=labels,
            help="fast-window SLI value (absent until observed)",
        )
        for window, key in (("fast", "burn_rate_fast"),
                            ("slow", "burn_rate_slow")):
            b.add(
                "ddp_tpu_slo_burn_rate", obj.get(key),
                labels={**labels, "window": window},
                help="error-budget burn rate (1.0 = budget consumed "
                "exactly)",
            )
        b.add(
            "ddp_tpu_slo_breached",
            1 if obj.get("breached") else 0,
            labels=labels,
            help="1 while the current windowed value violates the "
            "objective",
        )


def render_serve(
    stats: dict,
    *,
    up: Optional[bool] = None,
    draining: Optional[bool] = None,
) -> str:
    """ServeEngine.stats() → exposition (the /metricsz payload)."""
    b = PromBuilder()
    if up is not None:
        b.add(
            "ddp_tpu_serve_up", 1 if up else 0,
            help="1 while the engine loop is healthy",
        )
    if draining is not None:
        b.add(
            "ddp_tpu_serve_draining", 1 if draining else 0,
            help="1 while shutdown drain rejects new admissions",
        )
    b.add("ddp_tpu_serve_slots", stats.get("slots"), help="decode lanes")
    b.add(
        "ddp_tpu_serve_active_slots", stats.get("active"),
        help="lanes bound to a request",
    )
    slots = stats.get("slots") or 0
    if slots:
        b.add(
            "ddp_tpu_serve_slot_occupancy",
            (stats.get("active") or 0) / slots,
            help="active / slots",
        )
    b.add("ddp_tpu_serve_queue_depth", stats.get("queue_depth"))
    b.add(
        "ddp_tpu_serve_steps_total", stats.get("steps"),
        metric_type="counter", help="engine iterations",
    )
    for reason, count in sorted((stats.get("rejects") or {}).items()):
        b.add(
            "ddp_tpu_serve_rejects_total", count,
            labels={"reason": reason}, metric_type="counter",
        )
    for status, count in sorted(
        (stats.get("requests_by_status") or {}).items()
    ):
        b.add(
            "ddp_tpu_serve_requests_total", count,
            labels={"status": status}, metric_type="counter",
        )
    b.add(
        "ddp_tpu_serve_tokens_total", stats.get("tokens_total"),
        metric_type="counter",
        help="tokens scheduled across all requests (the aggregator's "
        "fleet tokens/s source)",
    )
    b.summary(
        "ddp_tpu_serve_ttft_seconds", stats.get("ttft_s"),
        help="submit to first token",
    )
    b.summary(
        "ddp_tpu_serve_tpot_seconds", stats.get("tpot_s"),
        help="decode seconds per output token (per request)",
    )
    b.summary(
        "ddp_tpu_serve_queue_wait_seconds", stats.get("queue_s"),
        help="submit to decode-lane bind",
    )
    b.summary(
        "ddp_tpu_serve_decode_tokens_per_second",
        stats.get("decode_tokens_per_s"),
    )
    b.summary(
        "ddp_tpu_serve_step_latency_seconds", stats.get("step_latency_s")
    )
    _render_slo(b, stats.get("slo"))
    _render_build_info(b, stats.get("build_info"), "ddp_tpu_build_info")
    for prog, count in sorted((stats.get("compile_counts") or {}).items()):
        b.add(
            "ddp_tpu_serve_compiled_programs", count,
            labels={"program": prog},
            help="step programs prepared: CUDA graphs captured on the "
            "card, registered eager programs elsewhere (static-shape pin "
            "observable)",
        )
    # Decode hot path: cache footprint + speculative acceptance.
    # Absent keys (spec off) render nothing — absent and zero are
    # different facts.
    dp = stats.get("decode_path") or {}
    b.add(
        "ddp_tpu_serve_cache_bytes_per_slot",
        dp.get("cache_bytes_per_slot"),
        help="KV-cache HBM per decode lane, int8 scales included",
    )
    b.add(
        "ddp_tpu_serve_spec_drafted_total", dp.get("spec_drafted_total"),
        metric_type="counter", help="draft tokens proposed",
    )
    b.add(
        "ddp_tpu_serve_spec_accepted_total",
        dp.get("spec_accepted_total"),
        metric_type="counter", help="draft tokens the target accepted",
    )
    b.add(
        "ddp_tpu_serve_spec_acceptance", dp.get("spec_acceptance"),
        help="lifetime accepted/drafted fraction",
    )
    # Paged KV + radix prefix cache: pool occupancy and prefix-reuse
    # counters. The whole block is absent-key gated on the engine's
    # paged mode, so a fixed-lane engine renders none of it.
    pg = stats.get("paged") or {}
    b.add(
        "ddp_tpu_serve_prefix_hits_total", pg.get("prefix_hits"),
        metric_type="counter",
        help="requests that matched cached prefix pages at bind",
    )
    b.add(
        "ddp_tpu_serve_prefix_misses_total", pg.get("prefix_misses"),
        metric_type="counter",
    )
    b.add(
        "ddp_tpu_serve_prefix_hit_rate", pg.get("prefix_hit_rate"),
        help="prompt tokens served from cached pages / prompt tokens "
        "admitted (token-level, lifetime)",
    )
    b.add(
        "ddp_tpu_serve_pages_free", pg.get("pages_free"),
        help="allocatable pages (excluding evictable cached prefixes)",
    )
    b.add(
        "ddp_tpu_serve_pages_resident", pg.get("pages_resident"),
        help="pages holding live KV: lane-mapped or prefix-cached",
    )
    b.add(
        "ddp_tpu_serve_pages_shared", pg.get("pages_shared"),
        help="pages mapped by two or more lanes (copy-free forks)",
    )
    # Model-lifecycle block: absent until the engine carries a model
    # version or has swapped/rolled back.
    lc = stats.get("lifecycle") or {}
    b.add(
        "ddp_tpu_serve_reloads_total", lc.get("reloads_total"),
        metric_type="counter",
        help="verified hot-swaps committed (install_params)",
    )
    b.add(
        "ddp_tpu_serve_rollbacks_total", lc.get("rollbacks_total"),
        metric_type="counter",
        help="mid-swap failures rolled back to the previous weights",
    )
    if lc.get("model_version"):
        b.add(
            "ddp_tpu_serve_model_info", 1,
            labels={"version": str(lc["model_version"])},
            help="serving model version (checkpoint@epoch), value "
            "always 1",
        )
    return b.render()
