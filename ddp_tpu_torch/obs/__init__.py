"""Serving observability: spans, request traces, SLOs, the flight
recorder and the Prometheus exposition.

The PyTorch port's copy of the serving half of ``ddp_tpu/obs`` (pure
host code, with the same module names, JSON shapes and metric names, so
one dashboard or trace merger reads either package's output):

- ``tracer``   — span tracer with a bounded ring and crash-safe export to
  Perfetto/Chrome ``trace_event`` JSON; disabled, it costs nothing;
- ``reqtrace`` — per-request tracing: a 64-bit trace id at admission and
  lifecycle events (admit → queue → prefill chunks → spec rounds →
  decode → retire) stamped where the engine already touches the host;
- ``slo``      — declarative objectives (``ttft_p99<0.5s,...``) over
  rolling windows with multi-window burn-rate alerting;
- ``recorder`` — the flight recorder: a bounded ring dumped crash-safely
  on shutdown, and the ``build_info`` provenance block;
- ``promtext`` — ``ServeEngine.stats()`` as Prometheus text (``/metricsz``)
  with its lint.

All off by default. Wiring: ``serve/engine.py`` (spans, request traces,
the SLO feed), ``serve/server.py`` (``/metricsz``, ``/statusz``,
``/requestz``) and ``python -m ddp_tpu_torch.serve`` (``--trace_dir``,
``--reqtrace``, ``--slo``, ``--flight_dir``).
"""

from ddp_tpu_torch.obs.promtext import render_serve, validate_promtext
from ddp_tpu_torch.obs.recorder import FlightRecorder, build_info
from ddp_tpu_torch.obs.reqtrace import (
    RequestTrace,
    RequestTracer,
    derive_trace_id,
    format_trace_id,
    reconstruct_requests,
    validate_request_timeline,
)
from ddp_tpu_torch.obs.slo import Objective, SLOEngine, parse_slo
from ddp_tpu_torch.obs.tracer import Tracer, validate_trace_file

__all__ = [
    "FlightRecorder",
    "Objective",
    "RequestTrace",
    "RequestTracer",
    "SLOEngine",
    "Tracer",
    "build_info",
    "derive_trace_id",
    "format_trace_id",
    "parse_slo",
    "reconstruct_requests",
    "render_serve",
    "validate_promtext",
    "validate_request_timeline",
    "validate_trace_file",
]
