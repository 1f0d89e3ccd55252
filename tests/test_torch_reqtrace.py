"""Request tracing and spans in the port's engine ≡ the JAX engine's.

A small LM (vocab 256, d 64, depth 2, 4 heads; the speculative draft d
32, depth 1, 2 heads), weights made with numpy and carried to both
engines (JAX through the tree, the port through ``lm_params_from_jax``),
the same submission schedule on each:

- The trace ids are equal (same ``trace_seed``, same rids), and each
  request's event sequence is equal: kinds, prefill chunk ``start`` /
  ``bucket`` / ``tokens`` / ``final``, spec rounds' ``drafted`` /
  ``accepted`` / ``emitted``, the decode span's steps and tokens, the
  retire reason (timestamps are not compared). Fixed-lane, paged (a
  prefix hit included) and speculative engines.
- The port's exported trace passes JAX's ``validate_trace_file``,
  ``reconstruct_requests`` and ``validate_request_timeline``.
- Tracing changes nothing: greedy streams with the tracer's measuring
  mode, request tracing and an SLO engine on equal those with all off.
- Off is free: no per-request objects, no ``slo``/``reqtrace`` keys in
  the stats; request tracing never waits on the device, the measuring
  mode waits once a span.
"""

import functools
import json

import jax.numpy as jnp
import pytest

from ddp_tpu.obs import reqtrace as jrt
from ddp_tpu.obs import tracer as jtracer
from ddp_tpu.serve.engine import ServeEngine as JEngine
from ddp_tpu_torch.interop.jax_params import lm_params_from_jax
from ddp_tpu_torch.models.lm import CausalLM
from ddp_tpu_torch.obs.recorder import FlightRecorder
from ddp_tpu_torch.obs.slo import SLOEngine
from ddp_tpu_torch.obs.tracer import Tracer
from ddp_tpu_torch.serve import engine as engine_mod
from ddp_tpu_torch.serve.engine import (
    COMPLETE,
    TIMEOUT_QUEUE,
    ServeEngine,
)
from ddp_tpu_torch.utils.metrics import MetricsWriter
from test_torch_generate import numpy_lm_tree
from test_torch_obs import DRAFT, SPEC

SEED = 11  # trace_seed on both engines
KNOBS = dict(slots=2, prefill_len=24, prefill_chunk=8, min_bucket=4)
# Bucket edges, a 3-chunk prompt, staggered admission; the third and the
# fifth share their first 16 tokens, and so does HIT, sent once the rest
# retired (a paged engine's prefix hit).
SCHEDULE = [
    ([(7 * i + 3) % 256 for i in range(5)], 6),
    ([(11 * i + 1) % 256 for i in range(21)], 4),
    ([(5 * i + 2) % 256 for i in range(16)] + [9, 8, 7], 5),
    ([(3 * i + 9) % 256 for i in range(8)], 3),
    ([(5 * i + 2) % 256 for i in range(16)] + [1, 2], 4),
]
HIT = ([(5 * i + 2) % 256 for i in range(16)] + [3, 3, 3], 3)


@functools.lru_cache(maxsize=None)
def _pair(jspec, seed):
    tree = numpy_lm_tree(jspec, seed)
    spec, state = lm_params_from_jax(tree, num_heads=jspec.num_heads)
    jtree = _jax_tree(tree)
    return jtree, CausalLM.from_state(spec, state, "cpu")


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _layout(layout) -> dict:
    return {"fixed": {}, "paged": {"page_size": 8},
            "spec": {"spec_tokens": 3}}[layout]


def _port(layout, **kw):
    """The port's engine for ``layout`` (the draft under ``spec``)."""
    if layout == "spec":
        kw["draft_model"] = _pair(DRAFT, 1)[1]
    return ServeEngine(_pair(SPEC, 0)[1], **KNOBS, **_layout(layout), **kw)


def _engines(layout):
    """(port engine, JAX engine) for ``layout``, request tracing on."""
    knobs = dict(_layout(layout), reqtrace=True, trace_seed=SEED)
    if layout == "spec":
        knobs.update(draft_spec=DRAFT, draft_params=_pair(DRAFT, 1)[0])
    jeng = JEngine(SPEC, _pair(SPEC, 0)[0], decode_attn="reference",
                   **KNOBS, **knobs)
    knobs.pop("draft_spec", None)
    knobs.pop("draft_params", None)
    return _port(layout, **{k: v for k, v in knobs.items()
                            if k not in _layout(layout)}), jeng


def _run(eng):
    """SCHEDULE, staggered, run to idle; then HIT alone → (rids, done)."""
    rids = []
    for i, (prompt, n) in enumerate(SCHEDULE):
        rids.append(eng.submit(prompt, n).request.rid)
        if i % 2 == 0:
            eng.step()  # staggered admission: mixed-age batches
    eng.run()
    rids.append(eng.submit(*HIT).request.rid)
    eng.run()
    done = [eng.result(r) for r in rids]
    assert all(c.status == COMPLETE for c in done)
    return rids, done


def _sequence(timeline):
    return [(e["name"], e.get("args")) for e in timeline["events"]]


@pytest.mark.parametrize("layout", ["fixed", "paged", "spec"])
def test_event_sequences_match_jax_engine(layout):
    port, jeng = _engines(layout)
    rids, ours = _run(port)
    jrids, theirs = _run(jeng)
    assert rids == jrids
    assert [c.tokens for c in ours] == [c.tokens for c in theirs]
    for rid, a, b in zip(rids, ours, theirs):
        assert a.trace["trace_id"] == b.trace["trace_id"] == (
            jrt.format_trace_id(jrt.derive_trace_id(SEED, rid)))
        ta, tb = port.request_timeline(rid), jeng.request_timeline(rid)
        assert _sequence(ta) == _sequence(tb)
        assert ta["live"] is tb["live"] is False
        # The digest's counts (timings apart) agree too.
        for key in ("prefill_chunks", "decode_steps", "reason", "spec"):
            assert a.trace.get(key) == b.trace.get(key)
    names = {n for rid in rids for n, _ in _sequence(port.request_timeline(rid))}
    assert ("req.spec_round" in names) == (layout == "spec")
    if layout == "paged":
        assert ours[-1].prefix_hit_tokens == 16
        chunks = [a for n, a in _sequence(port.request_timeline(rids[-1]))
                  if n == "req.prefill_chunk"]
        assert chunks[0]["start"] == 16  # the hit skipped the prefix
    assert port.stats()["reqtrace"] == jeng.stats()["reqtrace"]


def test_exported_trace_passes_jax_reconstruction(tmp_path):
    """Measuring-mode spans and request spans in one exported document:
    JAX's validator, reconstruction and causal check take it, and every
    request's reconstructed events are its /requestz timeline's."""
    jparams, model = _pair(SPEC, 0)
    tracer = Tracer(enabled=True, process_id=1)
    eng = ServeEngine(model, **KNOBS, page_size=8, reqtrace=True,
                      trace_seed=SEED, tracer=tracer)
    rids, done = _run(eng)
    assert eng.emit_request_spans() == 0  # already emitted at retire
    path = tracer.export_to_dir(str(tmp_path))
    doc = jtracer.validate_trace_file(path)
    by_id = jrt.reconstruct_requests(doc["traceEvents"])
    assert set(by_id) == {c.trace["trace_id"] for c in done}
    for rid, c in zip(rids, done):
        timeline = by_id[c.trace["trace_id"]]
        summary = jrt.validate_request_timeline(timeline)
        assert summary["reason"] == COMPLETE
        want = [e["name"] for e in eng.request_timeline(rid)["events"]]
        # Sorted: the queue span begins at the admit instant's stamp.
        assert sorted(e["name"] for e in timeline
                      if e["name"] != "request") == sorted(want)
    spans = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"serve.prefill_chunk", "serve.decode", "serve.sample"} <= spans
    assert set(tracer.summaries()) == spans


@pytest.mark.parametrize("layout", ["fixed", "paged", "spec"])
def test_tracing_changes_no_token(layout, tmp_path):
    """Greedy and seeded streams with everything on (the measuring mode,
    request tracing, an SLO engine, a flight recorder) equal those with
    everything off."""
    streams = []
    for kw in ({}, dict(tracer=Tracer(enabled=True), reqtrace=True,
                        slo=SLOEngine("ttft_p99<1ms,availability>0.999"),
                        recorder=FlightRecorder(str(tmp_path)))):
        port = _port(layout, **kw)
        rid = port.submit([4, 5, 6], 5, temperature=0.8, seed=3).request.rid
        _, done = _run(port)
        streams.append([c.tokens for c in done] + [port.result(rid).tokens])
    assert streams[0] == streams[1]


def test_off_is_free_and_keeps_the_stats_schema(monkeypatch):
    """reqtrace off: no request tracer, no digest, no trace_id; the stats
    keys are the untraced engine's plus build_info and compile_counts
    (JAX's /stats has both). Request tracing on
    (tracer off) never waits on the device; the measuring mode waits
    once a chunk or decode span."""
    waits = []
    monkeypatch.setattr(engine_mod.ServeEngine, "_wait_device",
                        lambda self: waits.append(1))
    _, model = _pair(SPEC, 0)
    eng = ServeEngine(model, **KNOBS)
    _, done = _run(eng)
    assert eng._reqtrace is None and all(c.trace is None for c in done)
    assert eng.request_timeline(0) is None and eng.emit_request_spans() == 0
    assert set(eng.stats()) == {
        "slots", "active", "queue_depth", "steps", "decode_steps",
        "completed", "tokens_total", "ttft_s", "tpot_s", "queue_s",
        "decode_tokens_per_s", "step_latency_s", "rejects",
        "requests_by_status", "build_info", "compile_counts", "prefill",
        "decode_path", "device"}
    assert eng.tracer.snapshot()["traceEvents"] == []
    traced = ServeEngine(model, **KNOBS, reqtrace=True,
                         slo=SLOEngine("ttft_p99<1s"))
    _run(traced)
    assert waits == []
    assert {"slo", "reqtrace"} <= set(traced.stats())
    measured = ServeEngine(model, **KNOBS, tracer=Tracer(enabled=True))
    _run(measured)
    spans = measured.tracer.summaries()
    assert len(waits) == (spans["serve.prefill_chunk"]["count"]
                          + spans["serve.decode"]["count"]) > 0


def test_inbound_contexts_and_retention():
    """A valid context is adopted (its trace id, its span as parent) and
    counted propagated; a malformed one counted orphaned and served under
    a local id; the retired ring keeps reqtrace_keep timelines; lookups by
    rid and by hex trace id agree."""
    _, model = _pair(SPEC, 0)
    eng = ServeEngine(model, **KNOBS, reqtrace=True, reqtrace_keep=2,
                      trace_seed=SEED)
    good = jrt.encode_trace_context(0xFEED, 0xBEEF, 7)
    a = eng.submit([1, 2, 3], 2, trace=good).request
    b = eng.submit([1, 2, 3], 2, trace="00-zz").request
    c = eng.submit([1, 2, 3], 2).request
    assert eng.stats()["reqtrace"] == {"live": 3, "retained": 0,
                                       "propagated": 1, "orphaned": 1}
    eng.run()
    assert a.trace_id == 0xFEED
    assert eng.result(a.rid).trace["parent"] == f"{0xBEEF:016x}"
    assert b.trace_id == jrt.derive_trace_id(SEED, b.rid)
    assert "parent" not in eng.result(b.rid).trace
    assert eng.stats()["reqtrace"]["retained"] == 2
    assert eng.request_timeline(a.rid) is None  # aged out of the ring
    key = eng.result(c.rid).trace["trace_id"]
    assert eng.request_timeline(key) == eng.request_timeline(str(c.rid))
    assert eng.request_timeline("0xnothex") is None


def test_queue_timeout_retires_a_timeline_and_feeds_the_slo(tmp_path):
    """A request that times out in the queue still retires a timeline
    (admit, retire; no bind) and counts against availability; the
    breach lands once in the metrics stream and the flight recorder."""
    _, model = _pair(SPEC, 0)
    clock = [0.0]
    writer = MetricsWriter(str(tmp_path / "m.jsonl"))
    rec = FlightRecorder(str(tmp_path))
    slo = SLOEngine("availability>0.9", min_eval_interval_s=0.0,
                    clock=lambda: clock[0])
    eng = ServeEngine(model, slots=1, prefill_len=24, reqtrace=True,
                      clock=lambda: clock[0], slo=slo, recorder=rec,
                      metrics=writer)
    eng.submit([1, 2, 3], 20)
    late = eng.submit([4, 5], 2, timeout=1.0).request.rid
    eng.step()
    clock[0] = 5.0
    eng.run()
    writer.close()
    c = eng.result(late)
    assert c.status == TIMEOUT_QUEUE
    timeline = eng.request_timeline(late)
    assert [e["name"] for e in timeline["events"]] == ["req.admit",
                                                       "req.retire"]
    assert timeline["summary"]["reason"] == TIMEOUT_QUEUE
    state = eng.stats()["slo"]["objectives"][0]
    assert state["current"] == 0.5 and state["breaches"] == 1
    records = [json.loads(line) for line in
               open(tmp_path / "m.jsonl").read().splitlines()]
    breaches = [r for r in records if r["kind"] == "slo_breach"]
    assert len(breaches) == 1 and breaches[0]["objective"] == "availability"
    reqs = {r["rid"]: r for r in records if r["kind"] == "serve_request"}
    assert reqs[late]["trace_id"] == c.trace["trace_id"]
    dump = rec.dump("test")
    ring = json.load(open(dump))["records"]
    assert [r["kind"] for r in ring] == ["slo_breach"]
    # A second engine over the same SLOEngine keeps the caller's hook,
    # not the first engine's interceptor.
    seen = []
    slo.on_breach = seen.append
    ServeEngine(model, slots=1, prefill_len=24, slo=slo)
    eng2 = ServeEngine(model, slots=1, prefill_len=24, slo=slo)
    assert eng2._user_breach_cb == seen.append
