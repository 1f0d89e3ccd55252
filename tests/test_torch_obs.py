"""ddp_tpu_torch.obs ≡ the JAX package's ddp_tpu.obs, on the CPU.

The port keeps its own copy of the serving half of ``ddp_tpu/obs``
(tracer, reqtrace, slo, recorder, promtext). Each copy is held to the
JAX module on the same inputs:

- ``validate_promtext`` accepts and rejects the same expositions, with
  the same messages; ``PromBuilder`` renders the same text.
- ``render_serve`` over the port engine's own ``stats()`` (fixed-lane,
  paged, speculative, lifecycle, SLO, request tracing, build_info):
  every sample line and ``# TYPE`` line is byte-identical to JAX's, and
  the ``# HELP`` lines differ only in HELP_DIFFERS (the lines that name
  the stack: build_info, and the compile gauges, CUDA graphs in the port
  where JAX has jit cache entries).
- ``parse_slo`` / ``parse_model_slos`` give the same objectives and the
  same ``ValueError`` messages; ``SLOEngine.state()`` equals JAX's after
  the same observations under an injected clock, and the breach hook
  fires once, at the same observation.
- Trace ids and trace contexts equal JAX's over seeded inputs
  (hypothesis), malformed contexts parse to None in both.
- The port's tracer document passes JAX's ``validate_trace_file``, its
  flight dump loads with JAX's ``load_dump``; a disabled tracer hands
  out one null span object.
"""

import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ddp_tpu.models.lm import LMSpec as JSpec
from ddp_tpu.obs import promtext as jprom
from ddp_tpu.obs import recorder as jrec
from ddp_tpu.obs import reqtrace as jrt
from ddp_tpu.obs import slo as jslo
from ddp_tpu.obs import tracer as jtracer
from ddp_tpu_torch.interop.jax_params import lm_params_from_jax
from ddp_tpu_torch.models.lm import CausalLM
from ddp_tpu_torch.obs import promtext as tprom
from ddp_tpu_torch.obs import recorder as trec
from ddp_tpu_torch.obs import reqtrace as trt
from ddp_tpu_torch.obs import slo as tslo
from ddp_tpu_torch.obs import tracer as ttracer
from ddp_tpu_torch.serve.engine import ServeEngine
from test_torch_generate import numpy_lm_tree

# A small LM: depth 2, d 64, vocab 256.
SPEC = JSpec(vocab_size=256, total_len=64, d_model=64, depth=2, num_heads=4)
DRAFT = SPEC._replace(d_model=32, depth=1, num_heads=2)

# The HELP lines that name the stack: the only lines of the two
# expositions allowed to differ.
HELP_DIFFERS = {
    "# HELP ddp_tpu_build_info package/jax/backend provenance (value is "
    "always 1)": "# HELP ddp_tpu_build_info package/torch/backend "
    "provenance (value is always 1)",
    "# HELP ddp_tpu_serve_compiled_programs jit cache entries (static-shape "
    "pin observable)": "# HELP ddp_tpu_serve_compiled_programs step "
    "programs prepared: CUDA graphs captured on the card, registered eager "
    "programs elsewhere (static-shape pin observable)",
}


def _model(spec=SPEC, seed=0):
    mspec, state = lm_params_from_jax(numpy_lm_tree(spec, seed),
                                      num_heads=spec.num_heads)
    return CausalLM.from_state(mspec, state, "cpu")


# ---- promtext --------------------------------------------------------------

PROM_CASES = [
    ("x 1", False),  # no trailing newline
    ("x 1\nx 1\n", False),
    ('x{l="a"} 1\nx{l="a"} 2\n', False),
    ("1bad 2\n", False),
    ("x notanumber\n", False),
    ('x{l="unclosed} 1\n', False),
    ("x 1\n# TYPE x gauge\n", False),
    ("# TYPE x gauge\n# TYPE x gauge\nx 1\n", False),
    ("# TYPE x wrongtype\nx 1\n", False),
    ('x{a="1",a="2"} 1\n', False),
    ("# HELP 0x bad\n", False),
    ("x NaN\ny +Inf\nz -Inf\n", True),
    ('x{l="quo\\"ted\\\\path"} 7\n', True),
    ("# TYPE x counter\nx 1 1700000000\n# free comment\n\n", True),
    ('x{a="1",b="2"} 1\nx{a="1",b="3"} 1\n', True),
    ("", False),
]


@pytest.mark.parametrize("text,ok", PROM_CASES,
                         ids=[f"case{i}" for i in range(len(PROM_CASES))])
def test_validate_promtext_agrees_with_jax(text, ok):
    outcomes = []
    for mod in (tprom, jprom):
        try:
            outcomes.append(("ok", mod.validate_promtext(text)))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0][0] == "ok") == ok


def test_prom_builder_renders_and_refuses_like_jax():
    def build(mod):
        b = mod.PromBuilder()
        b.add("up", 1, help="liveness")
        b.add("requests_total", 7, labels={"status": 'quo"ted\\path'},
              metric_type="counter")
        b.add("requests_total", 2, labels={"status": "other"},
              metric_type="counter")
        b.add("missing", None)
        b.summary("latency_seconds",
                  {"count": 4, "mean": 0.5, "sum": 2.25, "min": 0.1,
                   "p50": 0.4, "p95": 0.9, "max": 1.0}, help="end to end")
        b.summary("empty_seconds", {"count": 0})
        errors = []
        for args, kw in ((("1bad", 1), {}),
                         (("ok", 1), {"labels": {"0bad": "x"}}),
                         (("up", 2), {}),
                         (("up", 2), {"labels": {"a": "y"},
                                      "metric_type": "counter"}),
                         (("x", 1), {"metric_type": "nope"})):
            try:
                b.add(*args, **kw)
            except ValueError as e:
                errors.append(str(e))
        return b.render(), errors

    ours, theirs = build(tprom), build(jprom)
    assert ours == theirs
    assert len(ours[1]) == 5 and tprom.validate_promtext(ours[0]) == 10
    assert tprom.CONTENT_TYPE == jprom.CONTENT_TYPE


def _stats_case(kind):
    """A port engine of ``kind`` after a little traffic → its stats()."""
    model = _model()
    kw = dict(slots=2, prefill_len=16, prefill_chunk=8, min_bucket=4,
              trace_seed=3)
    if kind == "paged":
        kw["page_size"] = 8
    if kind == "spec":
        kw.update(spec_tokens=2, draft_model=_model(DRAFT, 1))
    if kind == "lifecycle":
        kw["model_version"] = "ck@epoch3"
    if kind in ("slo", "everything"):
        kw["slo"] = tslo.SLOEngine(
            "ttft_p99<0.5s,tpot_p50<80ms,availability>0.999",
            min_eval_interval_s=0.0)
    if kind in ("reqtrace", "everything"):
        kw["reqtrace"] = True
    if kind == "everything":
        kw.update(page_size=8, model_version="v1")
    eng = ServeEngine(model, **kw)
    base = list(range(1, 12))
    eng.submit(base, 4, temperature=0.7, seed=1)
    eng.submit(base + [5], 3, trace=trt.encode_trace_context(9, 4)
               if kind == "everything" else None)
    eng.submit([1] * 40, 2)  # prompt_too_long: a reject count
    eng.run()
    eng.submit(base, 2)  # a prefix hit on paged engines
    eng.run()
    if kind == "lifecycle":
        eng.rollbacks_total += 1
    return eng.stats()


def _split(text):
    lines = text.splitlines()
    return ([l for l in lines if not l.startswith("# HELP")],
            [l for l in lines if l.startswith("# HELP")])


@pytest.mark.parametrize("kind", ["fixed", "paged", "spec", "lifecycle",
                                  "slo", "reqtrace", "everything"])
@pytest.mark.parametrize("up,draining", [(None, None), (True, False),
                                         (False, True)])
def test_render_serve_matches_jax(kind, up, draining):
    stats = json.loads(json.dumps(_stats_case(kind)))  # as /stats serves it
    ours = tprom.render_serve(stats, up=up, draining=draining)
    theirs = jprom.render_serve(stats, up=up, draining=draining)
    tprom.validate_promtext(ours)
    o_lines, o_help = _split(ours)
    t_lines, t_help = _split(theirs)
    assert o_lines == t_lines  # samples and TYPE lines, byte for byte
    assert o_help == [HELP_DIFFERS.get(h, h) for h in t_help]
    assert "ddp_tpu_build_info{" in ours
    has_slo = kind in ("slo", "everything")
    assert ("ddp_tpu_slo_target" in ours) == has_slo
    if kind == "paged":
        assert "ddp_tpu_serve_prefix_hits_total 1" in ours


# ---- slo -------------------------------------------------------------------

SLO_SPECS = [
    "ttft_p99<0.5s,tpot_p50<80ms,availability>0.999",
    "queue_p95<2",
    "ttft_p99.9<250ms",
    "ttft_p99.0<1s",
    " tpot_p50<0.08s , availability>0.5 ,",
    "ttft<0.5s",
    "ttft_p99>0.5s",
    "availability<0.999",
    "availability>1.5",
    "availability_p99>0.9",
    "bogus_p50<1s",
    "ttft_p0<1s",
    "ttft_p100<1s",
    "ttft_p99<0s",
    "ttft_p99<1s,ttft_p99<2s",
    "",
    "&&&",
    "ttft_p99<1h",
]


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SLO_SPECS)
def test_parse_slo_matches_jax(spec):
    ours, theirs = _outcome(tslo.parse_slo, spec), _outcome(jslo.parse_slo,
                                                            spec)
    assert ours[0] == theirs[0]
    if ours[0] == "ok":
        assert [o.__dict__ for o in ours[1]] == [o.__dict__ for o in theirs[1]]
    else:
        assert ours == theirs


@pytest.mark.parametrize("spec", [
    "ttft_p99<0.5s",
    "ttft_p99<0.5s;draft:ttft_p99<0.2s,availability>0.99",
    "a:ttft_p50<1s;b.c-d:queue_p90<3s",
    "ttft_p99<1s;ttft_p50<1s",
    "x:ttft_p99<1s;x:ttft_p50<1s",
    "draft:bogus<1",
    ";;",
])
def test_parse_model_slos_matches_jax(spec):
    assert _outcome(tslo.parse_model_slos, spec) == _outcome(
        jslo.parse_model_slos, spec)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_slo_engine_state_matches_jax():
    """Seeded observations (good, slow, failed, latency-less) across both
    windows; states equal after every observation, and each engine's
    breach hook fires at the same observations."""
    rng = np.random.default_rng(0)
    engines, clocks, breaches = [], [], []
    for mod in (tslo, jslo):
        clock, hits = _Clock(), []
        engines.append(mod.SLOEngine(
            "ttft_p99<0.2s,tpot_p50<80ms,queue_p90<1s,availability>0.9",
            fast_window_s=10.0, slow_window_s=60.0, min_eval_interval_s=0.5,
            clock=clock, on_breach=hits.append))
        clocks.append(clock)
        breaches.append(hits)
    fired_at = [[], []]
    for n in range(400):
        t = n * 0.37
        ttft = float(rng.exponential(0.1)) if rng.random() > 0.1 else None
        obs = dict(ttft_s=ttft, tpot_s=float(rng.uniform(0.01, 0.12)),
                   queue_s=float(rng.exponential(0.3)),
                   ok=bool(rng.random() > (0.3 if 100 < n < 180 else 0.02)))
        for k, (eng, clock) in enumerate(zip(engines, clocks)):
            clock.t = t
            before = len(breaches[k])
            eng.observe(**obs)
            fired_at[k] += [n] * (len(breaches[k]) - before)
        assert engines[0].state() == engines[1].state()
    assert fired_at[0] == fired_at[1] and fired_at[0]
    assert breaches[0] == breaches[1]
    assert engines[0].breach_counts == engines[1].breach_counts


# ---- trace ids and contexts --------------------------------------------------

U64 = st.integers(min_value=0, max_value=2**64 - 1)


@settings(max_examples=200, deadline=None)
@given(seed=U64, rid=st.integers(min_value=0, max_value=2**40),
       span=U64, parent=U64)
def test_trace_ids_and_contexts_match_jax(seed, rid, span, parent):
    tid = trt.derive_trace_id(seed, rid)
    assert tid == jrt.derive_trace_id(seed, rid) and tid != 0
    assert trt.splitmix64(seed) == jrt.splitmix64(seed)
    assert trt.format_trace_id(tid) == jrt.format_trace_id(tid)
    assert trt.derive_span_id(tid, rid) == jrt.derive_span_id(tid, rid)
    line = trt.encode_trace_context(tid, span, parent)
    assert line == jrt.encode_trace_context(tid, span, parent)
    assert trt.parse_trace_context(line) == jrt.parse_trace_context(line) \
        == (tid, span, parent)


@pytest.mark.parametrize("line", [
    None, 7, "", "00-1-2-3", "01-" + "0" * 15 + "1-" + "0" * 16 + "-" + "0" * 16,
    "00-" + "0" * 16 + "-" + "0" * 16 + "-" + "0" * 16,  # zero trace id
    "00-" + "g" * 16 + "-" + "0" * 16 + "-" + "0" * 16,
    "00-" + "a" * 16 + "-" + "b" * 16,
    "  00-" + "a" * 16 + "-" + "b" * 16 + "-" + "c" * 16 + "\n",
    "00-" + "a" * 17 + "-" + "b" * 16 + "-" + "c" * 16,
])
def test_parse_trace_context_edge_cases_match_jax(line):
    assert trt.parse_trace_context(line) == jrt.parse_trace_context(line)


# ---- tracer and recorder -----------------------------------------------------


def test_disabled_tracer_is_free():
    """One cached null span, every call; every recording path a no-op."""
    tr = ttracer.Tracer()
    first = tr.span("a")
    assert all(tr.span(f"n{i}", {"i": i}) is first for i in range(100))
    with first:
        pass
    tr.instant("i")
    tr.counter("c", {"v": 1})
    tr.complete("x", 0.0, 1.0)
    tr.async_complete("r", 0.0, 1.0, "0x1")
    tr.async_instant("r", 0.0, "0x1")
    snap = tr.snapshot()
    assert snap["traceEvents"] == [] and snap["span_summaries"] == {}
    assert snap["enabled"] is False


def test_tracer_document_passes_jax_validation(tmp_path):
    """Every event kind the engine writes, a bounded ring, per-name
    summaries; the exported document loads with JAX's validator and
    carries the same layout as JAX's tracer's for the same events."""
    docs = []
    for mod in (ttracer, jtracer):
        tr = mod.Tracer(enabled=True, ring_events=8, process_id=3)
        for i in range(6):
            with tr.span("serve.decode", {"lanes": i}):
                pass
        tr.instant("mark")
        tr.counter("hbm", {"used": 1.0})
        tr.complete("serve.sample", 1.0, 0.25, {"tokens": 2})
        tr.async_complete("request", 1.0, 0.5, "0x01", {"rid": 0})
        tr.async_instant("req.admit", 1.0, "0x01")
        path = tr.export_to_dir(str(tmp_path / mod.__name__))
        assert os.path.basename(path) == "trace_rank3.trace.json"
        docs.append(jtracer.validate_trace_file(path))
        assert ttracer.validate_trace_file(path) == docs[-1]
    ours, theirs = docs
    assert len(ours["traceEvents"]) == len(theirs["traceEvents"]) == 9

    def shape(doc):
        return [(e["ph"], e["name"], e.get("cat"), e.get("id"), e.get("args"),
                 "dur" in e) for e in doc["traceEvents"]]

    assert shape(ours) == shape(theirs)
    assert ours["ddp_tpu"]["dropped_events"] == 4  # 12 events, ring 8
    assert set(ours["ddp_tpu"]) == set(theirs["ddp_tpu"])
    assert ours["ddp_tpu"]["span_summaries"]["serve.decode"]["count"] == 6


def test_validate_trace_file_rejects_like_jax(tmp_path):
    bad = [
        "{not json",
        "[]",
        '{"traceEvents": 1}',
        '{"traceEvents": [1]}',
        '{"traceEvents": [{"name": "x"}]}',
        '{"traceEvents": [{"ph": "X", "name": "x", "ts": 1, "pid": 0, '
        '"tid": 0}]}',
        '{"traceEvents": [{"ph": "b", "name": "x", "ts": 1, "pid": 0, '
        '"tid": 0, "cat": "request"}]}',
        '{"traceEvents": [{"ph": "i", "name": "x", "pid": 0, "tid": 0}]}',
    ]
    for i, text in enumerate(bad):
        path = tmp_path / f"{i}.json"
        path.write_text(text)
        with pytest.raises(ValueError) as ours:
            ttracer.validate_trace_file(str(path))
        with pytest.raises(ValueError) as theirs:
            jtracer.validate_trace_file(str(path))
        assert str(ours.value) == str(theirs.value)


def test_flight_dump_loads_with_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "never-copied")
    rec = trec.FlightRecorder(str(tmp_path), rank=2, capacity=3,
                              clock=lambda: 5.0)
    rec.set_context(build_info=trec.build_info(), env=trec.snapshot_env())
    rec.set_provider("live", lambda: {"x": float("nan")})
    rec.set_provider("broken", lambda: 1 / 0)
    for i in range(5):
        rec.record("slo_breach", objective="ttft_p99", current=float(i))
    path = rec.dump("shutdown")
    assert path == str(tmp_path / "flight_rank2.json")
    doc = jrec.load_dump(path)
    assert doc == trec.load_dump(path)
    assert doc["reason"] == "shutdown" and doc["rank"] == 2
    assert [r["current"] for r in doc["records"]] == [2.0, 3.0, 4.0]
    assert doc["extras"] == {"live": {"x": None},
                             "broken": {"provider_error": "ZeroDivisionError"}}
    env = doc["context"]["env"]
    assert env["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert all(k.startswith(("CUDA_", "NCCL_", "TORCH_", "PYTORCH_",
                             "DDP_TPU_")) for k in env["env"])
    assert "torch" in env and "jax" not in env
    bi = doc["context"]["build_info"]
    assert set(bi) == {"version", "torch", "cuda", "backend", "platform",
                       "device"}
    assert bi["backend"] == "cpu" and bi["platform"] == "cpu"
    assert trec.FlightRecorder(None).dump("x") is None
