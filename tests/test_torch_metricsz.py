"""The port's observability routes and flags, on the CPU.

- ``GET /metricsz``: Prometheus text with its content type, the linted
  rendering of ``/stats`` (up, draining); with everything off there is
  no ``ddp_tpu_slo_*`` series and no reqtrace count anywhere.
- ``GET /statusz``: ``ok``, ``draining``, ``stats`` with the summaries'
  states, the span tracer's tail (a traceEvents document JAX's
  validator loads) and, with named models, a ``models`` block.
- ``GET /requestz``: 404 when tracing is off; with it on, the recent set
  and one timeline by rid or 0x trace id, 404 for an unknown id.
- ``POST /generate`` with a ``trace`` context: a valid one is echoed and
  counted propagated, a malformed one counted orphaned and still served.
- ``python -m ddp_tpu_torch.serve`` with ``--reqtrace --slo --trace_dir
  --flight_dir``: the exported trace and the flight dump load with the
  JAX package's tools; an ``--slo`` group naming an unregistered model
  exits.
"""

import contextlib
import io
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from ddp_tpu.obs import promtext as jprom
from ddp_tpu.obs import recorder as jrec
from ddp_tpu.obs import reqtrace as jrt
from ddp_tpu.obs import tracer as jtracer
from ddp_tpu_torch.obs.promtext import CONTENT_TYPE, validate_promtext
from ddp_tpu_torch.obs.slo import SLOEngine
from ddp_tpu_torch.obs.tracer import Tracer
from ddp_tpu_torch.serve.__main__ import main as serve_main
from ddp_tpu_torch.serve.engine import COMPLETE, ServeEngine
from ddp_tpu_torch.serve.server import LMServer
from test_torch_obs import _model


def _get(url, route):
    """GET → (status, content type, body: text for /metricsz, else JSON)."""
    try:
        with urllib.request.urlopen(url + route, timeout=30) as r:
            status, ctype, raw = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        status, ctype, raw = e.code, e.headers["Content-Type"], e.read()
    body = raw.decode() if ctype == CONTENT_TYPE else json.loads(raw)
    return status, ctype, body


def _post(url, body):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_metricsz_lints_and_agrees_with_stats():
    eng = ServeEngine(_model(), slots=2, prefill_len=16, page_size=8)
    with LMServer(eng) as srv:
        _post(srv.url, {"prompt_tokens": list(range(1, 12)),
                        "max_new_tokens": 4})
        _post(srv.url, {"prompt_tokens": list(range(1, 12)),
                        "max_new_tokens": 2})
        status, ctype, text = _get(srv.url, "/metricsz")
        _, _, stats = _get(srv.url, "/stats")
        srv.begin_drain()
        _, _, drained = _get(srv.url, "/metricsz")
    assert status == 200 and ctype == CONTENT_TYPE
    assert validate_promtext(text) == jprom.validate_promtext(text) > 20
    lines = text.splitlines()
    want = {
        "ddp_tpu_serve_up": 1, "ddp_tpu_serve_draining": 0,
        "ddp_tpu_serve_steps_total": stats["steps"],
        "ddp_tpu_serve_tokens_total": stats["tokens_total"],
        'ddp_tpu_serve_requests_total{status="complete"}': 2,
        "ddp_tpu_serve_prefix_hits_total": stats["paged"]["prefix_hits"],
        "ddp_tpu_serve_prefix_misses_total": stats["paged"]["prefix_misses"],
        "ddp_tpu_serve_pages_free": stats["paged"]["pages_free"],
        "ddp_tpu_serve_pages_resident": stats["paged"]["pages_resident"],
    }
    for name, value in want.items():
        assert f"{name} {value}" in lines, name
    assert stats["paged"]["prefix_hits"] == 1
    assert "ddp_tpu_serve_draining 1" in drained.splitlines()
    # Everything off: no SLO family, nothing of request tracing.
    assert "ddp_tpu_slo_" not in text and "reqtrace" not in stats
    info = [l for l in lines if l.startswith("ddp_tpu_build_info{")]
    assert len(info) == 1 and 'backend="cpu"' in info[0]


def test_statusz_fields_and_named_models():
    tracer = Tracer(enabled=True)
    eng = ServeEngine(_model(), slots=2, prefill_len=16, tracer=tracer,
                      slo=SLOEngine("ttft_p99<0.5s", min_eval_interval_s=0.0))
    other = ServeEngine(_model(seed=2), slots=1, prefill_len=16)
    with LMServer(eng, models={"other": other}) as srv:
        _post(srv.url, {"prompt_tokens": [1, 2, 3], "max_new_tokens": 3})
        _post(srv.url, {"prompt_tokens": [1, 2], "max_new_tokens": 2,
                        "model": "other"})
        status, _, doc = _get(srv.url, "/statusz")
        _, _, text = _get(srv.url, "/metricsz")
    assert status == 200
    assert set(doc) == {"ok", "draining", "stats", "models", "trace"}
    assert doc["ok"] is True and doc["draining"] is False
    assert set(doc["stats"]["summary_states"]) == {
        "ttft_s", "tpot_s", "queue_s", "decode_tokens_per_s"}
    assert doc["stats"]["slo"]["objectives"][0]["name"] == "ttft_p99"
    assert set(doc["models"]) == {"other"}
    assert doc["models"]["other"]["requests_by_status"] == {COMPLETE: 1}
    assert "slo" not in doc["models"]["other"]
    trace = doc["trace"]
    assert trace["enabled"] is True
    assert {e["name"] for e in trace["traceEvents"]} >= {
        "serve.prefill_chunk", "serve.decode", "serve.sample"}
    assert "serve.decode" in trace["span_summaries"]
    for name in ("target", "current", "burn_rate", "breached"):
        assert f"ddp_tpu_slo_{name}{{" in text


def test_requestz_off_and_on_and_trace_echo(tmp_path):
    off = ServeEngine(_model(), slots=2, prefill_len=16)
    with LMServer(off) as srv:
        status, _, body = _get(srv.url, "/requestz")
        assert status == 404 and "request tracing is off" in body["error"]
        reply = _post(srv.url, {"prompt_tokens": [1, 2], "max_new_tokens": 2,
                                "trace": jrt.encode_trace_context(5, 6)})
        assert reply["trace_id"] == jrt.format_trace_id(5)
    on = ServeEngine(_model(), slots=2, prefill_len=16, reqtrace=True,
                     trace_seed=4)
    good = jrt.encode_trace_context(0xABC, 0xDEF)
    with LMServer(on) as srv:
        plain = _post(srv.url, {"prompt_tokens": [3, 1, 4],
                                "max_new_tokens": 3})
        adopted = _post(srv.url, {"prompt_tokens": [3, 1], "max_new_tokens": 2,
                                  "trace": good})
        orphan = _post(srv.url, {"prompt_tokens": [3], "max_new_tokens": 2,
                                 "trace": "00-nope"})
        _, _, listing = _get(srv.url, "/requestz")
        by_rid = _get(srv.url, f"/requestz?id={plain['rid']}")
        tid = jrt.format_trace_id(jrt.derive_trace_id(4, plain["rid"]))
        by_id = _get(srv.url, f"/requestz?id={tid}")
        missing = _get(srv.url, "/requestz?id=0x1234")
        _, _, stats = _get(srv.url, "/stats")
    assert "trace_id" not in plain and "trace_id" not in orphan
    assert adopted["trace_id"] == jrt.format_trace_id(0xABC)
    assert orphan["status"] == COMPLETE and len(orphan["tokens"]) == 2
    assert stats["reqtrace"] == {"live": 0, "retained": 3, "propagated": 1,
                                 "orphaned": 1}
    assert listing["enabled"] is True and listing["live"] == 0
    assert [r["rid"] for r in listing["recent"]] == [2, 1, 0]
    assert by_rid[0] == 200 and by_rid[2] == by_id[2]
    timeline = by_rid[2]
    assert timeline["trace_id"] == tid and timeline["live"] is False
    assert [e["name"] for e in timeline["events"]] == [
        "req.admit", "req.queue", "req.prefill_chunk", "req.decode",
        "req.retire"]
    assert missing[0] == 404 and "unknown request" in missing[2]["error"]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve_main(argv, traffic):
    """main(argv) in this thread; ``traffic(url)`` in a client thread,
    then SIGTERM → (printed lines, traffic's result)."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    out, errors = {}, []

    def client():
        try:
            deadline = time.monotonic() + 60
            while True:
                try:
                    _get(url, "/healthz")
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            out["result"] = traffic(url)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    printed = io.StringIO()
    thread = threading.Thread(target=client)
    try:
        thread.start()
        with contextlib.redirect_stdout(printed):
            serve_main([*argv, "--device", "cpu", "--port", str(port)])
    finally:
        signal.signal(signal.SIGTERM, old)
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    lines = [json.loads(l) for l in printed.getvalue().strip().splitlines()]
    return lines, out["result"]


def test_cli_every_flag_on(tmp_path):
    """--reqtrace --slo --trace_dir --flight_dir --trace_rank
    --no_warmup: every request's exported timeline validates with JAX's
    tools, the flight dump loads with JAX's load_dump, /metricsz carries
    the SLO gauges; without warmup nothing is prepared before serving,
    and the traffic prepares what it uses."""
    trace_dir, flight_dir = tmp_path / "trace", tmp_path / "flight"

    def traffic(url):
        replies = [_post(url, {"prompt_tokens": [i + 1, 2, 3],
                               "max_new_tokens": 3}) for i in range(3)]
        return replies, _get(url, "/metricsz")[2], _get(url, "/statusz")[2]

    lines, (replies, text, status) = _serve_main(
        ["--init_demo", "--reqtrace", "--slo",
         "ttft_p99<0.5s,tpot_p50<80ms,availability>0.999",
         "--trace_dir", str(trace_dir), "--trace_ring_events", "4096",
         "--trace_rank", "2", "--flight_dir", str(flight_dir),
         "--no_warmup"], traffic)
    first = lines[0]
    assert first["reqtrace"] is True and first["slo"].startswith("ttft_p99")
    assert set(first["compile_counts"].values()) == {0}
    assert 'ddp_tpu_serve_compiled_programs{program="decode"} 1' in text
    assert first["build_info"]["backend"] == "cpu"
    validate_promtext(text)
    for obj in ("ttft_p99", "tpot_p50", "availability"):
        assert f'ddp_tpu_slo_target{{objective="{obj}"}}' in text
    assert status["trace"]["enabled"] is True
    printed = {k: v for line in lines[1:] for k, v in line.items()}
    assert printed["drained"] is True
    assert printed["trace"] == str(trace_dir / "trace_rank2.trace.json")
    doc = jtracer.validate_trace_file(printed["trace"])
    by_id = jrt.reconstruct_requests(doc["traceEvents"])
    assert len(by_id) == 3
    for timeline in by_id.values():
        assert jrt.validate_request_timeline(timeline)["reason"] == COMPLETE
    dump = jrec.load_dump(printed["flight"])
    assert dump["reason"] == "shutdown"
    assert dump["context"]["slo"].startswith("ttft_p99")
    assert dump["context"]["role"] == "serve"
    assert all(r["status"] == COMPLETE for r in replies)


@pytest.mark.parametrize("spec,match", [
    ("ttft_p99<1s;ghost:ttft_p99<1s", "no --model ghost=DIR"),
    ("ttft_p99<1s;ttft_p99<2s", "--slo: duplicate SLO group"),
    ("bogus", "--slo: bad SLO clause"),
])
def test_cli_slo_errors_exit(spec, match):
    with pytest.raises(SystemExit, match=match):
        serve_main(["--init_demo", "--device", "cpu", "--slo", spec])
