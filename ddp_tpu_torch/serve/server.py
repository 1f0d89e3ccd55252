"""Stdlib-HTTP frontend for the serve engine.

The counterpart of ``ddp_tpu/serve/server.py``'s core, lifecycle and
observability routes, with the same JSON shapes:

  POST /generate   {"prompt_tokens": [...], "max_new_tokens": N,
                    "temperature"?, "top_p"?, "seed"?, "timeout"?,
                    "model"?: a registered model name (absent: the
                    default model), "trace"?: an inbound trace context
                    ``00-<trace>-<span>-<parent>`` (obs/reqtrace.py)}
                   → 200 {"rid", "status", "prompt_tokens", "tokens",
                     "ttft_s", "decode_tokens_per_s", "model_version"?,
                     "trace_id"?: echoed for a valid inbound context}
                   → 429 {"error": "queue_full", "retry_after_s"} +
                     ``Retry-After`` on backpressure
                   → 400 {"error": reason} on invalid requests and
                     malformed bodies, {"error": "unknown_model"}
                   → 503 {"error": "draining"} + ``Retry-After`` while
                     the server drains for shutdown
  POST /reload     {"checkpoint_dir": D, "epoch"?, "model"?,
                    "drain_timeout"?}: a verified hot-swap
                    (serve/lifecycle.py) — verify, load on the host while
                    the old weights serve, drain the lanes to a barrier,
                    swap under the lock, roll back on any failure
                   → 200 {"reloaded", "model_version", ...}
                   → 409 {"error": "manifest_missing" | "crc_mismatch" |
                     "spec_skew" | "reload_in_progress", "detail"?}
                   → 500 load_failed / swap_failed (rolled_back)
                   → 503 swap_drain_timeout (the lanes never retired)
  GET  /healthz    → 200 {"ok": true, "slots", "active", "queue_depth",
                    "draining", "model_version"?, "models"?}
  GET  /stats      → 200 engine.stats() (with ``compile_counts``: the
                    step programs prepared, the static-shape pin as an
                    observable)
  GET  /metricsz   → 200 Prometheus text (obs/promtext.render_serve) of
                    the default engine's stats, with up and draining
                    (``ddp_tpu_serve_compiled_programs{program=...}``)
  GET  /statusz    → 200 {"ok", "draining", "stats" (with the summaries'
                    mergeable states), "models"? (each named engine's),
                    "trace": the span tracer's tail, a traceEvents doc}
  GET  /requestz[?id=rid|0xTRACE] → one request's timeline, or the
                    recently retired ones; 404 when tracing is off

One background thread steps every engine (the default one, then the
named ones) whenever it has work; HTTP handler threads touch an engine
only under the same lock (the engine is single-threaded by design).
Each handler blocks until its request completes.
"""

from __future__ import annotations

import contextlib
import json
import math
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ddp_tpu_torch.obs.promtext import CONTENT_TYPE, render_serve
from ddp_tpu_torch.obs.reqtrace import format_trace_id, parse_trace_context
from ddp_tpu_torch.serve import lifecycle as lc
from ddp_tpu_torch.serve.engine import ServeEngine
from ddp_tpu_torch.serve.scheduler import QUEUE_FULL

# Engine-loop idle poll; the loop burns no CPU when no work is queued.
_IDLE_SLEEP_S = 0.002


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of concurrent clients
    # (a shared-prefix fan-out) overflows it and connections are reset.
    request_queue_size = 128


class LMServer:
    """Engine + engine thread + ThreadingHTTPServer, lifecycle-managed.

    ``port=0`` binds an ephemeral port; ``server.port`` is the bound
    one. Use as a context manager or call ``start()``/``stop()``.
    ``models`` names extra engines, each with its own scheduler, slots
    and pages; a /generate body's ``model`` routes to one.
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        drain_retry_after: float = 5.0,
        models: Optional[dict] = None,
    ):
        self.engine = engine
        self.models: dict = dict(models or {})
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = threading.Event()
        # The Retry-After of a 503 while draining, and of a 429 before
        # any retirement rate exists to derive one from.
        self.drain_retry_after = float(drain_retry_after)
        self._engine_error: Optional[str] = None
        # One reload at a time: a second POST /reload answers 409.
        self._reload_lock = threading.Lock()
        # POST handlers between reading a body and writing the reply
        # (under _lock): a drain waits for them, so that no finished
        # request's reply is lost when the process exits.
        self._responding = 0
        self._httpd = _HTTPServer((host, port), _make_handler(self))
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._threads: list[threading.Thread] = []

    def start(self) -> "LMServer":
        for name, target in (
            ("serve-engine", self._engine_loop),
            ("serve-http", self._httpd.serve_forever),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self) -> "LMServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ---- graceful drain ---------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def begin_drain(self) -> None:
        """Stop admitting (a new POST answers 503 + Retry-After) while
        running lanes decode to completion. Idempotent."""
        self._draining.set()

    def drain(self, timeout: float = 30.0, *, poll: float = 0.01) -> bool:
        """``begin_drain``, then wait up to ``timeout`` seconds for every
        engine to go idle and every reply to be written → whether they
        were (the SIGTERM path of ``python -m ddp_tpu_torch.serve``)."""
        self.begin_drain()
        deadline = time.monotonic() + max(0.0, timeout)
        while time.monotonic() < deadline:
            if self._idle() or self._engine_error is not None:
                return True
            time.sleep(poll)
        return self._idle()

    def _idle(self) -> bool:
        with self._lock:
            return self._responding == 0 and not any(
                e.pending for e in self._engines())

    # ---- engine driving ---------------------------------------------

    def _engines(self) -> list[ServeEngine]:
        """The default engine, then the named ones."""
        return [self.engine, *self.models.values()]

    def _engine_for(self, body: dict):
        """``(engine, None)`` for a body's ``model`` (absent: the default
        engine), or ``(None, (400, payload))`` for an unknown name —
        serving it on the default model would serve the wrong weights."""
        model = body.get("model")
        if model is None:
            return self.engine, None
        if model not in self.models:
            return None, (400, {"error": "unknown_model", "model": model,
                                "models": sorted(self.models)})
        return self.models[model], None

    def _engine_loop(self) -> None:
        # An exception escaping step() must not kill this thread
        # silently: record it, flip health, and fail waiters fast.
        dev = self.engine.device
        ctx = (
            torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext()
        )
        try:
            with ctx:
                while not self._stop.is_set():
                    busy = False
                    for eng in self._engines():
                        with self._lock:
                            if eng.pending:
                                busy = True
                                eng.step()
                    if not busy:
                        time.sleep(_IDLE_SLEEP_S)
        except Exception as e:  # noqa: BLE001 — terminal, reported
            traceback.print_exc()
            self._engine_error = f"{type(e).__name__}: {e}"

    def submit_and_wait(
        self, body: dict, *, poll: float = 0.002
    ) -> tuple[int, dict]:
        """The POST /generate implementation → (http_status, payload)."""
        try:
            prompt = list(body["prompt_tokens"])
            max_new = int(body["max_new_tokens"])
            temperature = float(body.get("temperature", 0.0))
            top_p = float(body.get("top_p", 1.0))
            seed = int(body.get("seed", 0))
            timeout = float(body["timeout"]) if "timeout" in body else None
        except (KeyError, TypeError, ValueError):
            return 400, {
                "error": "body needs prompt_tokens (list[int]) and "
                "max_new_tokens (int); temperature/top_p/seed/timeout "
                "must be numeric"
            }
        engine, refused = self._engine_for(body)
        if refused:
            return refused
        if self._engine_error is not None:
            return 500, {"error": f"engine failed: {self._engine_error}"}
        if self._draining.is_set():
            # New work goes to the replacement process; admitted work
            # finishes.
            return 503, {"error": "draining",
                         "retry_after_s": self.drain_retry_after}
        with self._lock:
            # A malformed trace context is the engine's orphan count,
            # never a 400.
            adm = engine.submit(
                prompt, max_new, temperature=temperature, top_p=top_p,
                seed=seed, timeout=timeout, trace=body.get("trace"),
            )
        if not adm.accepted:
            # Only queue_full is transient; validation reasons are
            # permanent client errors.
            if adm.reason == QUEUE_FULL:
                with self._lock:
                    eta = engine.queue_drain_eta_s()
                retry_after = (
                    min(60.0, max(1.0, eta)) if eta is not None
                    else self.drain_retry_after
                )
                return 429, {
                    "error": adm.reason,
                    "retry_after_s": round(retry_after, 2),
                }
            return 400, {"error": adm.reason}
        rid = adm.request.rid
        while True:
            # Read the stop flag before the result: a request that finished
            # before the server stopped is answered, never 503.
            stopping = self._stop.is_set()
            with self._lock:
                done = engine.pop_result(rid)
            if done is not None:
                break
            if self._engine_error is not None:
                return 500, {"error": f"engine failed: {self._engine_error}"}
            if stopping:
                return 503, {"error": "server stopping"}
            time.sleep(poll)
        return 200, {
            "rid": done.rid,
            "status": done.status,
            "prompt_tokens": done.prompt,
            "tokens": done.tokens,
            "ttft_s": round(done.ttft, 4) if done.ttft is not None else None,
            "decode_tokens_per_s": round(done.decode_tokens_per_s, 2),
            # Paged engines only: prompt tokens served from cached pages.
            **({"prefix_hit_tokens": done.prefix_hit_tokens}
               if done.prefix_hit_tokens is not None else {}),
            # The weights this request was served under.
            **({"model_version": done.model_version}
               if done.model_version is not None else {}),
            # Only for a valid inbound trace context.
            **_trace_echo(body.get("trace")),
        }

    # ---- verified hot-swap (serve/lifecycle.py) ----------------------

    def reload_model(self, body: dict, *, poll: float = 0.005
                     ) -> tuple[int, dict]:
        """The POST /reload implementation → (http_status, payload).

        verify → load → drain to the barrier → swap → (roll back). The
        old weights serve until the swap and again after any failure.
        Verify and load run outside the engine lock; the swap runs in
        the lock hold that observes ``active == 0``.
        """
        directory = body.get("checkpoint_dir")
        if not isinstance(directory, str) or not directory:
            return 400, {"error": "body needs checkpoint_dir (str)"}
        try:
            epoch = (int(body["epoch"]) if body.get("epoch") is not None
                     else None)
            drain_timeout = float(body.get("drain_timeout", 30.0))
        except (TypeError, ValueError):
            return 400, {"error": "epoch/drain_timeout must be numeric"}
        engine, refused = self._engine_for(body)
        if refused:
            return refused
        if self._engine_error is not None:
            return 500, {"error": f"engine failed: {self._engine_error}"}
        if not self._reload_lock.acquire(blocking=False):
            return 409, {"error": "reload_in_progress"}
        try:
            return self._reload_locked(engine, directory, epoch,
                                       drain_timeout, poll)
        finally:
            self._reload_lock.release()

    def _reload_locked(self, engine, directory, epoch, drain_timeout, poll
                       ) -> tuple[int, dict]:
        def record(outcome: str, **fields) -> None:
            engine.metrics.write("serve_reload", outcome=outcome,
                                 directory=directory, **fields)

        # 1. Verify on the host: manifest, CRCs, spec.
        t0 = time.monotonic()
        try:
            target = lc.verify_reload_target(
                directory, epoch=epoch, current_spec=engine.spec,
                num_heads_fallback=engine.spec.num_heads,
            )
        except lc.ReloadRejected as e:
            record("rejected", reason=e.reason)
            return 409, {"error": e.reason, "detail": e.detail}
        verify_s = round(time.monotonic() - t0, 4)

        # 2. Load on the host while the old weights serve.
        t0 = time.monotonic()
        try:
            state = lc.load_reload_target(target)
        except Exception as e:  # noqa: BLE001 — named in the payload
            record("load_failed", model_version=target.version)
            return 500, {"error": "load_failed",
                         "detail": f"{type(e).__name__}: {e}"}
        load_s = round(time.monotonic() - t0, 4)

        # 3. Drain to the barrier: admission pauses (new work queues)
        #    while bound lanes finish; the swap runs in the lock hold
        #    that sees active == 0, so no lane binds in between. The flag
        #    is set without the lock: the engine reads it at its next
        #    admit phase, and an engine loop that takes the lock step
        #    after step must not hold the pause back while the queue
        #    drains.
        t_swap = time.monotonic()
        engine.pause_admission()
        deadline = time.monotonic() + max(0.0, drain_timeout)
        try:
            while True:
                with self._lock:
                    if engine.active == 0:
                        return self._swap_at_barrier(
                            engine, target, state, t_swap, verify_s,
                            load_s, record)
                if time.monotonic() > deadline:
                    record("drain_timeout", model_version=target.version)
                    return 503, {
                        "error": "swap_drain_timeout",
                        "detail": f"lanes still bound after "
                        f"{drain_timeout}s",
                    }
                time.sleep(poll)
        finally:
            # Whatever happened, the front door reopens.
            engine.resume_admission()

    def _swap_at_barrier(self, engine, target, state, t_swap, verify_s,
                         load_s, record) -> tuple[int, dict]:
        """Install under the held lock with ``engine.active == 0``; on any
        failure the old weights stay (``install_params`` restores them)
        and the old version label with them."""
        previous = engine.model_version
        invalidate = previous != target.version
        try:
            engine.install_params(state, model_version=target.version,
                                  invalidate_prefix=invalidate)
        except Exception as e:  # noqa: BLE001 — rolled back, reported
            engine.model_version = previous
            engine.rollbacks_total += 1
            record("swap_failed", model_version=target.version,
                   rolled_back=True)
            return 500, {"error": "swap_failed", "rolled_back": True,
                         "detail": f"{type(e).__name__}: {e}"}
        swap_s = round(time.monotonic() - t_swap, 4)
        record("swapped", model_version=target.version,
               **({"previous_version": previous} if previous else {}),
               epoch=target.epoch, verify_s=verify_s, load_s=load_s,
               swap_s=swap_s, invalidated_prefix=invalidate)
        return 200, {
            "reloaded": True,
            "model_version": target.version,
            "previous_version": previous,
            "epoch": target.epoch,
            "verify_s": verify_s,
            "load_s": load_s,
            "swap_s": swap_s,
            "invalidated_prefix": invalidate,
        }

    def snapshot(self, route: str) -> Optional[dict]:
        """GET route → JSON-ready dict (Prometheus text for /metricsz),
        or None for an unknown route."""
        if route == "/healthz":
            with self._lock:
                return {
                    "ok": self._engine_error is None,
                    "slots": self.engine.num_slots,
                    "active": self.engine.active,
                    "queue_depth": self.engine.scheduler.depth,
                    "draining": self.draining,
                    **({"model_version": self.engine.model_version}
                       if self.engine.model_version is not None else {}),
                    **({"models": {
                        name: {
                            **({"model_version": e.model_version}
                               if e.model_version is not None else {}),
                            "slots": e.num_slots,
                            "active": e.active,
                            "queue_depth": e.scheduler.depth,
                        } for name, e in self.models.items()
                    }} if self.models else {}),
                    **(
                        {"engine_error": self._engine_error}
                        if self._engine_error
                        else {}
                    ),
                }
        if route == "/stats":
            with self._lock:
                return self.engine.stats()
        if route == "/metricsz":
            # Prometheus text, not JSON, from the same snapshot as /stats.
            with self._lock:
                return render_serve(self.engine.stats(),
                                    up=self._engine_error is None,
                                    draining=self.draining)
        if route == "/statusz":
            # ``trace`` is itself a Chrome/Perfetto traceEvents document.
            with self._lock:
                return {
                    "ok": self._engine_error is None,
                    "draining": self.draining,
                    "stats": self.engine.stats(include_states=True),
                    **({"models": {
                        name: e.stats(include_states=True)
                        for name, e in self.models.items()
                    }} if self.models else {}),
                    "trace": self.engine.tracer.snapshot(limit=512),
                }
        return None

    def requestz(self, query: str) -> tuple[int, dict]:
        """GET /requestz[?id=...] → (status, payload): one request's
        lifecycle timeline (obs/reqtrace.py) by rid or 0x trace id, or
        the recently retired set when no id is given."""
        from urllib.parse import parse_qs

        tracer = self.engine._reqtrace
        if tracer is None:
            return 404, {
                "error": "request tracing is off (python -m "
                "ddp_tpu_torch.serve --reqtrace, or "
                "ServeEngine(reqtrace=True))"
            }
        key = (parse_qs(query or "").get("id") or [None])[0]
        with self._lock:
            if key is None:
                return 200, {"enabled": True, "live": tracer.live_count,
                             "recent": tracer.recent()}
            timeline = self.engine.request_timeline(key)
        if timeline is None:
            return 404, {
                "error": f"unknown request {key!r} (rid or 0x-prefixed "
                "trace id; retired timelines are retained up to the "
                "reqtrace_keep bound)"
            }
        return 200, timeline


def _trace_echo(trace) -> dict:
    """``{"trace_id"}`` of a valid inbound trace context, else empty."""
    ctx = parse_trace_context(trace) if trace is not None else None
    return {"trace_id": format_trace_id(ctx[0])} if ctx else {}


def _make_handler(server: LMServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — quiet
            pass

        def _send(self, status: int, payload, headers=None) -> None:
            if isinstance(payload, str):  # /metricsz: Prometheus text
                data, ctype = payload.encode(), CONTENT_TYPE
            else:
                data, ctype = json.dumps(payload).encode(), "application/json"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            route, _, query = self.path.partition("?")
            if route == "/requestz":
                self._send(*server.requestz(query))
                return
            payload = server.snapshot(route)
            if payload is None:
                self._send(404, {"error": f"no route {self.path}"})
            elif isinstance(payload, str):
                self._send(200, payload)
            else:
                # A dead engine fails status-code liveness probes.
                self._send(503 if payload.get("ok") is False else 200,
                           payload)

        def do_POST(self):  # noqa: N802
            with server._lock:
                server._responding += 1
            try:
                self._post()
            finally:
                with server._lock:
                    server._responding -= 1

        def _post(self):
            if self.path not in ("/generate", "/reload"):
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, TypeError) as e:
                self._send(400, {"error": f"bad JSON body: {e}"})
                return
            if self.path == "/reload":
                self._send(*server.reload_model(body))
                return
            status, payload = server.submit_and_wait(body)
            headers = None
            if status == 503 and payload.get("error") == "draining":
                headers = {"Retry-After": str(int(server.drain_retry_after))}
            elif status == 429:
                headers = {
                    "Retry-After": str(
                        max(1, math.ceil(payload["retry_after_s"]))
                    )
                }
            self._send(status, payload, headers)

    return Handler
