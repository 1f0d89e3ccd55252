"""Stdlib-HTTP frontend for the serve engine.

The counterpart of ``ddp_tpu/serve/server.py``'s core routes, with the
same JSON shapes:

  POST /generate   {"prompt_tokens": [...], "max_new_tokens": N,
                    "temperature"?, "top_p"?, "seed"?, "timeout"?}
                   → 200 {"rid", "status", "prompt_tokens", "tokens",
                     "ttft_s", "decode_tokens_per_s"}
                   → 429 {"error": "queue_full", "retry_after_s"} +
                     ``Retry-After`` on backpressure
                   → 400 {"error": reason} on invalid requests and
                     malformed bodies
  GET  /healthz    → 200 {"ok": true, "slots", "active", "queue_depth"}
  GET  /stats      → 200 engine.stats()

One background thread drives ``ServeEngine.step()`` whenever work is
pending; HTTP handler threads touch the engine only under the same lock
(the engine is single-threaded by design). Each handler blocks until its
request completes.
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
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        retry_after: float = 5.0,
    ):
        self.engine = engine
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # Retry-After fallback for a 429 before any retirement rate
        # exists to derive one from.
        self.retry_after = float(retry_after)
        self._engine_error: Optional[str] = None
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
                    with self._lock:
                        busy = self.engine.pending
                        if busy:
                            self.engine.step()
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
        if self._engine_error is not None:
            return 500, {"error": f"engine failed: {self._engine_error}"}
        engine = self.engine
        with self._lock:
            adm = engine.submit(
                prompt, max_new, temperature=temperature, top_p=top_p,
                seed=seed, timeout=timeout,
            )
        if not adm.accepted:
            # Only queue_full is transient; validation reasons are
            # permanent client errors.
            if adm.reason == QUEUE_FULL:
                with self._lock:
                    eta = engine.queue_drain_eta_s()
                retry_after = (
                    min(60.0, max(1.0, eta)) if eta is not None
                    else self.retry_after
                )
                return 429, {
                    "error": adm.reason,
                    "retry_after_s": round(retry_after, 2),
                }
            return 400, {"error": adm.reason}
        rid = adm.request.rid
        while True:
            with self._lock:
                done = engine.pop_result(rid)
            if done is not None:
                break
            if self._engine_error is not None:
                return 500, {"error": f"engine failed: {self._engine_error}"}
            if self._stop.is_set():
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
        }

    def snapshot(self, route: str) -> Optional[dict]:
        """GET route → JSON-ready dict, or None for an unknown route."""
        if route == "/healthz":
            with self._lock:
                return {
                    "ok": self._engine_error is None,
                    "slots": self.engine.num_slots,
                    "active": self.engine.active,
                    "queue_depth": self.engine.scheduler.depth,
                    **(
                        {"engine_error": self._engine_error}
                        if self._engine_error
                        else {}
                    ),
                }
        if route == "/stats":
            with self._lock:
                return self.engine.stats()
        return None


def _make_handler(server: LMServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 — quiet
            pass

        def _send(self, status: int, payload: dict, headers=None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802
            payload = server.snapshot(self.path.partition("?")[0])
            if payload is None:
                self._send(404, {"error": f"no route {self.path}"})
            else:
                # A dead engine fails status-code liveness probes.
                self._send(503 if payload.get("ok") is False else 200,
                           payload)

        def do_POST(self):  # noqa: N802
            if self.path != "/generate":
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
            status, payload = server.submit_and_wait(body)
            headers = None
            if status == 429:
                headers = {
                    "Retry-After": str(
                        max(1, math.ceil(payload["retry_after_s"]))
                    )
                }
            self._send(status, payload, headers)

    return Handler
