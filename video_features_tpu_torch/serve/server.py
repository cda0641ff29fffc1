"""Minimal HTTP/JSON request source on stdlib ``http.server``.

Counterpart of ``video_features_tpu/serve/server.py``, copied as it is
(stdlib only).

Endpoints (the whole surface — this is an admission door, not a web
framework; anything fancier belongs behind a real proxy):

- ``POST /v1/extract`` — body ``{"feature_type": ..., "video_path": ...,
  "bucket"?: "WxH", "id"?: ..., "priority"?: 0..9, "deadline_ms"?: N}``;
  202 + the queued lifecycle record, 400 on a malformed request
  (recorded nowhere — it never had an identity), 503 + Retry-After when
  the bounded admission queue is full OR this feature type's circuit
  breaker is open (recorded ``rejected``; the client owns the retry).
  With ``--cache_dir``, a content-addressed cache hit returns 202 with
  the record already terminal ``done`` (features listed) — no dispatch.
  The multi-model form replaces ``feature_type`` with ``"feature_types":
  [...]`` (a LIST): one sub-request per model (ids ``<base>.<model>``),
  the video decoded ONCE for all of them, 202 + an aggregate body
  ``{"fanout": true, "requests": {<model>: <record>, ...}}`` whose
  members are polled individually via ``GET /v1/requests/<sub-id>``.
- ``GET /v1/requests/<id>`` — the lifecycle record (memory, falling back
  to the durable result JSON); 404 for unknown ids.
- ``DELETE /v1/requests/<id>`` — cancel: 200 + the terminal record when
  the request was still queued (idempotent: repeating the DELETE of an
  already-cancelled request is 200 again), 202 + ``cancel_requested``
  when it is already dispatched (honored at the group boundary), 409 +
  the record when already terminal in another state (done/failed/
  rejected/expired — too late to cancel), 404 for unknown ids.
- ``GET /healthz`` — queue depth, per-state counts, warm model list,
  scheduler name, per-model circuit-breaker state; 503 with the error
  once a sticky device error stopped the daemon (and every POST is then
  503 too, recorded nowhere).
- ``GET /metrics`` — Prometheus text exposition (format 0.0.4) of the
  daemon's metrics registry plus live serve families (breaker state,
  SLO quantiles, uptime); stdlib-rendered, no client library
  (telemetry/exposition.py).
- ``GET /v1/stats`` — the JSON twin of /metrics: /healthz plus the SLO
  window digest, cost-model snapshot, and raw metrics snapshot.

ThreadingHTTPServer: handlers run on per-connection threads, so
everything they touch (daemon.submit -> tracker/batcher) is lock-guarded.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Tuple

from video_features_tpu_torch.serve.lifecycle import BadRequest, InvalidMedia

MAX_BODY_BYTES = 1 << 20  # a request is a few hundred bytes; 1 MiB is hostile


class ServeHandler(BaseHTTPRequestHandler):
    """One request in, one JSON document out. The daemon reference lives
    on the server object (set by :func:`start_http_server`)."""

    server_version = "vft-serve/1.0"
    protocol_version = "HTTP/1.1"

    def _send(self, code: int, body: Dict[str, Any], retry_after: float = 0.0) -> None:
        data = json.dumps(body, sort_keys=True).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after > 0:
            self.send_header("Retry-After", str(max(int(retry_after), 1)))
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        data = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        if self.path.rstrip("/") != "/v1/extract":
            self._send(404, {"error": f"no such endpoint: {self.path}"})
            return
        daemon = self.server.daemon  # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            self._send(400, {"error": "missing or oversized Content-Length"})
            return
        try:
            payload = json.loads(self.rfile.read(length).decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as exc:
            self._send(400, {"error": f"body is not valid JSON: {exc}"})
            return
        try:
            rec = daemon.submit(payload, source="http")
        except InvalidMedia as exc:
            # before the BadRequest catch (InvalidMedia IS a BadRequest):
            # 422 says "well-formed request, unprocessable media" — the
            # client should fix the FILE, not the request shape, and the
            # durable rejected record rides along so the caller can poll
            # /requests/<id> later and see the same terminal verdict
            self._send(
                422,
                {"error": str(exc), "reason_code": "invalid_media",
                 "record": exc.record},
            )
            return
        except BadRequest as exc:
            self._send(400, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - QueueFull/ModelUnavailable without importing serve internals here
            name = type(exc).__name__
            if name == "QueueFull":
                self._send(
                    503,
                    {"error": str(exc), "queue_depth": daemon.batcher.depth()},
                    retry_after=daemon.scfg.max_batch_wait_ms / 1000.0 * 2,
                )
                return
            if name == "DaemonStopped":
                self._send(503, {"error": str(exc)})
                return
            if name == "ModelUnavailable":
                self._send(
                    503,
                    {"error": str(exc),
                     "feature_type": getattr(exc, "feature_type", None)},
                    retry_after=getattr(exc, "retry_after_s", 1.0),
                )
                return
            raise
        self._send(202, rec)

    def do_DELETE(self) -> None:  # noqa: N802 - http.server API
        daemon = self.server.daemon  # type: ignore[attr-defined]
        prefix = "/v1/requests/"
        if not self.path.startswith(prefix):
            self._send(404, {"error": f"no such endpoint: {self.path}"})
            return
        rid = self.path[len(prefix):].rstrip("/")
        rec = daemon.cancel(rid)
        if rec is None:
            self._send(404, {"error": f"unknown request id {rid!r}"})
        elif rec.get("state") == "cancelled":
            self._send(200, rec)
        elif rec.get("cancel_requested"):
            self._send(202, rec)
        else:  # already terminal: too late to cancel, record stands
            self._send(409, rec)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        daemon = self.server.daemon  # type: ignore[attr-defined]
        path = self.path.rstrip("/")
        if path == "/healthz":
            status = daemon.status()
            self._send(503 if status["status"] == "stopped" else 200, status)
            return
        if path == "/metrics":
            # the content type Prometheus scrapers negotiate for the
            # 0.0.4 text format
            self._send_text(
                200, daemon.metrics_text(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
            return
        if path == "/v1/stats":
            self._send(200, daemon.stats())
            return
        prefix = "/v1/requests/"
        if self.path.startswith(prefix):
            rid = self.path[len(prefix):]
            rec = daemon.tracker.get(rid)
            if rec is None:
                self._send(404, {"error": f"unknown request id {rid!r}"})
            else:
                self._send(200, rec)
            return
        self._send(404, {"error": f"no such endpoint: {self.path}"})

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass  # the daemon's heartbeat/manifest are the log; not per-request access lines


def start_http_server(daemon: Any, host: str, port: int) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Bind (``port=0`` -> ephemeral, how the tests run), attach the
    daemon, serve on a background thread. Caller owns shutdown()."""
    server = ThreadingHTTPServer((host, port), ServeHandler)
    server.daemon_threads = True
    server.daemon = daemon  # type: ignore[attr-defined]
    thread = threading.Thread(
        target=server.serve_forever, name="serve-http", daemon=True
    )
    thread.start()
    return server, thread
