"""Minimal HTTP/JSON intake + live observability (stdlib only).

``http.server`` from the standard library — no new dependencies — bound
to localhost: this is the pod-/host-local control surface (a fronting
proxy owns TLS/authn, exactly like node_exporter's model).  Endpoints::

    POST /submit        JSON request body -> 200 {"accepted": true, ...}
                        429 on backpressure (queue full / tenant cap),
                        503 while draining, 400 malformed
    POST /stream/<id>/subint  {"path": "/data/chunk0.npy", "seq": 0}
                        -> 200 {"ingested": true} | {"duplicate": true};
                        404 unknown stream, 400 bad chunk.  Under --mux
                        the subint lands on the shared multiplexer ring
                        (a full ring backpressures the response instead
                        of dropping a journaled chunk) and is batched
                        with other live streams' subints into one
                        device dispatch
    POST /stream/<id>/close   -> 200 {"closed": true}; the stream queues
                        for close reconciliation + output write (under
                        --mux the worker drains the stream's pending
                        ring entries first)
    GET  /healthz       200 {"status": "ok" | "draining", ...counts;
                        "mux": {streams, pending, dispatches, ...} when
                        --mux is on, else null}
    GET  /requests      200 {"n": ..., "requests": [{id, state, kind,
                        tenant}, ...]} — the journaled request index
    GET  /requests/<id> 200 {"state": ...} from the journaled lifecycle
    GET  /metrics       Prometheus text exposition of the LIVE registry
                        (the CLI session's exporter)
    GET  /trace/<id>    200 {"trace_id", "spans": [...]} — the finished
                        spans of one trace, by trace id OR request id
                        (the daemon's bounded in-memory span store; no
                        --trace-out required)
    GET  /debug/vars    200 one-scrape debugging state: health, config,
                        counters, program costs, the most recent spans,
                        the process's kernel launch counts
    GET  /quality       200 {"streams": {id: quality summary}, "series":
                        {...}} — per-stream zap/drift state for every
                        open online session plus the registry's
                        quality_* series
    POST /profile?seconds=N  capture N seconds (default 1, max 60) of
                        torch.profiler trace (CPU and CUDA activities)
                        into the daemon's --profile-dir; 200
                        {"profile_dir": ...}, 400 without --profile-dir
                        or bad N, 409 while a capture is already running

The server runs on daemon threads (`ThreadingHTTPServer`): submissions
land in the scheduler under its own lock, so the single worker loop never
blocks intake and vice versa.  The ``intake`` fault site fires per
/submit: an injected transient returns a 503 with ``Retry-After`` — the
client's retry is the recovery path, and the daemon never wedges.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from iterative_cleaner_torch.serve.request import RequestError, parse_request
from iterative_cleaner_torch.serve.scheduler import Rejection

MAX_BODY_BYTES = 1 << 20  # a request is paths + knobs, never data

_REJECTION_STATUS = {
    "queue_full": 429,
    "tenant_limit": 429,
    "duplicate": 409,
    "draining": 503,
    # one torch.profiler trace at a time: a concurrent capture conflicts
    # rather than queueing (the client retries after the first finishes)
    "profile_busy": 409,
}


class _Handler(BaseHTTPRequestHandler):
    """One request class per daemon (built by :func:`make_server`); the
    daemon object rides on the server instance."""

    server_version = "icln-serve/1"
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------ plumbing
    def log_message(self, fmt, *args):  # stdout belongs to the daemon
        pass

    def _send(self, status: int, body: bytes, ctype: str,
              extra_headers=()) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _send_json(self, status: int, doc: dict, extra_headers=()) -> None:
        body = (json.dumps(doc, sort_keys=True) + "\n").encode()
        self._send(status, body, "application/json", extra_headers)

    # ------------------------------------------------------------- routes
    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        daemon = self.server.daemon
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/healthz":
            self._send_json(200, daemon.health())
        elif path == "/metrics":
            from iterative_cleaner_torch.telemetry import (
                metrics_to_prometheus,
            )

            text = metrics_to_prometheus(daemon.registry.snapshot())
            self._send(200, text.encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/requests":
            self._send_json(200, daemon.request_index())
        elif path.startswith("/requests/"):
            rid = path[len("/requests/"):]
            state = daemon.request_state(rid)
            if state is None:
                self._send_json(404, {"error": f"unknown request {rid!r}"})
            else:
                self._send_json(200, state)
        elif path.startswith("/trace/"):
            tid = path[len("/trace/"):]
            view = daemon.trace_view(tid)
            if view is None:
                self._send_json(404, {"error": f"unknown trace {tid!r}"})
            else:
                self._send_json(200, view)
        elif path == "/debug/vars":
            self._send_json(200, daemon.debug_vars())
        elif path == "/quality":
            self._send_json(200, daemon.quality_view())
        else:
            self._send_json(404, {"error": f"no route {path!r}"})

    def do_POST(self):  # noqa: N802
        daemon = self.server.daemon
        path = self.path.split("?", 1)[0].rstrip("/")
        if path.startswith("/stream/"):
            self._post_stream(daemon, path)
            return
        if path == "/profile":
            self._post_profile(daemon)
            return
        if path != "/submit":
            self._send_json(404, {"error": f"no route {path!r}"})
            return
        if daemon.faults is not None:
            try:
                daemon.faults.fire("intake", detail="http")
            except Exception:  # noqa: BLE001 -- counted below
                # transient intake fault: the client retries; the daemon
                # keeps serving
                daemon.registry.counter_inc("serve_retries")
                self._send_json(503, {"error": "transient intake fault; "
                                               "retry"},
                                extra_headers=(("Retry-After", "1"),))
                return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = -1
        if not 0 < length <= MAX_BODY_BYTES:
            self._send_json(400, {"error": "Content-Length required and "
                                           "<= %d" % MAX_BODY_BYTES})
            return
        body = self.rfile.read(length)
        try:
            req = parse_request(body, base_config=daemon.base_config)
        except RequestError as exc:
            self._send_json(400, {"error": str(exc)})
            return
        try:
            daemon.admit(req, source="http")
        except Rejection as exc:
            status = _REJECTION_STATUS.get(exc.reason, 429)
            headers = (("Retry-After", "1"),) if status in (429, 503) else ()
            self._send_json(status, {"rejected": True, "reason": exc.reason,
                                     "error": exc.detail},
                            extra_headers=headers)
            return
        self._send_json(200, {"accepted": True, "id": req.request_id,
                              "tenant": req.tenant})

    def _post_profile(self, daemon) -> None:
        """POST /profile?seconds=N — on-demand torch.profiler capture.
        The duration rides the query string (the dispatch above discards
        it from ``path``, so it is re-parsed here); the capture blocks
        THIS handler thread only — ThreadingHTTPServer keeps /metrics
        and the stream endpoints live for the duration."""
        from urllib.parse import parse_qs, urlsplit

        query = parse_qs(urlsplit(self.path).query)
        raw = query.get("seconds", ["1"])[-1]
        try:
            seconds = float(raw)
        except ValueError:
            self._send_json(400, {"error": f"seconds must be a number, "
                                           f"got {raw!r}"})
            return
        try:
            self._send_json(200, daemon.profile_capture(seconds))
        except RequestError as exc:
            self._send_json(400, {"error": str(exc)})
        except Rejection as exc:
            status = _REJECTION_STATUS.get(exc.reason, 429)
            self._send_json(status, {"rejected": True, "reason": exc.reason,
                                     "error": exc.detail})

    def _post_stream(self, daemon, path: str) -> None:
        """POST /stream/<id>/subint and /stream/<id>/close — the online
        ingest surface.  Chunk DATA never crosses HTTP: the body names a
        file ('path') the daemon reads itself, keeping the intake within
        MAX_BODY_BYTES and the data path zero-copy on the host."""
        parts = path.split("/")  # ["", "stream", "<id>", "<verb>"]
        if len(parts) != 4 or not parts[2] \
                or parts[3] not in ("subint", "close"):
            self._send_json(404, {"error": f"no route {path!r}"})
            return
        rid, verb = parts[2], parts[3]
        doc = {}
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            self._send_json(400, {"error": "Content-Length required and "
                                           "<= %d" % MAX_BODY_BYTES})
            return
        if length:
            try:
                doc = json.loads(self.rfile.read(length).decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as exc:
                self._send_json(400, {"error": f"body is not JSON: {exc}"})
                return
            if not isinstance(doc, dict):
                self._send_json(400, {"error": "body must be a JSON "
                                               "object"})
                return
        try:
            if verb == "close":
                self._send_json(200, daemon.stream_close(rid))
                return
            chunk = doc.get("path")
            if not isinstance(chunk, str) or not chunk:
                self._send_json(400, {"error": "'path' (chunk file path "
                                               "string) is required"})
                return
            seq = doc.get("seq")
            if seq is not None:
                try:
                    seq = int(seq)
                except (TypeError, ValueError):
                    self._send_json(400, {"error": "'seq' must be an "
                                                   "integer"})
                    return
            self._send_json(200, daemon.stream_ingest(rid, chunk, seq=seq))
        except RequestError as exc:
            status = 404 if "no open stream" in str(exc) else 400
            self._send_json(status, {"error": str(exc)})
        except Rejection as exc:
            status = _REJECTION_STATUS.get(exc.reason, 429)
            headers = (("Retry-After", "1"),) if status in (429, 503) else ()
            self._send_json(status, {"rejected": True, "reason": exc.reason,
                                     "error": exc.detail},
                            extra_headers=headers)


def make_server(daemon, port: int,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Bind (port 0 = ephemeral) and return the server with ``daemon``
    attached; the caller starts ``serve_forever`` on a thread and reads
    ``server.server_address`` for the actual port."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.daemon = daemon
    return server


def start_server_thread(server) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.1},
                         name="icln-serve-http", daemon=True)
    t.start()
    return t
