"""Opt-in background HTTP endpoint: Prometheus /metrics + /healthz JSON
(counterpart of ``spark_rapids_tpu/runtime/obs/endpoint.py``).

Enabled by setting ``spark.rapids.obs.port`` (> 0). The server is a
standard-library ``ThreadingHTTPServer`` on a daemon thread: scrapes are
served while queries run; nothing about serving touches a query hot path
(the registry reads take per-instrument locks only, and gauge callbacks
are explicit live reads).

/healthz reports:
- device liveness via a trivial probe: one scalar op on the session's
  device, run on its own daemon thread with a timeout. On a card the op
  runs on a side CUDA stream of the probe's own (non-blocking against
  the default stream) and the probe waits on an event recorded after it,
  never on the device or the default stream, so a card busy with a
  query's queued kernels still answers; a wedged card flips the status
  to "degraded" instead of hanging the scrape;
- semaphore saturation (permits/available/waiting);
- spill pressure (device/host bytes held vs budget, disk spill bytes);
- last-query status (id, status, wall ms) and query counters.

HTTP codes follow load-balancer conventions: 200 when ok, 503 when
degraded, so the endpoint doubles as a liveness probe without a JSON
parser in the prober. ``POST /sql`` and ``/serving`` reach the serving
layer (``runtime/serving``) through callbacks; while it is not installed
they answer 404. A request's ``traceparent`` header rides into the
serving layer and the response carries the outgoing one.
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

#: POST /queries/<id>/cancel (negative ids are lifecycle-local tokens
#: of obs-disabled engines; the endpoint accepts both)
_CANCEL_RE = re.compile(r"^/queries/(-?\d+)/cancel$")

#: Every route this endpoint serves, with its method. `<id>` marks the
#: one templated segment (_CANCEL_RE).
ROUTES = {
    "/": "GET: plain-text index of the routes below.",
    "/metrics": "GET: Prometheus text exposition of the registry.",
    "/healthz": "GET: health JSON; 200 ok / 503 degraded.",
    "/queries": "GET: live query registry (in-flight progress docs).",
    "/console": "GET: auto-refreshing HTML console.",
    "/serving": "GET: serving-layer doc (sessions, queue, result "
                "cache); 404 when spark.rapids.serving.enabled is off.",
    "/sql": "POST: execute {sql, session?, conf?, timeout_seconds?, "
            "cache?} as a top-level action; 200 ok / 400 bad request / "
            "429 rejected / 499 cancelled / 500 failed.",
    "/queries/<id>/cancel": "POST: fire the query's cancel token; 200 "
                            "cancelled / 404 not in flight.",
}


def device_probe(device) -> Callable[[], bool]:
    """The liveness probe of one device: ``ones + 1`` fetched back. On a
    card it runs on a side stream of its own (created on first use,
    non-blocking against the default stream) and waits on an event
    recorded on that stream alone, so it does not queue behind the
    kernels a running query has issued. On the CPU the same op runs on
    the CPU."""
    import torch
    dev = torch.device(device)
    side = []

    def probe() -> bool:
        if dev.type != "cuda":
            return int((torch.ones((), device=dev) + 1).item()) == 2
        if not side:
            side.append(torch.cuda.Stream(device=dev))
        s = side[0]
        with torch.cuda.stream(s):
            y = torch.ones((), device=dev, dtype=torch.int32) + 1
            done = torch.cuda.Event()
            done.record(s)
        done.synchronize()
        with torch.cuda.stream(s):
            return int(y.item()) == 2

    return probe


def default_device_probe() -> bool:
    """The probe of the card, or of the CPU where there is none."""
    import torch
    return device_probe("cuda" if torch.cuda.is_available() else "cpu")()


class DeviceProbe:
    """Runs the probe on a daemon thread with a timeout. A probe that
    never returns leaves its thread parked and reports degraded on this
    and every later check until it completes — threads are never stacked
    behind a wedged probe."""

    def __init__(self, probe_fn: Callable[[], bool] = default_device_probe,
                 timeout_s: float = 2.0):
        self.probe_fn = probe_fn
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        #: the live probe generation: (done_event, result_holder, t0).
        #: Results live on the generation's own holder, so a wedged
        #: probe completing late can never overwrite a newer answer.
        self._current = None

    def check(self) -> dict:
        blocked = {"alive": False, "blocked": True, "probe_ms": None}
        with self._lock:
            cur = self._current
            if cur is not None and not cur[0].is_set():
                if time.perf_counter() - cur[2] >= self.timeout_s:
                    # a probe already past its deadline is still parked:
                    # degraded, and no thread stacking behind it
                    return blocked
                # a HEALTHY probe is merely in flight (concurrent
                # scrapes): share it and wait out its remaining budget
                # instead of reporting a false 'blocked'
            else:
                done = threading.Event()
                holder: dict = {}
                t0 = time.perf_counter()

                def run():
                    ok = False
                    try:
                        ok = bool(self.probe_fn())
                    except Exception:  # noqa: BLE001 - a raising probe
                        ok = False  # is a dead device
                    holder["alive"] = ok
                    holder["ms"] = (time.perf_counter() - t0) * 1000.0
                    done.set()

                cur = (done, holder, t0)
                self._current = cur
                from spark_rapids_tpu_torch.runtime.host_pool import \
                    spawn_service_thread
                spawn_service_thread(run, name="rapids-obs-probe")
        done, holder, t0 = cur
        remaining = self.timeout_s - (time.perf_counter() - t0)
        if remaining <= 0 or not done.wait(remaining):
            return blocked
        return {"alive": bool(holder.get("alive")), "blocked": False,
                "probe_ms": round(holder.get("ms", 0.0), 3)}


class ObsHttpServer:
    """Daemon-thread HTTP server serving the registry + health callback,
    the live query registry (/queries JSON) and the auto-refreshing
    /console page. CORS is OFF unless `cors_origin` is set
    (``spark.rapids.obs.corsOrigin``): /queries carries in-flight SQL
    text, so any page an operator browses must not be able to read it
    cross-origin by default — the history server's live page needs the
    operator to opt in with its origin (or '*' on a trusted host)."""

    def __init__(self, port: int,
                 render_metrics: Callable[[], str],
                 healthz: Callable[[], dict],
                 host: str = "127.0.0.1",
                 queries: Optional[Callable[[], dict]] = None,
                 console: Optional[Callable[[], str]] = None,
                 cors_origin: str = "",
                 cancel: Optional[Callable[[int], bool]] = None,
                 sql: Optional[Callable[[dict], tuple]] = None,
                 serving: Optional[Callable[[], Optional[dict]]] = None):
        self._render_metrics = render_metrics
        self._healthz = healthz
        self._queries = queries
        self._console = console
        self._cancel = cancel
        self._sql = sql
        self._serving = serving
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if cors_origin:
                    self.send_header("Access-Control-Allow-Origin",
                                     cors_origin)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = outer._render_metrics().encode()
                        self._send(200, body,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    elif path == "/healthz":
                        doc = outer._healthz()
                        code = 200 if doc.get("status") == "ok" else 503
                        self._send(code, json.dumps(doc, indent=1).encode(),
                                   "application/json")
                    elif path == "/queries" and outer._queries is not None:
                        self._send(200, json.dumps(outer._queries(),
                                                   indent=1).encode(),
                                   "application/json")
                    elif path == "/console" and outer._console is not None:
                        self._send(200, outer._console().encode(),
                                   "text/html; charset=utf-8")
                    elif path == "/serving" and outer._serving is not None:
                        doc = outer._serving()
                        if doc is None:  # serving layer not installed
                            self._send(404, b"serving disabled\n",
                                       "text/plain")
                        else:
                            self._send(200, json.dumps(doc,
                                                       indent=1).encode(),
                                       "application/json")
                    elif path == "/":
                        self._send(200, b"spark-rapids-tpu-torch obs "
                                   b"endpoint: "
                                   b"/metrics /healthz /queries "
                                   b"/console /serving; POST /sql, "
                                   b"POST /queries/<id>/cancel"
                                   b"\n", "text/plain")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 - scrape must answer
                    self._send(500, f"error: {e}\n".encode(), "text/plain")

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path == "/sql" and outer._sql is not None:
                    # the serving layer: the request executes as a
                    # top-level action ON THIS handler thread (the
                    # ThreadingHTTPServer gives each request its own
                    # daemon thread), so admission/quotas/deadlines/
                    # cancellation apply with no extra pool
                    try:
                        n = int(self.headers.get("Content-Length") or 0)
                        raw = self.rfile.read(n) if n else b"{}"
                        try:
                            payload = json.loads(raw.decode() or "{}")
                        except Exception:  # noqa: BLE001 - typed 400
                            payload = None
                        if not isinstance(payload, dict):
                            code, doc = 400, {
                                "status": "bad_request",
                                "error_type": "ValueError",
                                "message": "body must be a JSON object"}
                        else:
                            # W3C trace-context propagation: the caller's
                            # traceparent header rides into the serving
                            # layer (which honors a valid one and mints
                            # otherwise — runtime/obs/reqtrace.py)
                            tp = self.headers.get("traceparent")
                            if tp is not None:
                                payload["_traceparent"] = tp
                            code, doc = outer._sql(payload)
                        body = json.dumps(doc).encode()
                        self.send_response(code)
                        self.send_header("Content-Type",
                                         "application/json")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        if cors_origin:
                            self.send_header(
                                "Access-Control-Allow-Origin",
                                cors_origin)
                        if isinstance(doc, dict) and doc.get("traceparent"):
                            self.send_header("traceparent",
                                             doc["traceparent"])
                        self.end_headers()
                        self.wfile.write(body)
                    except Exception as e:  # noqa: BLE001 - must answer
                        self._send(500, f"error: {e}\n".encode(),
                                   "text/plain")
                    return
                m = _CANCEL_RE.match(path)
                try:
                    if m is None or outer._cancel is None:
                        self._send(404, b"not found\n", "text/plain")
                        return
                    qid = int(m.group(1))
                    ok = bool(outer._cancel(qid))
                    body = json.dumps(
                        {"query_id": qid, "cancelled": ok}).encode()
                    # 404 when the query is not in flight (finished, or
                    # never existed): cancel-after-finish is a no-op
                    self._send(200 if ok else 404, body,
                               "application/json")
                except Exception as e:  # noqa: BLE001 - must answer
                    self._send(500, f"error: {e}\n".encode(), "text/plain")

        self._server = ThreadingHTTPServer((host, int(port)), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        from spark_rapids_tpu_torch.runtime.host_pool import \
            spawn_service_thread
        self._thread = spawn_service_thread(self._server.serve_forever,
                                            name="rapids-obs-http")

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
