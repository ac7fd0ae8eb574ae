"""The query server behind POST /sql (counterpart of
``spark_rapids_tpu/runtime/serving/server.py``).

One long-lived driver process, many client sessions: the reference's
serving model (a single plugin process whose concurrentGpuTasks bounds
device work across every session) lifted to an HTTP surface. Each /sql
request executes as an ordinary top-level action on the handler thread
(the obs endpoint is a ThreadingHTTPServer, one daemon thread per
request), so the whole runtime applies unchanged: admission gate,
per-query device quotas, deadlines, cooperative cancellation, the device
semaphore, live registry, history, attribution. On a card every request
issues its kernels on its handler thread's current CUDA stream; the
semaphore bounds how many run at once, and a pipelined scan still hands
its batches over by event and ``record_stream``.

The server adds three things on top:

* **bounded intake**: at most maxInflight requests inside the server
  (admitted or queued) and at most maxSessions named overlay sessions;
  past either bound the request is refused with HTTP 429 and a typed
  error doc instead of piling up;
* **per-session conf overlays**: a named session is a TorchSession on
  the root session's device, built from the root conf plus the first
  request's overlay, sharing the root session's temp views;
* **the result cache**: serving/result_cache.py, consulted before
  execution and filled after, single-flight per key.

Responses carry the Arrow IPC stream base64-encoded, the wall-time
attribution breakdown and the kernel-build delta (``xla_compiles``: the
kernel libraries ``ops/_build`` built during the request, 0 once
``build/torch_kernels`` holds them), so a load bench can explain its p99
from response docs alone.
"""
from __future__ import annotations

import base64
import os
import time
from typing import Dict, Optional, Tuple

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch.analysis import sanitizer as _san
from spark_rapids_tpu_torch.runtime.obs import live as _live
from spark_rapids_tpu_torch.runtime.obs import reqtrace as RT
from spark_rapids_tpu_torch.runtime.serving.result_cache import ResultCache


def serialize_table(tbl) -> bytes:
    """pa.Table -> Arrow IPC stream bytes (the cached/returned payload)."""
    import pyarrow as pa
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, tbl.schema) as w:
        w.write_table(tbl)
    return sink.getvalue().to_pybytes()


def deserialize_table(payload: bytes):
    import pyarrow as pa
    with pa.ipc.open_stream(pa.BufferReader(payload)) as r:
        return r.read_all()


def _error_doc(status: str, error_type: str, message: str) -> dict:
    return {"status": status, "error_type": error_type,
            "message": message}


class QueryServer:
    """Serving state attached to one root session's obs endpoint."""

    def __init__(self, session):
        self.root = session
        conf = session.conf
        self.max_sessions = int(conf.get(C.SERVING_MAX_SESSIONS))
        self.max_inflight = int(conf.get(C.SERVING_MAX_INFLIGHT))
        self.cache: Optional[ResultCache] = None
        if conf.get(C.SERVING_RESULT_CACHE_ENABLED):
            self.cache = ResultCache(
                conf.get(C.SERVING_RESULT_CACHE_MAX_BYTES),
                conf.get(C.SERVING_RESULT_CACHE_MAX_ENTRIES))
        self._lock = _san.lock("serving.server")
        self._sessions: Dict[str, object] = {}
        self._active = 0
        self._stats = {"requests": 0, "ok": 0, "rejected": 0,
                       "cancelled": 0, "failed": 0, "bad_request": 0}
        #: warm-boot outcome doc ({"waited_s", "warmed", "timed_out"}),
        #: None when warm boot didn't apply
        self.warm_boot: Optional[dict] = None
        self._warm_mgr = None
        self._warm_deadline = 0.0
        # distributed request tracing (spark.rapids.obs.reqtrace.*):
        # first-wins install like the flight recorder; the replica
        # identity stamps response docs whether or not reqtrace is on
        RT.maybe_install(conf)
        rec = RT.recorder()
        self.replica_id = rec.replica_id if rec is not None else \
            (conf.get(C.OBS_REPLICA_ID) or f"pid-{os.getpid()}")

    # -- boot -----------------------------------------------------------

    def start(self) -> None:
        """Arm the warm-boot gate: a fresh replica pointed at a shared
        historyDir and a built kernel directory must serve its first
        hot-digest query with zero kernel builds. The wait itself
        CANNOT happen here — install runs inside session __init__,
        before the caller registers the views that unblock pending
        replays — so the first request's handler thread pays it,
        bounded by warmBoot.timeoutSeconds (a timeout degrades to cold
        serving, never fails)."""
        conf = self.root.conf
        if not conf.get(C.SERVING_WARM_BOOT_ENABLED):
            return
        from spark_rapids_tpu_torch.runtime import warmup
        mgr = warmup.manager()
        if mgr is None:
            return
        timeout = float(conf.get(C.SERVING_WARM_BOOT_TIMEOUT_S))
        self._warm_mgr = mgr
        self._warm_deadline = time.monotonic() + max(timeout, 0.0)
        self.warm_boot = {"pending": True, "warmed": False,
                          "timed_out": False, "waited_s": 0.0}

    def _await_warm_boot(self) -> None:
        """Bounded wait for the warmup replay before the first
        execution, so the replay's kernel builds never land in a
        request's xla_compiles delta and the first hot-digest query runs
        against a warm keyed stage cache."""
        mgr = self._warm_mgr
        if mgr is None:
            return
        t0 = time.monotonic()
        done = mgr.wait(max(self._warm_deadline - t0, 0.0))
        with self._lock:
            if self._warm_mgr is None:  # another request finished it
                return
            self._warm_mgr = None
        self.warm_boot = {"pending": False, "warmed": bool(done),
                          "timed_out": not bool(done),
                          "waited_s": round(time.monotonic() - t0, 3)}

    # -- sessions -------------------------------------------------------

    def _resolve_session(self, name: Optional[str],
                         overlay: Optional[dict]):
        """Root session for unnamed requests; a named request gets a
        conf-overlay session (created first-use, first overlay wins) on
        the root's device, sharing the root's temp views. Returns
        (session, error_tuple)."""
        if not name:
            if overlay:
                return None, (400, _error_doc(
                    "bad_request", "ValueError",
                    "a conf overlay requires a named session"))
            return self.root, None
        with self._lock:
            sess = self._sessions.get(name)
            if sess is not None:
                return sess, None
            if len(self._sessions) >= self.max_sessions:
                self._stats["rejected"] += 1
                self._bump_rejected()
                return None, (429, _error_doc(
                    "rejected", "QueryRejectedError",
                    f"session limit reached ({self.max_sessions}; "
                    f"spark.rapids.serving.maxSessions)"))
        # construct OUTSIDE the lock (session init installs subsystems)
        values = dict(self.root.conf._values)
        values.update(overlay or {})
        # the root's device: a CPU root's overlay must not ask for the
        # card, and a card root's overlay lands on the root's card
        sess = type(self.root)(values, device=self.root.device)
        sess._views = self.root._views  # shared view namespace
        with self._lock:
            sess = self._sessions.setdefault(name, sess)
        return sess, None

    # -- request handling -----------------------------------------------

    def handle(self, payload: dict) -> Tuple[int, dict]:
        """One POST /sql request -> (http_code, response_doc).

        With reqtrace armed, the whole in-server handling runs under a
        bound RequestContext (honoring or minting the W3C traceparent
        the transport passed as payload["_traceparent"]), the "intake"
        span covers it, and the request ends with a tail-sampling
        verdict + trace identity stamped into the response doc."""
        traceparent = payload.pop("_traceparent", None)
        rctx = RT.begin_request(traceparent)
        if rctx is None:
            return self._handle_counted(payload)
        t0 = time.perf_counter()
        prev = _live.bind_request(rctx)
        try:
            with RT.request_span("intake"):
                code, doc = self._handle_counted(payload)
        finally:
            _live.bind_request(prev)
        try:
            self._finish_request(rctx, doc,
                                 (time.perf_counter() - t0) * 1e3)
        except Exception:  # noqa: BLE001 - tracing never fails a request
            pass
        return code, doc

    def _handle_counted(self, payload: dict) -> Tuple[int, dict]:
        """Bounded intake + dispatch (the pre-tracing handle body)."""
        with self._lock:
            self._stats["requests"] += 1
            if self._active >= self.max_inflight:
                self._stats["rejected"] += 1
                self._bump_rejected()
                return 429, _error_doc(
                    "rejected", "QueryRejectedError",
                    f"server at maxInflight ({self.max_inflight}; "
                    f"spark.rapids.serving.maxInflight)")
            self._active += 1
        try:
            self._bump_requests()
            return self._handle_inner(payload)
        finally:
            with self._lock:
                self._active -= 1

    def _handle_inner(self, payload: dict) -> Tuple[int, dict]:
        sql = payload.get("sql")
        if not isinstance(sql, str) or not sql.strip():
            with self._lock:
                self._stats["bad_request"] += 1
            return 400, _error_doc("bad_request", "ValueError",
                                   "payload must carry a 'sql' string")
        sess, err = self._resolve_session(payload.get("session"),
                                          payload.get("conf"))
        if err is not None:
            return err
        # serving QoS tier: a background session (requestNice > 0 in its
        # overlay) runs the whole request at raised OS niceness, and the
        # thread-local tier rides the engine's wave/pool propagation, so
        # its host-side issue of work yields to latency-tier requests
        # (the card's kernels are not prioritized)
        from spark_rapids_tpu_torch.runtime import host_pool
        nice = int(sess.conf.get(C.SERVING_REQUEST_NICE) or 0)
        if nice > 0:
            return host_pool.run_at_nice(
                nice, self._handle_on_session, payload, sess)
        return self._handle_on_session(payload, sess)

    def _handle_on_session(self, payload: dict, sess) -> Tuple[int, dict]:
        from spark_rapids_tpu_torch.runtime import compile_cache as CC
        from spark_rapids_tpu_torch.runtime import lifecycle as LC
        sql = payload["sql"]
        from spark_rapids_tpu_torch.ops._build import KernelError
        try:
            df = sess.sql(sql)
        except KernelError as e:
            # a scalar subquery's kernel failed: the engine's failure,
            # not the request's
            with self._lock:
                self._stats["failed"] += 1
            return 500, _error_doc("failed", type(e).__name__, str(e))
        except Exception as e:  # noqa: BLE001 - parse/analysis errors
            with self._lock:
                self._stats["bad_request"] += 1
            return 400, _error_doc("bad_request", type(e).__name__,
                                   str(e))

        with RT.request_span("warm_boot_wait"):
            self._await_warm_boot()
        timeout_s = payload.get("timeout_seconds")
        want_cache = bool(payload.get("cache", True))
        key = None
        if self.cache is not None:
            if want_cache:
                with RT.request_span("cache_lookup"):
                    key = self.cache.key_for(df.plan, sess.conf)
            else:
                self.cache.note_bypass()

        t0 = time.perf_counter()
        compiles0 = CC.stats()["xla_compiles"]

        def execute() -> bytes:
            with RT.request_span("execute"):
                tbl = sess.collect(df.plan, timeout_seconds=timeout_s)
            with RT.request_span("serialize"):
                return serialize_table(tbl)

        try:
            if key is not None:
                payload_bytes, outcome = self.cache.get_or_execute(
                    key, execute)
            else:
                payload_bytes, outcome = execute(), "bypass"
        except LC.QueryRejectedError as e:
            with self._lock:
                self._stats["rejected"] += 1
            self._bump_rejected()
            return 429, _error_doc("rejected", type(e).__name__, str(e))
        except LC.QueryCancelledError as e:
            with self._lock:
                self._stats["cancelled"] += 1
            doc = _error_doc("cancelled", type(e).__name__, str(e))
            # deadline vs user/fault cancel changes the tail-sampling
            # verdict (the token's first-cancel reason wins)
            doc["cancel_reason"] = getattr(e, "reason", None) or "user"
            return 499, doc
        except Exception as e:  # noqa: BLE001 - the typed failure doc
            with self._lock:
                self._stats["failed"] += 1
            return 500, _error_doc("failed", type(e).__name__, str(e))

        wall_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._stats["ok"] += 1
        doc = {
            "status": "ok",
            "session": payload.get("session") or None,
            "cache": outcome,
            "plan_digest": key[0] if key is not None else None,
            "wall_ms": round(wall_ms, 3),
            "xla_compiles": CC.stats()["xla_compiles"] - compiles0,
            "attribution": (sess.last_attribution()
                            if outcome != "hit" else None),
            "result": base64.b64encode(payload_bytes).decode("ascii"),
        }
        if outcome == "hit":
            self._record_hit_history(key[0], wall_ms)
        return 200, doc

    def _finish_request(self, rctx, doc: dict, wall_ms: float) -> None:
        """Land the tail-sampling verdict for one finished request and
        stamp the trace identity (+ any export) into the response doc
        and the serving latency histogram's exemplar."""
        status = doc.get("status", "failed")
        digest = doc.get("plan_digest")
        out = RT.end_request(
            rctx, status=status,
            cancel_reason=doc.pop("cancel_reason", None),
            slo_breach=rctx.slo_breach,
            slow_vs_baseline=self._slow_vs_baseline(
                status, digest, wall_ms / 1e3),
            error=doc.get("error_type"),
            cache_outcome=doc.get("cache"), wall_ms=wall_ms)
        doc["trace_id"] = rctx.trace_id
        doc["traceparent"] = rctx.traceparent()
        doc["replica_id"] = rctx.replica_id
        if out is not None:
            doc["reqtrace"] = {"verdict": out["verdict"],
                               "path": out["path"]}
        try:
            from spark_rapids_tpu_torch.runtime import obs as OBS
            st = OBS.state()
            if st is not None:
                ex = {"trace_id": rctx.trace_id}
                if out is not None and out["path"]:
                    ex["path"] = out["path"]
                st.registry.histogram(
                    "rapids_serving_request_ms").observe(wall_ms,
                                                         exemplar=ex)
        except Exception:  # noqa: BLE001 - metrics are advisory
            pass

    @staticmethod
    def _slow_vs_baseline(status: str, digest, wall_s: float) -> bool:
        """Did an otherwise-clean request run slower than its digest's
        history baseline mean x reqtrace.TAIL_FACTOR? (Below the SLO's
        baselineFactor — the tail between "slower than usual" and a
        breach still always exports.)"""
        if status != "ok" or not digest:
            return False
        try:
            from spark_rapids_tpu_torch.runtime import obs as OBS
            st = OBS.state()
            if st is None or st.slo is None:
                return False
            base = st.slo.baseline(digest)
            if not base or base["runs"] < st.slo.min_runs:
                return False
            return wall_s > base["mean_seconds"] * RT.TAIL_FACTOR
        except Exception:  # noqa: BLE001 - a baseline read must not
            return False  # affect the request

    def _record_hit_history(self, digest: str, wall_ms: float) -> None:
        """Cache hits make history too (type=result_cache_hit, so the
        warmup/SLO filters on type=='query' ignore them) — a digest's
        history page shows its replays next to its executions."""
        try:
            from spark_rapids_tpu_torch.runtime import obs as OBS
            st = OBS.state()
            if st is not None and st.history is not None:
                rec = {
                    "type": "result_cache_hit", "plan_digest": digest,
                    "wall_ms": round(wall_ms, 3),
                    "wall_start_unix": time.time(),
                    "replica_id": self.replica_id}
                rctx = _live.current_request()
                if rctx is not None:
                    rec["trace_id"] = rctx.trace_id
                st.history.append(rec)
        except Exception:  # noqa: BLE001 - history is advisory
            pass

    # -- counters / introspection ---------------------------------------

    @staticmethod
    def _bump_requests() -> None:
        try:
            from spark_rapids_tpu_torch.runtime import obs as OBS
            st = OBS.state()
            if st is not None:
                st.registry.counter(
                    "rapids_serving_requests_total",
                    "POST /sql requests accepted into the serving "
                    "layer (past the maxInflight bound).").inc()
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _bump_rejected() -> None:
        try:
            from spark_rapids_tpu_torch.runtime import obs as OBS
            st = OBS.state()
            if st is not None:
                st.registry.counter(
                    "rapids_serving_rejected_total",
                    "POST /sql requests refused with HTTP 429 "
                    "(maxInflight, maxSessions, or admission-gate "
                    "rejection).").inc()
        except Exception:  # noqa: BLE001
            pass

    def doc(self) -> dict:
        """The GET /serving + /healthz['serving'] + console panel doc."""
        from spark_rapids_tpu_torch.runtime import lifecycle as LC
        with self._lock:
            stats = dict(self._stats)
            active = self._active
            sessions = len(self._sessions)
        out = {
            "enabled": True,
            "replica_id": self.replica_id,
            "active_requests": active,
            "max_inflight": self.max_inflight,
            "sessions": sessions,
            "max_sessions": self.max_sessions,
            "queue_depth": LC.doc().get("queued", 0),
            "warm_boot": self.warm_boot,
            "result_cache": (self.cache.stats()
                             if self.cache is not None else None),
            "reqtrace": RT.doc(),
        }
        out.update(stats)
        return out
