"""Serving-layer lifecycle (spark.rapids.serving.*; counterpart of
``spark_rapids_tpu/runtime/serving/__init__.py``).

Installation is first-wins, like obs and warmup: the FIRST session
constructed with serving.enabled=true becomes the root of the
process-wide QueryServer; later sessions (the server's own overlay
sessions included) see it installed and do nothing. The server itself is
transport-free: runtime/obs/endpoint.py calls ``handle_sql()`` /
``server_doc()`` through the callbacks obs.install wires in, so with
serving off those routes answer 404 and an ordinary query pays one
module-global read. ``reset_for_tests()`` drops the server (tests and
``chip_smoke.py``'s serving phase).
"""
from __future__ import annotations

from typing import Optional, Tuple

from spark_rapids_tpu_torch.analysis import sanitizer as _san
from spark_rapids_tpu_torch.runtime.serving.server import QueryServer

_LOCK = _san.lock("serving.install")
_SERVER: Optional[QueryServer] = None


def maybe_install(session) -> None:
    """Install the process-wide query server for this session when
    spark.rapids.serving.enabled is set (first session wins)."""
    from spark_rapids_tpu_torch import config as C
    global _SERVER
    if _SERVER is not None:  # one global read on the common path
        return
    if not session.conf.get(C.SERVING_ENABLED):
        return
    with _LOCK:
        if _SERVER is not None:
            return
        srv = QueryServer(session)
        _SERVER = srv
    # warm-boot wait OUTSIDE the lock (it can block for seconds)
    srv.start()


def installed() -> bool:
    return _SERVER is not None


def server() -> Optional[QueryServer]:
    return _SERVER


def handle_sql(payload: dict) -> Tuple[int, dict]:
    """POST /sql entry point (called by the obs endpoint handler)."""
    srv = _SERVER
    if srv is None:
        return 404, {"status": "failed", "error_type": "RuntimeError",
                     "message": "serving layer not installed "
                                "(spark.rapids.serving.enabled)"}
    return srv.handle(payload)


def server_doc() -> Optional[dict]:
    """GET /serving + /healthz['serving'] document (None when off)."""
    srv = _SERVER
    if srv is None:
        return None
    try:
        return srv.doc()
    except Exception:  # noqa: BLE001 - introspection never breaks obs
        return None


def reset_for_tests() -> None:
    global _SERVER
    with _LOCK:
        _SERVER = None
