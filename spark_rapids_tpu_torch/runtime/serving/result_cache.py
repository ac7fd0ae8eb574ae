"""Plan-digest-keyed result cache for the serving layer (counterpart of
``spark_rapids_tpu/runtime/serving/result_cache.py``).

A hit returns the byte-identical Arrow IPC stream of an earlier
execution: the payload is stored SERIALIZED (pa.ipc stream bytes, host
memory), so byte parity with execution is structural, the byte
accounting of the LRU bound is exact len(), and a hit makes no call on
the card.

Coherence rides the table-version epoch of the broadcast-reuse cache
(exec/adaptive.py): the key is (plan digest, table epoch, conf
fingerprint), so any create_or_replace_temp_view orphans every earlier
entry. The conf fingerprint (runtime/compile_cache._fp_of: ANSI mode,
the float-ops mode) is in the key so ANSI-divergent plans never share
entries. Plans containing non-deterministic expressions (rand) get no
key and bypass the cache.

The digest is the one the query's history record and SLO baseline carry:
``convert_plan`` prunes a plan in place at its first conversion, so the
key prunes first (ROADMAP C26, C28). The JAX package digests the plan as
built.

Concurrent same-key requests are single-flight: the first becomes the
leader and executes; followers wait on a per-key event in bounded slices
and read the entry the leader inserted. A leader that fails clears the
in-flight marker so a follower retries as the new leader: a failure is
never cached.

Every hit/miss/eviction/bypass is a counter on the obs registry and a
local stat the /serving doc and the console table show.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from spark_rapids_tpu_torch.analysis import sanitizer as _san


def _bump(name: str, help_text: str, v: int = 1) -> None:
    try:
        from spark_rapids_tpu_torch.runtime import obs as OBS
        st = OBS.state()
        if st is not None:
            st.registry.counter(name, help_text).inc(v)
    except Exception:  # noqa: BLE001 - observability never fails serving
        pass


def _plan_has_nondeterminism(plan) -> bool:
    """Walk the logical plan's expressions for non-deterministic nodes
    (Rand — rand()/sample()/random_split()). Generic attribute walk so a
    rand buried in any operator's expression list is found."""
    from spark_rapids_tpu_torch.expr.core import Expression
    from spark_rapids_tpu_torch.expr.misc import Rand

    def expr_has(e) -> bool:
        if isinstance(e, Rand):
            return True
        return any(expr_has(c) for c in getattr(e, "children", ()))

    def exprs_of(node):
        for v in vars(node).values():
            if isinstance(v, Expression):
                yield v
            elif isinstance(v, (list, tuple)):
                for item in v:
                    if isinstance(item, Expression):
                        yield item
                    elif isinstance(item, tuple):
                        for sub in item:
                            if isinstance(sub, Expression):
                                yield sub

    def walk(node) -> bool:
        if any(expr_has(e) for e in exprs_of(node)):
            return True
        return any(walk(c) for c in getattr(node, "children", ()))

    return walk(plan)


class ResultCache:
    """Bounded LRU of serialized query results, single-flight on miss."""

    def __init__(self, max_bytes: int, max_entries: int):
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self._lock = _san.lock("serving.resultCache")
        self._entries: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._bytes = 0
        self._inflight: Dict[tuple, threading.Event] = {}
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "bypasses": 0}

    # -- keying ---------------------------------------------------------

    def key_for(self, plan, conf) -> Optional[tuple]:
        """Cache key for a logical plan under a conf, or None when the
        plan must bypass the cache (non-deterministic expressions)."""
        if _plan_has_nondeterminism(plan):
            with self._lock:
                self._stats["bypasses"] += 1
            _bump("rapids_result_cache_bypasses_total",
                  "Serving requests that bypassed the result cache "
                  "(non-deterministic plan or cache=false).")
            return None
        from spark_rapids_tpu_torch.exec import adaptive as AQ
        from spark_rapids_tpu_torch.plan.prune import prune_plan
        from spark_rapids_tpu_torch.runtime import compile_cache as CC
        from spark_rapids_tpu_torch.runtime.obs.history import plan_digest
        # the record's digest: collect would prune the plan in place
        # before its epilogue digests it (ROADMAP C26, C28)
        prune_plan(plan)
        return (plan_digest(plan), AQ.table_epoch(), CC._fp_of(conf))

    def note_bypass(self) -> None:
        """An explicit per-request cache=false bypass (counted the same
        as a non-deterministic one)."""
        with self._lock:
            self._stats["bypasses"] += 1
        _bump("rapids_result_cache_bypasses_total",
              "Serving requests that bypassed the result cache "
              "(non-deterministic plan or cache=false).")

    # -- lookup / fill --------------------------------------------------

    def lookup(self, key: tuple) -> Optional[bytes]:
        with self._lock:
            payload = self._entries.get(key)
            if payload is not None:
                self._entries.move_to_end(key)
                self._stats["hits"] += 1
        if payload is not None:
            _bump("rapids_result_cache_hits_total",
                  "Serving result-cache hits (byte-identical replay of "
                  "a prior execution with the same plan digest, table "
                  "epoch, and compile fingerprint).")
        return payload

    def get_or_execute(self, key: tuple,
                       execute: Callable[[], bytes]
                       ) -> Tuple[bytes, str]:
        """Return (payload, 'hit'|'miss'). Single-flight: concurrent
        callers of the same key wait for one execution and share it."""
        while True:
            payload = self.lookup(key)
            if payload is not None:
                return payload, "hit"
            with self._lock:
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    leader = True
                else:
                    leader = False
            if leader:
                try:
                    payload = execute()
                    self._insert(key, payload)
                    return payload, "miss"
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                    ev.set()
            # follower: wait in bounded slices, then re-check — if the
            # leader failed (no entry), loop back and become the leader
            from spark_rapids_tpu_torch.runtime.obs import reqtrace as _rt
            with _rt.request_span("single_flight_wait"):
                while not ev.wait(timeout=0.05):
                    pass

    def _insert(self, key: tuple, payload: bytes) -> None:
        n = len(payload)
        with self._lock:
            self._stats["misses"] += 1
            if n > self.max_bytes or self.max_entries <= 0:
                evicted = 0  # payload larger than the whole cache
            else:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= len(old)
                self._entries[key] = payload
                self._bytes += n
                evicted = 0
                while (self._bytes > self.max_bytes
                       or len(self._entries) > self.max_entries):
                    _, dropped = self._entries.popitem(last=False)
                    self._bytes -= len(dropped)
                    evicted += 1
                self._stats["evictions"] += evicted
        _bump("rapids_result_cache_misses_total",
              "Serving result-cache misses (the request executed and "
              "its serialized result was inserted).")
        if evicted:
            _bump("rapids_result_cache_evictions_total",
                  "Serving result-cache LRU evictions (byte or entry "
                  "bound exceeded).", evicted)

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
        looked = out["hits"] + out["misses"]
        out["hit_ratio"] = (out["hits"] / looked) if looked else 0.0
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
