"""Flight-recorder trace spans (the port's copy of the workload side of
kubedl_tpu/obs/trace.py).

Every recorded interval is one JSON record, the JAX package's format:

    {"name", "trace_id", "span_id", "parent_id", "service",
     "ts" (epoch seconds), "dur" (seconds), "attrs": {...}}

appended to ``<KUBEDL_TRACE_DIR>/<service>.jsonl`` when the executor
injected that directory, so `kubedl-tpu trace` and the goodput accountant
read a port trainer's spans unchanged. Only what a workload writes is
copied here: retroactive `record` and per-file export; the in-process ring,
the operator's per-job routing and the Chrome-trace view stay in the JAX
package.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, Optional

ENV_TRACE_DIR = "KUBEDL_TRACE_DIR"
ENV_TRACE_ID = "KUBEDL_TRACE_ID"

# step-record streams (obs/steps.py) share the trace dir but are not spans
STEP_SUFFIX = ".steps.jsonl"


class Tracer:
    """Span recorder with optional JSONL export to one file. Past
    ``max_export_spans`` records the file stops growing (``dropped`` counts
    the records it did not take)."""

    def __init__(self, service: str = "", trace_id: str = "",
                 export_path: Optional[str] = None,
                 max_export_spans: int = 20000) -> None:
        self.service = service
        self.trace_id = trace_id
        self.export_path = export_path
        self.max_export_spans = max_export_spans
        self._lock = threading.Lock()
        self._fh = None
        self._exported = 0
        self.dropped = 0
        self._ids = itertools.count(1)

    @property
    def exporting(self) -> bool:
        return bool(self.export_path)

    def _next_id(self) -> str:
        return f"{os.getpid():x}-{next(self._ids):x}"

    def record(self, name: str, duration_s: float = 0.0,
               end_ts: Optional[float] = None, trace_id: Optional[str] = None,
               **attrs) -> Dict:
        """Record a finished interval: ``ts`` is back-dated so the span
        covers the ``duration_s`` that just ended."""
        end_ts = time.time() if end_ts is None else end_ts
        rec = {
            "name": name,
            "trace_id": trace_id if trace_id is not None else self.trace_id,
            "span_id": self._next_id(),
            "parent_id": "",
            "service": self.service,
            "ts": end_ts - max(duration_s, 0.0),
            "dur": max(duration_s, 0.0),
            "attrs": dict(attrs),
        }
        if not self.export_path:
            return rec
        with self._lock:
            if self._exported >= self.max_export_spans:
                self.dropped += 1
                return rec
            try:
                if self._fh is None:
                    os.makedirs(os.path.dirname(self.export_path), exist_ok=True)
                    self._fh = open(self.export_path, "a")
                self._fh.write(json.dumps(rec, default=str) + "\n")
                self._fh.flush()
                self._exported += 1
            except OSError:
                self.dropped += 1
        return rec

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def tracer_from_env(service: str = "") -> Tracer:
    """Workload-side tracer from the injected env: exports to
    ``<KUBEDL_TRACE_DIR>/<service>.jsonl`` with the gang trace id from
    ``KUBEDL_TRACE_ID``; without the env it writes nothing."""
    service = service or os.environ.get("POD_NAME", "") or f"pid-{os.getpid()}"
    d = os.environ.get(ENV_TRACE_DIR, "")
    path = None
    if d:
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{service}.jsonl")
        except OSError:
            path = None
    return Tracer(service=service, trace_id=os.environ.get(ENV_TRACE_ID, ""),
                  export_path=path)
