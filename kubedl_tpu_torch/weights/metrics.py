"""Weight-distribution counters (the kubedl_weights_* families and
kubedl_model_version of kubedl_tpu/weights/metrics.py, the same records).

A module-level singleton, as rl/metrics.py: every distributor and relay
node in the process folds into one collector; `snapshot()` gives the
per-job records.
"""
from __future__ import annotations

import threading
from typing import Dict


class WeightsMetrics:
    """Thread-safe per-job weight-distribution health."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._jobs: Dict[str, Dict] = {}

    def _job(self, job: str) -> Dict:
        rec = self._jobs.get(job)
        if rec is None:
            rec = self._jobs[job] = {
                "versions_published": 0, "chunks_relayed": 0,
                "bytes_total": 0, "reparents": 0,
                "published_version": 0, "published_bytes": 0,
                # pod -> committed model version (the per-pod gauge)
                "pods": {},
                # pod -> bytes this pod sent onward (relay amplification)
                "node_bytes": {},
            }
        return rec

    def on_published(self, job: str, version: int, nbytes: int) -> None:
        """Root encoded + began distributing one version."""
        with self._lock:
            rec = self._job(job)
            rec["versions_published"] += 1
            rec["published_version"] = int(version)
            rec["published_bytes"] = int(nbytes)

    def on_relayed(self, job: str, node: str, nbytes: int,
                   chunks: int = 1) -> None:
        """`node` ("" = the source) sent `chunks` chunk(s) onward."""
        with self._lock:
            rec = self._job(job)
            rec["chunks_relayed"] += int(chunks)
            rec["bytes_total"] += int(nbytes)
            rec["node_bytes"][node] = (
                rec["node_bytes"].get(node, 0) + int(nbytes))

    def on_reparent(self, job: str) -> None:
        """A pod abandoned a dead parent and re-parented to the root."""
        with self._lock:
            self._job(job)["reparents"] += 1

    def on_committed(self, job: str, pod: str, version: int) -> None:
        """`pod` fully verified and adopted `version`."""
        with self._lock:
            self._job(job)["pods"][pod] = int(version)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"jobs": {
                job: {**{k: v for k, v in rec.items()
                         if k not in ("pods", "node_bytes")},
                      "pods": dict(rec["pods"]),
                      "node_bytes": dict(rec["node_bytes"])}
                for job, rec in self._jobs.items()}}

    def reset(self) -> None:
        """Test isolation — drop every recorded job."""
        with self._lock:
            self._jobs.clear()


weights_metrics = WeightsMetrics()
