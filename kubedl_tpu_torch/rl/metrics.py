"""RL-plane counters and gauges (the kubedl_rl_* families of
kubedl_tpu/rl/metrics.py, the same records).

A module-level singleton: every actor and learner runtime in the process
folds into one collector, and `snapshot()` gives the per-job records the
operator's /metrics renders. Pods feed their OWN process's singleton; the
in-process fleet shows the whole plane, and across processes the trace
spans carry it.
"""
from __future__ import annotations

import threading
from typing import Dict


class RLMetrics:
    """Thread-safe per-job RL fleet health."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._jobs: Dict[str, Dict] = {}

    def _job(self, job: str) -> Dict:
        rec = self._jobs.get(job)
        if rec is None:
            rec = self._jobs[job] = {
                "produced": 0, "consumed": 0, "stale_dropped": 0,
                "queue_depth": 0, "weight_lag": 0, "weight_version": 0,
                "learn_steps": 0,
            }
        return rec

    def on_produced(self, job: str, n: int = 1) -> None:
        with self._lock:
            rec = self._job(job)
            rec["produced"] += n
            rec["queue_depth"] = max(rec["produced"] - rec["consumed"]
                                     - rec["stale_dropped"], 0)

    def on_consumed(self, job: str, weight_lag: int = 0) -> None:
        with self._lock:
            rec = self._job(job)
            rec["consumed"] += 1
            rec["weight_lag"] = int(weight_lag)
            rec["queue_depth"] = max(rec["produced"] - rec["consumed"]
                                     - rec["stale_dropped"], 0)

    def on_stale_dropped(self, job: str, weight_lag: int = 0) -> None:
        with self._lock:
            rec = self._job(job)
            rec["stale_dropped"] += 1
            rec["weight_lag"] = int(weight_lag)
            rec["queue_depth"] = max(rec["produced"] - rec["consumed"]
                                     - rec["stale_dropped"], 0)

    def on_weights_published(self, job: str, version: int) -> None:
        with self._lock:
            self._job(job)["weight_version"] = int(version)

    def observe_rollout(self, job: str, tokens_per_s: float) -> None:
        with self._lock:
            self._job(job)["rollout_tok_s"] = float(tokens_per_s)

    def observe_learn(self, job: str, step_s: float, loss: float) -> None:
        with self._lock:
            rec = self._job(job)
            rec["learn_steps"] += 1
            rec["learn_step_s"] = float(step_s)
            rec["loss"] = float(loss)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"jobs": {job: dict(rec)
                             for job, rec in self._jobs.items()}}

    def reset(self) -> None:
        """Test isolation — drop every recorded job."""
        with self._lock:
            self._jobs.clear()


rl_metrics = RLMetrics()
