"""Per-step heartbeat stream (the port's copy of `StepStream` from
kubedl_tpu/obs/steps.py; the operator-side aggregation, and the lock it
needs, stay there: the trainer writes from one thread).

The trainer emits one bounded record per step -- step time, data wait,
compile events, checkpoint stall, loss -- to its pod's
``<KUBEDL_TRACE_DIR>/<pod>.steps.jsonl`` and, as a latest-value
heartbeat, to ``<KUBEDL_CONTROL_DIR>/heartbeat.json`` (atomic tmp +
rename). The record format is the JAX package's, so the operator's
StepAggregator reads a port trainer's heartbeats unchanged.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from kubedl_tpu_torch.obs.trace import ENV_TRACE_DIR, STEP_SUFFIX

HEARTBEAT_FILE = "heartbeat.json"


class StepStream:
    """Bounded per-pod step-record stream + heartbeat writer."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 heartbeat_path: Optional[str] = None, job: str = "",
                 namespace: str = "", pod: str = "",
                 max_records: int = 100_000) -> None:
        self.jsonl_path = jsonl_path
        self.heartbeat_path = heartbeat_path
        self.job = job
        self.namespace = namespace
        self.pod = pod
        self.max_records = max_records
        self.written = 0
        self.dropped = 0
        self.compiles = 0  # cumulative compile events this incarnation
        self._fh = None

    @classmethod
    def from_env(cls, pod: str = "") -> Optional["StepStream"]:
        """None when neither a trace dir nor a control dir was injected."""
        trace_dir = os.environ.get(ENV_TRACE_DIR, "")
        control_dir = os.environ.get("KUBEDL_CONTROL_DIR", "")
        if not trace_dir and not control_dir:
            return None
        pod = pod or os.environ.get("POD_NAME", "") or f"pid-{os.getpid()}"
        jsonl = None
        if trace_dir:
            try:
                os.makedirs(trace_dir, exist_ok=True)
                jsonl = os.path.join(trace_dir, f"{pod}{STEP_SUFFIX}")
            except OSError:
                jsonl = None
        heartbeat = (os.path.join(control_dir, HEARTBEAT_FILE)
                     if control_dir else None)
        return cls(jsonl_path=jsonl, heartbeat_path=heartbeat,
                   job=os.environ.get("KUBEDL_LABEL_JOB_NAME", ""),
                   namespace=os.environ.get("POD_NAMESPACE", ""), pod=pod)

    def record(self, step: int, step_s: float, data_s: float = 0.0,
               loss: Optional[float] = None, compile: bool = False,
               ckpt_s: float = 0.0) -> Dict:
        if compile:
            self.compiles += 1
        rec = {
            "job": self.job,
            "namespace": self.namespace,
            "pod": self.pod,
            "step": int(step),
            "step_s": round(float(step_s), 6),
            "data_s": round(float(data_s), 6),
            "ckpt_s": round(float(ckpt_s), 6),
            "compile": bool(compile),
            "compiles": self.compiles,
            "t": time.time(),
        }
        if loss is not None:
            rec["loss"] = float(loss)
        line = json.dumps(rec)
        if self.jsonl_path:
            if self.written >= self.max_records:
                self.dropped += 1
            else:
                try:
                    if self._fh is None:
                        self._fh = open(self.jsonl_path, "a")
                    self._fh.write(line + "\n")
                    self._fh.flush()
                    self.written += 1
                except OSError:
                    self.dropped += 1
        if self.heartbeat_path:
            # atomic replace: the operator's scan never parses half a record
            tmp = self.heartbeat_path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    f.write(line)
                os.replace(tmp, self.heartbeat_path)
            except OSError:
                pass
        return rec

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
