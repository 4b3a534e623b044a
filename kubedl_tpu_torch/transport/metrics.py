"""Transport-plane counters, the kubedl_transport_* families (the port's
copy of kubedl_tpu/transport/metrics.py, the same records).

A module-level singleton: every plane in the process folds into one
collector, and `snapshot()` gives the dict the operator's /metrics renders
(the same keys and values as the JAX package's for the same events).
Counters only: the plane must never block on its own accounting.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


class TransportMetrics:
    """Thread-safe counters for every transport plane in the process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (channel, dir) -> count/bytes; dir is "send" | "recv"
        self._messages: Dict[Tuple[str, str], int] = {}
        self._bytes: Dict[Tuple[str, str], int] = {}
        self._connects = 0
        self._reconnects = 0
        self._auth_failures = 0
        self._torn_frames = 0
        self._stale_boot = 0
        self._heartbeats = 0

    def on_message(self, channel: str, direction: str, nbytes: int) -> None:
        key = (channel, direction)
        with self._lock:
            self._messages[key] = self._messages.get(key, 0) + 1
            self._bytes[key] = self._bytes.get(key, 0) + int(nbytes)

    def on_connect(self, reconnect: bool = False) -> None:
        with self._lock:
            if reconnect:
                self._reconnects += 1
            else:
                self._connects += 1

    def on_auth_failure(self) -> None:
        with self._lock:
            self._auth_failures += 1

    def on_torn_frame(self) -> None:
        with self._lock:
            self._torn_frames += 1

    def on_stale_boot(self) -> None:
        with self._lock:
            self._stale_boot += 1

    def on_heartbeat(self) -> None:
        with self._lock:
            self._heartbeats += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "messages_total": {
                    f"{ch}/{d}": n for (ch, d), n in sorted(self._messages.items())
                },
                "bytes_total": {
                    f"{ch}/{d}": n for (ch, d), n in sorted(self._bytes.items())
                },
                "connects_total": self._connects,
                "reconnects_total": self._reconnects,
                "auth_failures_total": self._auth_failures,
                "torn_frames_total": self._torn_frames,
                "stale_boot_refusals_total": self._stale_boot,
                "heartbeats_total": self._heartbeats,
            }

    def reset(self) -> None:
        """Test isolation: zero every counter."""
        with self._lock:
            self._messages.clear()
            self._bytes.clear()
            self._connects = self._reconnects = 0
            self._auth_failures = self._torn_frames = 0
            self._stale_boot = self._heartbeats = 0


transport_metrics = TransportMetrics()
