"""Socket backend for the RESIZE control channel (the port's copy of
kubedl_tpu/transport/control.py; the same channels and JSON bytes).

The dir backend (executor post_control -> KUBEDL_CONTROL_DIR ->
reshard_runtime.ReshardControl) only works when the operator and the pod
share a filesystem — which is why kube-mode resizes fell back to the
checkpoint path. This module is the same protocol over the transport
plane, keeping BOTH existing seams intact:

  * operator side — ``SocketControlRouter.post`` matches the
    ``post_fn(namespace, pod, message) -> reply path | None`` contract
    of ``CapacityScheduler.attach_control``: it sends the message over
    the plane and returns a LOCAL spool path; when the pod's reply
    arrives it is written there atomically, so ``_reshard_pass`` keeps
    polling files and the reply schema is byte-for-byte the dir
    backend's.
  * pod side — ``SocketReshardControl`` is a drop-in peer of
    ``ReshardControl`` (``poll()`` at step boundaries, ``reply()``),
    reading the plane's ``control`` channel instead of a directory.

The message carries ``reply``/``reply_addr`` so the pod knows where to
send the answer — the operator's own listen address rides along the way
the reply filename does on the dir backend. Control planes run with
``latch=False``: pods legitimately restart between resizes, and reply
matching is per-tag, so stale incarnations cannot cross-talk.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from kubedl_tpu_torch.transport.plane import TransportError, TransportPlane

log = logging.getLogger("kubedl_tpu_torch.transport")

CONTROL_CHANNEL = "control"
CONTROL_REPLY_CHANNEL = "control-reply"


class SocketControlRouter:
    """Operator-side control post over the plane: dial each pod's
    transport address, spool replies as local files."""

    def __init__(
        self,
        plane: TransportPlane,
        spool_dir: str,
        addr_for: Callable[[str, str], Optional[str]],
        reply_ttl_s: float = 600.0,
        epoch_fn: Optional[Callable[[], int]] = None,
    ) -> None:
        self.plane = plane
        self.spool_dir = spool_dir
        self.addr_for = addr_for  # (namespace, pod) -> host:port | None
        # leader fencing (docs/ha.md): stamp the current epoch into
        # every control message so pods refuse a deposed operator's
        # posts; None (tests, non-HA mode) stamps epoch 0 = unfenced
        self.epoch_fn = epoch_fn
        # a pod killed mid-resize never replies: without a TTL its
        # pending entry (and a very late stale reply's spool write)
        # would outlive the scheduler's own deadline forever
        self.reply_ttl_s = reply_ttl_s
        self._lock = threading.Lock()
        self._seq = 0
        self._pending: Dict[str, tuple] = {}  # tag -> (spool path, deadline)
        os.makedirs(spool_dir, exist_ok=True)
        plane.subscribe(CONTROL_REPLY_CHANNEL, self._on_reply)

    def _prune(self, now: float) -> None:
        """Caller holds the lock."""
        dead = [t for t, (_, dl) in self._pending.items() if dl <= now]
        for t in dead:
            del self._pending[t]

    def post(self, namespace: str, name: str,
             message: Dict) -> Optional[str]:
        """The attach_control post_fn: returns the spool path the reply
        will land at, or None when the pod is unreachable (the scheduler
        then falls back closed to the checkpoint path)."""
        addr = self.addr_for(namespace, name)
        if not addr:
            return None
        now = time.monotonic()
        with self._lock:
            self._prune(now)
            self._seq += 1
            tag = f"{namespace}_{name}-{self._seq:06d}"
        path = os.path.join(self.spool_dir, f"reply-{tag}.json")
        msg = dict(message)
        msg["reply"] = tag
        msg["reply_addr"] = self.plane.bound_addr
        msg["epoch"] = int(self.epoch_fn()) if self.epoch_fn else 0
        with self._lock:
            self._pending[tag] = (path, now + self.reply_ttl_s)
        try:
            self.plane.send(
                addr, CONTROL_CHANNEL, tag,
                json.dumps(msg).encode("utf-8"))
        except (TransportError, TimeoutError) as e:
            with self._lock:
                self._pending.pop(tag, None)
            log.warning("control post to %s/%s at %s failed: %s",
                        namespace, name, addr, e)
            return None
        return path

    def _on_reply(self, tag: str, data: bytes) -> None:
        with self._lock:
            entry = self._pending.pop(tag, None)
            if entry is not None and entry[1] <= time.monotonic():
                entry = None  # expired: a stale reply must not spool
        if entry is None:
            return  # a reply nobody is waiting for (duplicate / stale)
        path = entry[0]
        tmp = path + ".tmp"
        try:
            # the payload IS the reply JSON the pod wrote — spooled
            # atomically so _reshard_pass never parses a partial reply
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            log.warning("could not spool control reply %s", tag)


class SocketReshardControl:
    """Pod-side control endpoint over the plane — the socket peer of
    reshard_runtime.ReshardControl (same poll()/reply() surface, so the
    trainer's reshard ladder is transport-blind)."""

    def __init__(self, plane: TransportPlane) -> None:
        self.plane = plane
        self._channel = plane.channel(CONTROL_CHANNEL)
        # leader fencing (docs/ha.md): highest epoch seen so far — a
        # message stamped with a LOWER (non-zero) epoch comes from a
        # deposed operator and is refused loudly, never acted on
        self._max_epoch = 0
        self.stale_epoch_refusals = 0

    def poll(self) -> Optional[dict]:
        """Earliest pending control message, or None. Cheap enough for a
        per-step call (one inbox pop, no I/O)."""
        while True:
            got = self._channel.poll()
            if got is None:
                return None
            _, data = got
            try:
                msg = json.loads(data.decode("utf-8"))
            except ValueError:
                continue  # corrupt frame payload: skip, never crash a step
            if not isinstance(msg, dict):
                continue
            epoch = int(msg.get("epoch", 0) or 0)
            if epoch and epoch < self._max_epoch:
                self.stale_epoch_refusals += 1
                log.error(
                    "control message REFUSED: fencing epoch %d is stale "
                    "(a newer leader at epoch %d has spoken) — a deposed "
                    "operator is still posting; dropping %r",
                    epoch, self._max_epoch, msg.get("reply"))
                continue
            if epoch > self._max_epoch:
                self._max_epoch = epoch
            return msg

    def reply(self, msg: dict, **payload) -> None:
        tag = msg.get("reply")
        addr = msg.get("reply_addr")
        if not tag or not addr:
            log.warning("control message carries no reply route; dropping")
            return
        try:
            self.plane.send(
                addr, CONTROL_REPLY_CHANNEL, str(tag),
                json.dumps(payload).encode("utf-8"))
        except (TransportError, TimeoutError) as e:
            # same contract as ReshardControl.reply: log, never raise —
            # a lost reply surfaces as the scheduler's deadline fallback
            log.warning("could not send reshard reply %s: %s", tag, e)
