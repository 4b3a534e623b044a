"""The message channels of the MPMD plane (the transports of
kubedl_tpu/parallel/pipeline_mpmd.py), which the RL fleet rides.

A channel carries tag -> bytes, each message delivered exactly once:

  * QueueChannel -- in-process (tests, the in-process fleet); both
    endpoints hold the same object, and a tag still queued is refused a
    second time;
  * DirChannel -- one file a message under a shared directory, written to
    a temporary name and renamed into place, so a reader never sees a
    partial message; it works across processes (the local executor's
    stand-in for a network link). `purge()` drops what a crashed earlier
    incarnation left behind.

The stage plans, the boundary codec and the async sender of the reference
belong to the MPMD pipeline, which is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict


class QueueChannel:
    """In-process channel: tag -> bytes, delivered exactly once. Both
    endpoints hold the same object."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._msgs: Dict[str, bytes] = {}

    def send(self, tag: str, data: bytes) -> None:
        with self._cond:
            if tag in self._msgs:
                raise ValueError(f"duplicate boundary tag {tag!r}")
            self._msgs[tag] = data
            self._cond.notify_all()

    def recv(self, tag: str, timeout: float = 60.0) -> bytes:
        deadline = time.monotonic() + timeout
        with self._cond:
            while tag not in self._msgs:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"boundary recv timed out waiting for {tag!r}")
                self._cond.wait(left)
            return self._msgs.pop(tag)


_TAG_SAFE = re.compile(r"[^A-Za-z0-9._:-]")


class DirChannel:
    """File-per-message channel over a shared directory (write to a
    temporary file, then an atomic rename). Works across processes."""

    def __init__(self, path: str, poll_s: float = 0.005) -> None:
        self.path = path
        self.poll_s = poll_s
        os.makedirs(path, exist_ok=True)

    def _fname(self, tag: str) -> str:
        return os.path.join(self.path, _TAG_SAFE.sub("_", tag) + ".msg")

    def purge(self) -> int:
        """Delete every pending message -- a RESTARTING receiver calls this
        on the dirs it receives on, so messages a crashed previous
        incarnation left behind cannot be consumed as current data (tags
        restart from 1 after a restart). Returns the count."""
        n = 0
        try:
            names = os.listdir(self.path)
        except OSError:
            return 0
        for name in names:
            if name.endswith(".msg"):
                try:
                    os.unlink(os.path.join(self.path, name))
                    n += 1
                except OSError:
                    pass  # a concurrent recv consumed it
        return n

    def send(self, tag: str, data: bytes) -> None:
        final = self._fname(tag)
        tmp = final + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def recv(self, tag: str, timeout: float = 60.0) -> bytes:
        fname = self._fname(tag)
        deadline = time.monotonic() + timeout
        while True:
            try:
                with open(fname, "rb") as f:
                    data = f.read()
                os.unlink(fname)
                return data
            except FileNotFoundError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"boundary recv timed out waiting for {tag!r} "
                        f"in {self.path}") from None
                time.sleep(self.poll_s)
