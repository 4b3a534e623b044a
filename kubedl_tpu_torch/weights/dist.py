"""Pipelined chunk relay over the broadcast tree (the port's copy of
kubedl_tpu/weights/dist.py: the same tags, records and repair).

One version's serialized state (an rl/wire record — per-array dtype
recorded, bf16 byte-identical) is cut into fixed-size sha-checked
chunks and pushed down the `tree.py` topology:

* the source sends the announce (chunk shas + the tree order — a tiny
  control record) directly to EVERY pod, then chunks -> manifest to
  its <= f direct children only; every interior pod RELAYS chunk i to
  its children while receiving chunk i+1, so a version's BYTES reach
  n pods in ~depth extra chunk-times instead of n serial
  payload-times. Announcing to all is what makes a dead parent
  detectable anywhere in the tree: every pod knows the version is in
  flight and starts its chunk clock immediately;
* the announce travels FIRST so a relay can verify each chunk before
  forwarding it; the manifest travels LAST and is the commit point —
  a receiver adopts a version only after every chunk sha and the
  assembled payload sha verify (manifest-last, the reshard staging
  discipline);
* delivery tags are deterministic per (version, chunk), so a resent
  message is dropped, not re-applied;
* a pod whose parent dies mid-relay re-parents to the ROOT loudly
  (counted + spanned): it asks the source to serve the remaining
  chunks directly, then keeps relaying to its own children — a dead
  interior node costs its subtree one repair round-trip, never a torn
  version (descendants that stall independently re-parent too).

Channels are anything with ``send(tag, bytes)`` / ``recv(tag,
timeout)`` — QueueChannel in-process, DirChannel across processes
(parallel/pipeline_mpmd.py; same duck type as rl/weights.py).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubedl_tpu_torch.weights.metrics import weights_metrics
from kubedl_tpu_torch.weights.tree import ROOT, TreeSpec, build_tree, validate_tree

log = logging.getLogger("kubedl_tpu_torch.weights")

#: chunk + announce + manifest traffic (parent -> child, root -> child)
WEIGHTS_CHANNEL = "weights-dist"
#: pod -> root: reparent requests + commit acks
WEIGHTS_CONTROL_CHANNEL = "weights-ctl"

ENV_FANOUT = "KUBEDL_WEIGHTS_FANOUT"
ENV_CHUNK_BYTES = "KUBEDL_WEIGHTS_CHUNK_BYTES"

DEFAULT_FANOUT = 4
DEFAULT_CHUNK_BYTES = 1 << 20


class WeightsError(RuntimeError):
    """Distribution failed loudly (verification, topology, or repair)."""


def env_fanout(env=None) -> int:
    env = os.environ if env is None else env
    return int(env.get(ENV_FANOUT, DEFAULT_FANOUT))


def env_chunk_bytes(env=None) -> int:
    env = os.environ if env is None else env
    return int(env.get(ENV_CHUNK_BYTES, DEFAULT_CHUNK_BYTES))


# -- tags (deterministic: the dedup + resend contract) ----------------------


def announce_tag(version: int) -> str:
    return f"wd.{version:08d}.a"


def chunk_tag(version: int, i: int) -> str:
    return f"wd.{version:08d}.c{i:05d}"


def manifest_tag(version: int) -> str:
    return f"wd.{version:08d}.m"


def reparent_tag(version: int, pod: str) -> str:
    return f"rp.{version:08d}.{pod}"


def commit_tag(version: int, pod: str) -> str:
    return f"ok.{version:08d}.{pod}"


# -- codec ------------------------------------------------------------------


def chunk_payload(payload: bytes, chunk_bytes: int) -> List[bytes]:
    if chunk_bytes < 1:
        raise ValueError(f"chunk_bytes must be >= 1, got {chunk_bytes}")
    if not payload:
        raise ValueError("empty weights payload")
    return [payload[i:i + chunk_bytes]
            for i in range(0, len(payload), chunk_bytes)]


def encode_announce(spec: TreeSpec, step: int, chunk_bytes: int,
                    chunks: Sequence[bytes], payload_sha: str,
                    total_bytes: int, job: str) -> bytes:
    """The version's plan, sent FIRST: tree order + per-chunk shas, so
    every relay can verify-then-forward without holding the payload."""
    return json.dumps({
        "version": spec.version,
        "step": int(step),
        "pods": list(spec.order),
        "fanout": spec.fanout,
        "job": job,
        "n_chunks": len(chunks),
        "chunk_bytes": int(chunk_bytes),
        "chunk_shas": [hashlib.sha256(c).hexdigest() for c in chunks],
        "payload_sha": payload_sha,
        "total_bytes": int(total_bytes),
    }, sort_keys=True).encode("utf-8")


@dataclass(frozen=True)
class Announce:
    version: int
    step: int
    spec: TreeSpec
    job: str
    n_chunks: int
    chunk_bytes: int
    chunk_shas: Tuple[str, ...]
    payload_sha: str
    total_bytes: int


def decode_announce(data: bytes) -> Announce:
    header = json.loads(data.decode("utf-8"))
    spec = TreeSpec(version=int(header["version"]),
                    fanout=int(header["fanout"]),
                    order=tuple(header["pods"]))
    return Announce(
        version=int(header["version"]),
        step=int(header["step"]),
        spec=spec,
        job=str(header.get("job", "")),
        n_chunks=int(header["n_chunks"]),
        chunk_bytes=int(header["chunk_bytes"]),
        chunk_shas=tuple(header["chunk_shas"]),
        payload_sha=str(header["payload_sha"]),
        total_bytes=int(header["total_bytes"]),
    )


def encode_manifest(version: int, n_chunks: int, payload_sha: str,
                    total_bytes: int) -> bytes:
    """The commit record, sent LAST — its arrival promises every chunk
    was already sent (the staging marker-then-manifest ordering)."""
    return json.dumps({
        "version": int(version),
        "n_chunks": int(n_chunks),
        "payload_sha": payload_sha,
        "total_bytes": int(total_bytes),
    }, sort_keys=True).encode("utf-8")


def decode_manifest(data: bytes) -> Tuple[int, int, str, int]:
    header = json.loads(data.decode("utf-8"))
    return (int(header["version"]), int(header["n_chunks"]),
            str(header["payload_sha"]), int(header["total_bytes"]))


def _reparent_request(pod: str, version: int, have: int) -> bytes:
    return json.dumps({
        "pod": pod, "version": int(version), "have": int(have),
    }, sort_keys=True).encode("utf-8")


def _take_reparent(data: bytes) -> int:
    """Contiguous chunks the requester already verified (resume point)."""
    req = json.loads(data.decode("utf-8"))
    return int(req["have"])


@contextlib.contextmanager
def _span(tracer, name: str, **attrs):
    """Record the block as one span (obs/trace.py `Tracer.record`)."""
    if tracer is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        tracer.record(name, duration_s=time.perf_counter() - t0, **attrs)


def _send(channel, tag: str, data: bytes) -> None:
    """Send tolerating an idempotent resend: QueueChannel raises
    ValueError on a still-queued duplicate tag (the message is already
    waiting — delivered is delivered)."""
    try:
        channel.send(tag, data)
    except ValueError:
        pass


# -- the source -------------------------------------------------------------


class RootDistributor:
    """The source half: fan one serialized version out to every pod.

    `channels[pod]` is a send handle to that pod's weights inbox (the
    root can reach EVERY pod directly — that is what makes
    reparent-to-root a repair, not a reconfiguration); `control` is the
    root's receive inbox for reparent requests and commit acks."""

    def __init__(
        self,
        pods: Sequence[str],
        channels: Dict[str, object],
        control,
        job: str = "",
        fanout: Optional[int] = None,
        chunk_bytes: Optional[int] = None,
        tracer=None,
    ) -> None:
        missing = [p for p in pods if p not in channels]
        if missing:
            raise ValueError(f"no channel for pods {missing}")
        self.pods = list(pods)
        self.channels = dict(channels)
        self.control = control
        self.job = job
        self.fanout = int(fanout) if fanout else env_fanout()
        self.chunk_bytes = (int(chunk_bytes) if chunk_bytes
                            else env_chunk_bytes())
        self.tracer = tracer
        self.reparents = 0

    def distribute(self, payload: bytes, version: int, step: int = 0,
                   wait_commit: bool = True,
                   timeout: float = 60.0) -> Dict:
        """Push one version down its tree; with `wait_commit`, serve
        reparent requests until every pod acks the commit (raises
        WeightsError listing the pods still missing at the deadline —
        those pods are still on their previous fully-verified version,
        never a torn one)."""
        t0 = time.monotonic()
        spec = build_tree(self.pods, version, self.fanout)
        chunks = chunk_payload(payload, self.chunk_bytes)
        payload_sha = hashlib.sha256(payload).hexdigest()
        ann = encode_announce(spec, step, self.chunk_bytes, chunks,
                              payload_sha, len(payload), self.job)
        man = encode_manifest(version, len(chunks), payload_sha,
                              len(payload))
        weights_metrics.on_published(self.job, version, len(payload))
        with _span(self.tracer, "weights.distribute", job=self.job,
                   version=version, pods=len(self.pods),
                   fanout=spec.fanout, chunks=len(chunks),
                   bytes=len(payload)):
            children = spec.children(ROOT)
            # announce goes to EVERY pod (tiny control record): a pod
            # whose ancestor dies before forwarding anything still
            # learns the version is in flight and can re-parent on its
            # first chunk timeout instead of waiting forever
            for pod in self.pods:
                _send(self.channels[pod], announce_tag(version), ann)
            for i, chunk in enumerate(chunks):
                for pod in children:
                    _send(self.channels[pod], chunk_tag(version, i), chunk)
                    weights_metrics.on_relayed(self.job, ROOT, len(chunk))
            for pod in children:
                _send(self.channels[pod], manifest_tag(version), man)
            committed: List[str] = []
            reparented: List[str] = []
            if wait_commit:
                committed, reparented = self._serve(
                    version, ann, chunks, man, timeout)
        report = {
            "version": version,
            "n_chunks": len(chunks),
            "payload_bytes": len(payload),
            "committed": committed,
            "reparented": reparented,
            "wall_s": time.monotonic() - t0,
        }
        if wait_commit and len(committed) != len(self.pods):
            missing = sorted(set(self.pods) - set(committed))
            raise WeightsError(
                f"version {version} fan-out incomplete after "
                f"{timeout:.1f}s: {len(missing)} pod(s) never committed "
                f"{missing[:8]} — they remain on their previous version")
        return report

    def _serve(self, version: int, ann: bytes, chunks: List[bytes],
               man: bytes, timeout: float) -> Tuple[List[str], List[str]]:
        """Commit-ack collection + reparent service window."""
        deadline = time.monotonic() + timeout
        pending = set(self.pods)
        committed: List[str] = []
        reparented: List[str] = []
        while pending and time.monotonic() < deadline:
            progressed = False
            for pod in sorted(pending):
                try:
                    self.control.recv(commit_tag(version, pod),
                                      timeout=0.0)
                except TimeoutError:
                    pass
                else:
                    pending.discard(pod)
                    committed.append(pod)
                    progressed = True
            for pod in sorted(pending):
                try:
                    data = self.control.recv(reparent_tag(version, pod),
                                             timeout=0.0)
                except TimeoutError:
                    continue
                have = _take_reparent(data)
                self.reparents += 1
                reparented.append(pod)
                weights_metrics.on_reparent(self.job)
                log.warning(
                    "weights: pod %s re-parented to root for version %d "
                    "(had %d/%d chunks) — its parent is presumed dead",
                    pod, version, have, len(chunks))
                with _span(self.tracer, "weights.reparent", job=self.job,
                           version=version, pod=pod, have=have):
                    ch = self.channels[pod]
                    _send(ch, announce_tag(version), ann)
                    for i in range(max(have, 0), len(chunks)):
                        _send(ch, chunk_tag(version, i), chunks[i])
                        weights_metrics.on_relayed(
                            self.job, ROOT, len(chunks[i]))
                    _send(ch, manifest_tag(version), man)
                progressed = True
            if not progressed:
                time.sleep(0.005)
        return committed, reparented


# -- a pod ------------------------------------------------------------------


class RelayNode:
    """The pod half: receive, verify, relay onward, adopt, ack.

    `recv` is this pod's weights inbox; `child_channel(pod)` returns a
    send handle toward another pod (used only for this version's
    children — the tree rotates per version); `control` sends toward
    the root. `on_deliver(payload, version, step)` fires exactly once
    per adopted version, AFTER full verification."""

    def __init__(
        self,
        pod: str,
        recv,
        child_channel: Callable[[str], object],
        control,
        on_deliver: Callable[[bytes, int, int], None],
        job: str = "",
        chunk_timeout: float = 2.0,
        repair_timeout: float = 10.0,
        tracer=None,
    ) -> None:
        self.pod = pod
        self.recv = recv
        self.child_channel = child_channel
        self.control = control
        self.on_deliver = on_deliver
        self.job = job
        self.chunk_timeout = chunk_timeout
        self.repair_timeout = repair_timeout
        self.tracer = tracer
        self.version = 0  # newest adopted (0 = base)
        self.reparented = 0
        self._children_cache: Dict[str, object] = {}

    def _child(self, pod: str):
        ch = self._children_cache.get(pod)
        if ch is None:
            ch = self._children_cache[pod] = self.child_channel(pod)
        return ch

    def _recv_or_reparent(self, tag: str, version: int,
                          have: int) -> bytes:
        """One message from the parent; on timeout, re-parent to the
        root (loudly) and wait for the root's direct resend."""
        try:
            return self.recv.recv(tag, timeout=self.chunk_timeout)
        except TimeoutError:
            pass
        self.reparented += 1
        weights_metrics.on_reparent(self.job)
        log.warning(
            "weights: pod %s parent silent for %.1fs at %s — "
            "re-parenting to root", self.pod, self.chunk_timeout, tag)
        _send(self.control, reparent_tag(version, self.pod),
              _reparent_request(self.pod, version, have))
        try:
            return self.recv.recv(tag, timeout=self.repair_timeout)
        except TimeoutError:
            raise WeightsError(
                f"pod {self.pod}: version {version} unrecoverable — "
                f"root did not resend {tag} within "
                f"{self.repair_timeout:.1f}s") from None

    def poll(self, timeout: float = 0.0) -> Optional[int]:
        """Receive + relay + adopt the NEXT version if its announce
        arrives within `timeout`; returns the adopted version or None.
        Any verification failure raises — a pod never adopts (or acks)
        a version whose bytes it could not prove."""
        version = self.version + 1
        try:
            ann_bytes = self.recv.recv(announce_tag(version),
                                       timeout=timeout)
        except TimeoutError:
            return None
        ann = decode_announce(ann_bytes)
        bad = validate_tree(ann.spec, ann.spec.order)
        if bad is not None or ann.n_chunks != len(ann.chunk_shas):
            raise WeightsError(
                f"pod {self.pod}: version {version} announce invalid: "
                f"{bad or 'chunk sha count mismatch'}")
        children = ann.spec.children(self.pod)  # raises if pod absent
        with _span(self.tracer, "weights.relay", job=self.job,
                   version=version, pod=self.pod,
                   children=len(children), chunks=ann.n_chunks):
            # no announce forward: the root announced to every pod
            # directly, so children already hold the plan even when
            # THIS node dies before relaying a single chunk
            parts: List[bytes] = []
            for i in range(ann.n_chunks):
                chunk = self._recv_or_reparent(
                    chunk_tag(version, i), version, have=i)
                digest = hashlib.sha256(chunk).hexdigest()
                if digest != ann.chunk_shas[i]:
                    raise WeightsError(
                        f"pod {self.pod}: version {version} chunk {i} "
                        f"sha mismatch ({digest[:12]} != "
                        f"{ann.chunk_shas[i][:12]}) — version refused")
                # relay chunk i onward before receiving chunk i+1: the
                # subtree streams while this pod is still downloading
                for c in children:
                    _send(self._child(c), chunk_tag(version, i), chunk)
                    weights_metrics.on_relayed(self.job, self.pod,
                                               len(chunk))
                parts.append(chunk)
            man_bytes = self._recv_or_reparent(
                manifest_tag(version), version, have=ann.n_chunks)
            man_version, man_chunks, man_sha, man_total = \
                decode_manifest(man_bytes)
            payload = b"".join(parts)
            assembled_sha = hashlib.sha256(payload).hexdigest()
            if ((man_version, man_chunks, man_total)
                    != (version, ann.n_chunks, len(payload))
                    or man_sha != assembled_sha
                    or man_sha != ann.payload_sha):
                raise WeightsError(
                    f"pod {self.pod}: version {version} manifest does "
                    f"not match the assembled payload — version refused")
            # manifest forwards LAST, and only after THIS pod verified
            # the assembled payload — a child never sees a commit point
            # its parent could not prove
            for c in children:
                _send(self._child(c), manifest_tag(version), man_bytes)
            self.version = version
            self.on_deliver(payload, version, ann.step)
            weights_metrics.on_committed(self.job, self.pod, version)
            _send(self.control, commit_tag(version, self.pod), b"1")
        return version

    def run(self, stop, poll_timeout: float = 0.2) -> None:
        """Pump loop for a sidecar thread: adopt versions until `stop`
        (a threading.Event) is set. Errors propagate — a relay that
        cannot verify must die loudly, not idle silently."""
        while not stop.is_set():
            self.poll(timeout=poll_timeout)
