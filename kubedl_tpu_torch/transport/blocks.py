"""Staged-reshard block movement over the plane (the port's copy of
kubedl_tpu/transport/blocks.py; the same channels and bytes).

The staged-restart lane (train/reshard_runtime.py) stages src-<pod>.npz
shard blocks + digest markers in a SHARED directory — the checkpoint
volume. On a cluster without one, a restarting pod can instead FETCH the
peer staging files over the transport plane into a local dir and then
run the unchanged ``restore_staged`` validation against it: the digest
checks, exactly-once assembly, and the closed fallback to checkpoint
restore are all untouched — only the byte movement changes.

``serve_staging`` runs on the pod (or sidecar) that still holds the
staging dir; ``fetch_staging`` pulls ``manifest.json`` first (to learn
``old_pods``), then every marker + npz, verifying a per-file sha256
carried in the reply header before the atomic local write — a corrupt
or truncated transfer is refused, never handed to ``restore_staged``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import uuid
from typing import Dict, Optional, Sequence

from kubedl_tpu_torch.transport.plane import TransportError, TransportPlane

log = logging.getLogger("kubedl_tpu_torch.transport")

FETCH_CHANNEL = "reshard-fetch"
DATA_CHANNEL = "reshard-data"

# only staging artifacts are servable — the fetch protocol must not be
# a read-anything file server on the pod
_SERVABLE = re.compile(r"^(manifest\.json|src-\d+\.(npz|json))$")


def serve_staging(plane: TransportPlane, reshard_dir: str) -> None:
    """Serve this pod's staging dir on the plane: each request names one
    staging file; the reply carries its bytes + sha256 (or found=False)."""

    def on_request(tag: str, data: bytes) -> None:
        try:
            req = json.loads(data.decode("utf-8"))
            name = str(req["name"])
            reply_addr = str(req["reply_addr"])
        except (ValueError, KeyError):
            return  # malformed request: nothing to reply to
        header: Dict = {"name": name, "found": False}
        blob = b""
        if _SERVABLE.match(name):
            try:
                with open(os.path.join(reshard_dir, name), "rb") as f:
                    blob = f.read()
                header["found"] = True
                header["sha256"] = hashlib.sha256(blob).hexdigest()
            except OSError:
                pass  # found stays False
        hbytes = json.dumps(header).encode("utf-8")
        payload = len(hbytes).to_bytes(4, "big") + hbytes + blob
        try:
            plane.send(reply_addr, DATA_CHANNEL, tag, payload)
        except (TransportError, TimeoutError) as e:
            log.warning("staging serve of %s failed: %s", name, e)

    plane.subscribe(FETCH_CHANNEL, on_request)


def _fetch_one(plane: TransportPlane, peer_addr: str, name: str,
               timeout: float) -> Optional[bytes]:
    tag = f"{name}-{uuid.uuid4().hex[:8]}"
    plane.send(peer_addr, FETCH_CHANNEL, tag, json.dumps(
        {"name": name, "reply_addr": plane.bound_addr}).encode("utf-8"))
    payload = plane.recv(DATA_CHANNEL, tag, timeout=timeout)
    hlen = int.from_bytes(payload[:4], "big")
    header = json.loads(payload[4:4 + hlen].decode("utf-8"))
    blob = payload[4 + hlen:]
    if not header.get("found"):
        return None
    digest = hashlib.sha256(blob).hexdigest()
    if digest != header.get("sha256"):
        raise TransportError(
            f"staging file {name} arrived corrupt "
            f"(sha256 {digest[:12]} != advertised "
            f"{str(header.get('sha256'))[:12]})")
    return blob


def fetch_staging(
    plane: TransportPlane,
    peer_addr: str,
    reshard_dir: str,
    timeout: float = 30.0,
    peers: Optional[Sequence[str]] = None,
) -> int:
    """Pull a peer's published staging into the LOCAL `reshard_dir`;
    returns the number of files fetched. Raises TransportError (or
    TimeoutError) on any gap — the caller's ladder then falls back
    closed to checkpoint restore, exactly as a missing shared-volume
    staging would. The fetched dir goes through the SAME
    ``restore_staged`` digest/coverage validation as a local one.

    `peers` (optional) are EXTRA addresses that may also hold the same
    verified staging (a weight-tree fan-out leaves every committed relay
    with the full set, docs/weights.md): src files round-robin across
    the swarm, falling back to `peer_addr` when a swarm member lacks a
    file. The per-file sha256 check makes the source interchangeable —
    a peer can serve wrong bytes but never get them adopted. The
    manifest is always taken from `peer_addr` and written LAST."""
    manifest = _fetch_one(plane, peer_addr, "manifest.json", timeout)
    if manifest is None:
        raise TransportError(
            f"peer {peer_addr} has no published staging manifest")
    try:
        old_pods = int(json.loads(manifest.decode("utf-8"))["old_pods"])
    except (ValueError, KeyError) as e:
        raise TransportError(f"peer staging manifest unreadable: {e}") from e
    os.makedirs(reshard_dir, exist_ok=True)
    swarm = [peer_addr] + [p for p in (peers or ()) if p != peer_addr]
    # stream each file to disk as it arrives — buffering every pod's npz
    # would hold the whole staged model state in host RAM at once, on a
    # pod that is mid-restart. Only the manifest must wait until LAST:
    # its presence promises the staging is complete (the same
    # marker-then-manifest ordering the staging writer uses), so a fetch
    # that dies partway leaves a manifest-less dir restore_staged treats
    # as still-in-flight, never as committed.
    n = 1
    i = 0
    for pod in range(old_pods):
        for name in (f"src-{pod}.json", f"src-{pod}.npz"):
            src = swarm[i % len(swarm)]
            i += 1
            blob = _fetch_one(plane, src, name, timeout)
            if blob is None and src != peer_addr:
                # swarm member doesn't hold it (or dropped its staging)
                # — the publishing peer is the authority of last resort
                blob = _fetch_one(plane, peer_addr, name, timeout)
            if blob is None:
                raise TransportError(
                    f"peer {peer_addr} staging is missing {name}")
            _atomic_write(os.path.join(reshard_dir, name), blob)
            n += 1
    _atomic_write(os.path.join(reshard_dir, "manifest.json"), manifest)
    return n


def _atomic_write(path: str, blob: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
