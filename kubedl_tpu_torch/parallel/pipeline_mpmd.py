"""MPMD pipeline plumbing -- stage plans, the serialized boundary, and the
transports that join stage programs (the port of
kubedl_tpu/parallel/pipeline_mpmd.py).

The single-program pipeline (parallel/pipeline.py) is SPMD: one program on
every rank of a mesh, activations moved by `ppermute`. The MPMD plane
breaks that coupling: each pipeline stage is its OWN program (its own
process, on its own devices), holding only its layer chunk and optimizer
state, joined to its neighbors by async sends of activations (forward) and
activation-gradients (backward). This module is the program-independent
half:

  * StagePlan / split_stage_params -- which layers (and which of the
    embed / LM-head endcaps) each stage program owns;
  * encode_boundary / decode_boundary -- the wire form of one boundary
    message, byte for byte the JAX package's:

        b"kdlpp1" | header length (4 bytes, big-endian) | header JSON | payload

    The header records the dtype STRING and the shapes (and the optional
    scalar meta); the payload is the arrays' raw bytes. One message, one
    dtype: mixed-dtype batches are refused. bf16 crosses as the dtype
    "bfloat16" with its raw 2-byte words, as rl/wire.py carries it, so
    decoding needs no ml_dtypes;
  * the channels, tag -> bytes, each message delivered exactly once:
    QueueChannel (in-process; both endpoints hold the same object, and a
    tag still queued is refused a second time) and DirChannel (one file a
    message under a shared directory, written to a temporary name and
    renamed into place, so a reader never sees a partial message; it works
    across processes, the local executor's stand-in for a network link;
    `purge()` drops what a crashed earlier incarnation left behind). The
    socket plane's SocketChannel (transport/plane.py) is the third;
  * AsyncSender / Prefetcher -- double-buffered transfers, so a stage
    computes microbatch i while its send of i-1 and its receive of i+1 are
    in flight.

The schedule that drives these lives in train/pipeline_runtime.py.
"""
from __future__ import annotations

import json
import os
import queue
import re
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.api.validation import validate_pipeline_shapes

# ---------------------------------------------------------------------------
# stage plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StagePlan:
    """How one model splits into stage programs: contiguous equal layer
    chunks, embed on stage 0, final norm + LM head on the last stage."""

    n_layers: int
    n_stages: int
    n_microbatches: int

    @property
    def layers_per_stage(self) -> int:
        return self.n_layers // self.n_stages

    def layer_range(self, stage: int) -> Tuple[int, int]:
        if not (0 <= stage < self.n_stages):
            raise ValueError(f"stage {stage} out of range [0, {self.n_stages})")
        per = self.layers_per_stage
        return stage * per, (stage + 1) * per


def make_stage_plan(n_layers: int, n_stages: int, n_microbatches: int) -> StagePlan:
    """Validated plan (the shared shape rules, api/validation.py). The MPMD
    runtime runs plain 1F1B (interleave 1); interleaving virtual stages is
    the single-program schedule's job (pipeline_apply_1f1b)."""
    errs = validate_pipeline_shapes(
        n_stages, n_microbatches, 1, n_layers=n_layers, path="pipeline_mpmd")
    if errs:
        raise ValueError("; ".join(errs))
    return StagePlan(n_layers=n_layers, n_stages=n_stages, n_microbatches=n_microbatches)


TIED_REFUSED = ("tie_embeddings is unsupported in the MPMD pipeline (the "
                "tied LM head lives on stage 0, the final norm on the "
                "last stage); use a separate lm_head")


def split_stage_params(params: Dict, plan: StagePlan, stage: int) -> Dict:
    """Stage-local parameter subtree: this stage's layer list, plus the
    embed table (stage 0) and the final norm + LM head (last stage). Works
    on the parameter tree AND on a matching PartitionSpec tree (it only
    slices the layer list and copies the endcap leaves)."""
    lo, hi = plan.layer_range(stage)
    out: Dict[str, Any] = {"layers": list(params["layers"][lo:hi])}
    if stage == 0:
        out["embed"] = params["embed"]
    if stage == plan.n_stages - 1:
        out["final_norm"] = params["final_norm"]
        if "lm_head" not in params:
            # tied embeddings put the head's weights on stage 0 -- a
            # cross-stage parameter the MPMD split cannot represent
            raise ValueError(TIED_REFUSED)
        out["lm_head"] = params["lm_head"]
    return out


# ---------------------------------------------------------------------------
# the serialized boundary
# ---------------------------------------------------------------------------

_MAGIC = b"kdlpp1"

# the dtype strings of the wire (numpy's names) <-> torch dtypes
_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _wire_form(a) -> Tuple[str, List[int], torch.Tensor]:
    """(dtype string, shape, a 1-D uint8 CPU tensor of the raw bytes). A
    device tensor is copied to the host here, after the work that writes it
    (the copy waits for the stream), so no other thread ever reads device
    memory still being written."""
    if torch.is_tensor(a):
        t = a.detach()
        if t.dtype not in _NAMES:
            raise ValueError(f"dtype {t.dtype} has no boundary name")
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        return _NAMES[t.dtype], list(t.shape), flat.cpu()
    a = np.asarray(a)
    flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return str(a.dtype), list(a.shape), torch.from_numpy(flat)


def encode_boundary(arrays: Sequence, meta: Optional[Dict] = None) -> bytes:
    """One boundary message: JSON header (dtype string, shapes, optional
    scalar meta) + raw payload. `arrays` are torch tensors (on any device)
    or numpy arrays, all of ONE dtype -- mixed-dtype batches are refused
    rather than silently upcast (the decoder views one flat buffer back
    through one recorded dtype)."""
    forms = [_wire_form(a) for a in arrays]
    if not forms:
        raise ValueError("empty boundary message")
    dtypes = {d for d, _, _ in forms}
    if len(dtypes) != 1:
        raise ValueError(
            f"mixed-dtype boundary refused: {sorted(dtypes)} — the raw "
            f"uint8 payload records ONE dtype; send separate messages")
    header = {"dtype": dtypes.pop(), "shapes": [s for _, s, _ in forms]}
    if meta:
        header["meta"] = meta
    hbytes = json.dumps(header).encode("utf-8")
    prefix = _MAGIC + len(hbytes).to_bytes(4, "big") + hbytes
    out = bytearray(len(prefix) + sum(int(f.numel()) for _, _, f in forms))
    out[:len(prefix)] = prefix
    off = len(prefix)
    for _, _, flat in forms:
        n = int(flat.numel())
        if n:
            torch.frombuffer(out, dtype=torch.uint8, count=n, offset=off).copy_(flat)
        off += n
    return bytes(out)


def decode_boundary(data) -> Tuple[List[torch.Tensor], Dict]:
    """Inverse of encode_boundary: (CPU tensors, meta). The tensors are
    views of `data` (read-only when `data` is bytes: copy before writing);
    `.numpy()` gives numpy arrays, but for bf16, which numpy has no dtype
    for. A message whose payload does not match its header is refused."""
    if bytes(data[: len(_MAGIC)]) != _MAGIC:
        raise ValueError("not a pipeline boundary message (bad magic)")
    off = len(_MAGIC)
    hlen = int.from_bytes(data[off:off + 4], "big")
    off += 4
    header = json.loads(bytes(data[off:off + hlen]).decode("utf-8"))
    off += hlen
    if header["dtype"] not in _DTYPES:
        raise ValueError(f"boundary message has unknown dtype {header['dtype']!r}")
    dtype = _DTYPES[header["dtype"]]
    arrays = []
    with warnings.catch_warnings():
        # bytes are immutable: the views are read-only, as numpy's are
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        for shape in header["shapes"]:
            n = int(np.prod(shape)) if shape else 1
            nbytes = n * dtype.itemsize
            if off + nbytes > len(data):
                raise ValueError(
                    f"boundary payload length mismatch: {len(data) - off} bytes "
                    f"left for a {nbytes}-byte array (truncated or corrupt message)")
            if nbytes:
                t = torch.frombuffer(data, dtype=torch.uint8, count=nbytes, offset=off)
                arrays.append(t.view(dtype).reshape(shape))
            else:
                arrays.append(torch.empty(shape, dtype=dtype))
            off += nbytes
    if off != len(data):
        raise ValueError(
            f"boundary payload length mismatch: {len(data) - off} trailing "
            f"bytes (truncated or corrupt message)")
    return arrays, header.get("meta") or {}


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------


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

    def purge(self, older_than: Optional[float] = None) -> int:
        """Delete every pending message -- a RESTARTING receiver calls this
        on the dirs it receives on, so messages a crashed previous
        incarnation left behind cannot be consumed as current data (tags
        restart from 1 after a restart). With `older_than` (a time.time()
        value, e.g. the process's start) only messages written before it go,
        so a peer of this incarnation that sent first keeps its message.
        Returns the count."""
        n = 0
        try:
            names = os.listdir(self.path)
        except OSError:
            return 0
        for name in names:
            if name.endswith(".msg"):
                path = os.path.join(self.path, name)
                try:
                    if older_than is not None and os.stat(path).st_mtime >= older_than:
                        continue
                    os.unlink(path)
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


class AsyncSender:
    """Double-buffered async send: `send` enqueues and returns, a worker
    thread drains -- compute of microbatch i overlaps the transfer of i-1.
    `depth` bounds the messages in flight (2 = the classic double buffer);
    a full queue applies backpressure instead of unbounded host memory.
    Transport errors surface on the NEXT send/flush, never vanish.
    `sent_bytes` counts the bytes queued, `send_s` the seconds the worker
    spent in the channel's send."""

    def __init__(self, channel, depth: int = 2) -> None:
        self._channel = channel
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.sent_bytes = 0
        self.send_s = 0.0
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                tag, data = item
                t0 = time.perf_counter()
                try:
                    self._channel.send(tag, data)
                except BaseException as e:  # noqa: BLE001 -- reraised on send/flush
                    self._err = e
                self.send_s += time.perf_counter() - t0
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(f"async boundary send failed: {err}") from err

    def send(self, tag: str, data: bytes) -> None:
        self._check()
        self.sent_bytes += len(data)
        self._q.put((tag, data))

    def flush(self) -> None:
        self._q.join()
        self._check()

    def close(self) -> None:
        self.flush()
        self._q.put(None)
        self._thread.join(timeout=5)
        self._check()


class Prefetcher:
    """Double-buffered async receive: given the (deterministic) tag order a
    stage will consume, a worker thread keeps up to `depth` messages
    fetched ahead -- the receive of microbatch i+1 is in flight while i
    computes. `get(tag)` must be called in the expected order."""

    def __init__(self, channel, depth: int = 2, timeout: float = 60.0) -> None:
        self._channel = channel
        self._timeout = timeout
        self._pending: "queue.Queue" = queue.Queue()
        self._ready: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.recv_bytes = 0

    def _run(self) -> None:
        while True:
            tag = self._pending.get()
            if tag is None:
                return
            try:
                data = self._channel.recv(tag, timeout=self._timeout)
                self._ready.put((tag, data, None))
            except BaseException as e:  # noqa: BLE001 -- delivered via get()
                self._ready.put((tag, None, e))
                return

    def expect(self, tags: Sequence[str]) -> None:
        for tag in tags:
            self._pending.put(tag)

    def get(self, tag: str) -> bytes:
        got_tag, data, err = self._ready.get(timeout=self._timeout + 5)
        if err is not None:
            raise RuntimeError(f"async boundary recv failed: {err}") from err
        if got_tag != tag:
            raise RuntimeError(
                f"boundary recv out of order: expected {tag!r}, got "
                f"{got_tag!r} (Prefetcher.get must follow expect order)")
        self.recv_bytes += len(data)
        return data

    def close(self) -> None:
        self._pending.put(None)
        self._thread.join(timeout=5)
