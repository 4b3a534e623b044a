"""Prefill -> decode KV handoff (the port's copy of
kubedl_tpu/serving/handoff.py).

A finished prefill is (per layer) `total_len` KV rows plus the sampled
first token. In-process (facade mode, or a router whose prefill and
decode pods share the host) the item carries device tensors BY REFERENCE
-- the decode engine scatters them straight into its pool, no host copy.
Across pods the item serializes to one contiguous byte payload (npz) for
the hop; `deserialize_item` restores CPU tensors the receiving engine
uploads. Serialization drops the in-process conveniences (the live
Request object, matched prefix blocks) -- exactly the things that cannot
cross a process boundary.

The npz is byte for byte the JAX package's for the same item (under one
zip timestamp): bf16 rows are written as raw 2-byte words with the
``'<V2'`` descr an ml_dtypes array saves under, and recorded by name in
``rows_dtype``; they are read back through a uint16 view, so neither side
needs ml_dtypes. ``meta`` rides as pickled object arrays.
"""
from __future__ import annotations

import io
import threading
import time
import zipfile
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from numpy.lib import format as npy_format

# npz row dtype names (numpy's spelling) <-> torch dtypes
_ROW_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32}
_ROW_NAMES = {v: k for k, v in _ROW_DTYPES.items()}


@dataclass
class HandoffItem:
    """One prefilled request, ready for decode admission.

    rows_k/rows_v: per-layer [t_rows, kv_heads, head_dim] -- the KV rows
    the prefill computed, row r = prompt position `start + r`. With
    prefix sharing, `start = len(matched_blocks) * block_size` rows were
    NOT computed (the decode pod already holds them); matched_blocks
    carries the physical ids (already increfed for this request)."""

    request: Any  # models.serving.Request (None after a serialized hop)
    prompt: np.ndarray  # full prompt tokens [total prompt len]
    total_len: int  # prompt tokens incl. shared prefix
    start: int  # first row's logical position (0 unless prefix-shared)
    rows_k: List[Any]  # per layer [t_rows, h_kv, d] tensors
    rows_v: List[Any]
    first_token: int
    first_logprob: float
    matched_blocks: List[int] = field(default_factory=list)
    # sampling/meta for cross-pod admission (the Request doesn't travel)
    meta: Dict = field(default_factory=dict)
    prefilled_at: float = field(default_factory=time.monotonic)


class HandoffQueue:
    """Thread-safe FIFO between a prefill pump and a decode pump. The
    queue is the disaggregation point: prefill bursts pile up HERE
    instead of between two decode ticks."""

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self._q: deque = deque()
        self._lock = threading.Lock()
        self.maxlen = maxlen
        self.put_count = 0

    def put(self, item: HandoffItem) -> None:
        with self._lock:
            if self.maxlen is not None and len(self._q) >= self.maxlen:
                raise RuntimeError(
                    f"handoff queue full ({self.maxlen}) — decode pods "
                    f"are not draining; add capacity or admit slower")
            self._q.append(item)
            self.put_count += 1

    def get(self) -> Optional[HandoffItem]:
        with self._lock:
            return self._q.popleft() if self._q else None

    def requeue(self, item: HandoffItem) -> None:
        """Put BACK an item taken with get() (e.g. every decode pod was
        full): head of the queue, no put_count bump, no maxlen check --
        the item was already admitted once."""
        with self._lock:
            self._q.appendleft(item)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


def _host_rows(r):
    """(numpy dtype name, host array to write) for one layer's rows; a bf16
    tensor becomes its raw 2-byte words."""
    if torch.is_tensor(r):
        t = r.detach().contiguous().cpu()
        if t.dtype not in _ROW_NAMES:
            raise ValueError(f"KV rows of dtype {t.dtype} have no wire name")
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        return _ROW_NAMES[t.dtype], t.numpy()
    a = np.asarray(r)
    return str(a.dtype), a


def _write_member(zipf: zipfile.ZipFile, name: str, arr: np.ndarray,
                  descr: Optional[str] = None) -> None:
    """One .npy member, as np.savez writes it. `descr` overrides the dtype
    string of the header (bf16 words are recorded as ml_dtypes saves
    them, '<V2')."""
    with zipf.open(name + ".npy", "w", force_zip64=True) as fid:
        if descr is None:
            npy_format.write_array(fid, arr, allow_pickle=True)
            return
        arr = np.ascontiguousarray(arr)
        npy_format.write_array_header_1_0(
            fid, {"descr": descr, "fortran_order": False, "shape": arr.shape})
        fid.write(arr.tobytes("C"))


def serialize_item(item: HandoffItem) -> bytes:
    """One npz payload for the cross-pod hop. Device tensors are fetched to
    the host here -- the serialization boundary IS the transfer boundary.
    Prefix-shared blocks cannot travel (they are physical ids in the
    SENDER's pool), so items carrying them must re-prefill or stay
    in-process; refusing loudly beats corrupting the receiver."""
    if item.matched_blocks:
        raise ValueError(
            "cannot serialize a handoff item with matched prefix blocks "
            "(physical block ids are meaningless across pods) — route "
            "prefix-shared traffic to a same-pool decode engine")
    arrays: Dict[str, Any] = {
        "prompt": np.asarray(item.prompt, np.int32),
        "scalars": np.asarray(
            [item.total_len, item.start, item.first_token], np.int64),
        "first_logprob": np.asarray([item.first_logprob], np.float64),
    }
    row_dtypes = set()
    for li, (k, v) in enumerate(zip(item.rows_k, item.rows_v)):
        for name, r in ((f"k{li}", k), (f"v{li}", v)):
            dname, host = _host_rows(r)
            row_dtypes.add(dname)
            arrays[name] = (dname, host)
    # ONE name covers every layer, so mixed-dtype rows must not slip in
    # (they'd deserialize through the wrong view, silent corruption)
    if len(row_dtypes) != 1:
        raise ValueError(f"mixed KV row dtypes {sorted(row_dtypes)} — "
                         f"the wire format records one dtype for all layers")
    arrays["rows_dtype"] = np.asarray(sorted(row_dtypes))
    meta_keys = sorted(item.meta)
    arrays["meta_keys"] = np.asarray(meta_keys, dtype=object)
    arrays["meta_vals"] = np.asarray(
        [item.meta[k] for k in meta_keys], dtype=object)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zipf:
        for name, val in arrays.items():
            if isinstance(val, tuple):
                dname, host = val
                _write_member(zipf, name, host,
                              "<V2" if dname == "bfloat16" else None)
            else:
                _write_member(zipf, name, val)
    return buf.getvalue()


def deserialize_item(payload: bytes) -> HandoffItem:
    """Inverse of `serialize_item` (and of the JAX package's): rows come
    back as CPU tensors in their recorded dtype."""
    with np.load(io.BytesIO(payload), allow_pickle=True) as z:
        n_layers = sum(1 for name in z.files
                       if name.startswith("k") and name[1:].isdigit())
        total_len, start, first_token = (int(x) for x in z["scalars"])
        meta = dict(zip(z["meta_keys"].tolist(), z["meta_vals"].tolist()))
        rd = str(z["rows_dtype"][0]) if "rows_dtype" in z.files \
            else str(z["k0"].dtype)

        def rows(name):
            a = z[name]
            if a.dtype.kind == "V":
                # extension dtypes come back as raw void words: view the
                # recorded dtype on them through torch
                if rd not in _ROW_DTYPES or a.dtype.itemsize != 2:
                    raise ValueError(f"KV rows recorded as {rd!r} ({a.dtype})")
                return torch.from_numpy(a.view(np.int16).copy()).view(_ROW_DTYPES[rd])
            return torch.from_numpy(np.ascontiguousarray(a))

        return HandoffItem(
            request=None,
            prompt=z["prompt"],
            total_len=total_len,
            start=start,
            rows_k=[rows(f"k{li}") for li in range(n_layers)],
            rows_v=[rows(f"v{li}") for li in range(n_layers)],
            first_token=first_token,
            first_logprob=float(z["first_logprob"][0]),
            meta=meta,
        )
