"""Named-array record codec, the RL plane's wire form (the port's copy of
kubedl_tpu/rl/wire.py, record for record the same bytes).

A trajectory is int32 tokens next to f32 rewards and logprobs; a weight
broadcast is a bf16/f32 parameter tree. Every array's dtype STRING and
shape are recorded in a JSON header and the payload is the concatenation
of the raw bytes:

    b"kdlrl1" | header length (4 bytes, big-endian) | header JSON | payload

Arrays are numpy arrays or torch tensors (on any device). A bf16 tensor is
recorded as dtype "bfloat16" with its raw 2-byte words, which is what the
JAX package writes for an ml_dtypes bfloat16 array, so each package
decodes the other's records; decoding needs no ml_dtypes (bf16 is viewed
back through torch). Order is part of the contract: decode returns the
arrays in header order, which is how the weight receiver unflattens a
parameter tree.
"""
from __future__ import annotations

import json
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_MAGIC = b"kdlrl1"

# the dtype strings of the record (numpy's names) <-> torch dtypes
_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flat_bytes(a) -> Tuple[str, List[int], object, int]:
    """(dtype string, shape, a 1-D uint8 view of the array's bytes, nbytes)."""
    if torch.is_tensor(a):
        t = a.detach()
        if t.dtype not in _NAMES:
            raise ValueError(f"dtype {t.dtype} has no RL record name")
        n = t.numel() * t.element_size()
        return _NAMES[t.dtype], list(t.shape), t.contiguous().reshape(-1).view(torch.uint8), n
    a = np.asarray(a)
    flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return str(a.dtype), list(a.shape), torch.from_numpy(flat), a.nbytes


def encode_arrays(arrays: Sequence[Tuple[str, object]], meta: Optional[Dict] = None
                  ) -> bytearray:
    """One record: JSON header [{name, dtype, shape}...] + scalar meta, then
    the raw payload, built in one buffer (a device tensor is copied once,
    straight into it). Names must be unique and non-empty."""
    if not arrays:
        raise ValueError("empty RL record")
    entries, parts, seen = [], [], set()
    for name, a in arrays:
        if not name or name in seen:
            raise ValueError(f"array name {name!r} empty or duplicate")
        seen.add(name)
        dtype, shape, flat, n = _flat_bytes(a)
        entries.append({"name": name, "dtype": dtype, "shape": shape})
        parts.append((flat, n))
    header = {"arrays": entries}
    if meta:
        header["meta"] = meta
    hbytes = json.dumps(header).encode("utf-8")
    prefix = _MAGIC + len(hbytes).to_bytes(4, "big") + hbytes
    out = bytearray(len(prefix) + sum(n for _, n in parts))
    out[:len(prefix)] = prefix
    off = len(prefix)
    for flat, n in parts:
        if n:
            torch.frombuffer(out, dtype=torch.uint8, count=n, offset=off).copy_(flat)
        off += n
    return out


def decode_arrays(data) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Inverse of encode_arrays: ({name: CPU tensor} in header order, meta).
    The tensors are views of `data` (read-only when `data` is bytes: copy
    before writing). Trailing or missing bytes are refused -- a record is
    whole or it is an error, never a silent truncation."""
    if bytes(data[: len(_MAGIC)]) != _MAGIC:
        raise ValueError("not an RL record (bad magic)")
    off = len(_MAGIC)
    hlen = int.from_bytes(data[off:off + 4], "big")
    off += 4
    header = json.loads(bytes(data[off:off + hlen]).decode("utf-8"))
    off += hlen
    out: Dict[str, torch.Tensor] = {}
    with warnings.catch_warnings():
        # bytes are immutable: the views are read-only, as numpy's are
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        for entry in header["arrays"]:
            if entry["dtype"] not in _DTYPES:
                raise ValueError(f"RL record array {entry['name']!r} has unknown "
                                 f"dtype {entry['dtype']!r}")
            dtype = _DTYPES[entry["dtype"]]
            shape: List[int] = entry["shape"]
            n = int(np.prod(shape)) if shape else 1
            nbytes = n * dtype.itemsize
            if off + nbytes > len(data):
                raise ValueError(
                    f"RL record truncated inside array {entry['name']!r}")
            if nbytes:
                t = torch.frombuffer(data, dtype=torch.uint8, count=nbytes, offset=off)
                out[entry["name"]] = t.view(dtype).reshape(shape)
            else:
                out[entry["name"]] = torch.empty(shape, dtype=dtype)
            off += nbytes
    if off != len(data):
        raise ValueError(
            f"RL record length mismatch: {len(data) - off} trailing bytes")
    return out, header.get("meta") or {}
