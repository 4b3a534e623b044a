"""Token shards for the trainer's --data-path (the port's NumPy copy of
kubedl_tpu/native/loader.py's `write_shard`, `_affine_params` and
`PyTokenLoader`).

Shards are flat little-endian int32 token files. `PyTokenLoader.batch_at`
returns the same windows, bit for bit, as the JAX package's loaders (its
NumPy loader and its native one share this affine-shuffled schedule) for
the same files and seed. The native C++ loader is not ported yet.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def write_shard(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, dtype="<i4").tofile(path)


def _affine_params(seed: int, n_windows: int):
    """seed -> (mul, add) of the window permutation w -> (mul*i + add) % n."""
    mask = (1 << 64) - 1
    a = ((seed * 6364136223846793005 + 1442695040888963407) & mask) | 1
    a %= n_windows
    if a == 0:
        a = 1
    while math.gcd(a, n_windows) != 1:
        nxt = (a + 1) % n_windows
        a = nxt if nxt else 1
    add = ((seed * 2862933555777941757 + 3037000493) & mask) % n_windows
    return a, add


class PyTokenLoader:
    """[batch, seq_len] int32 windows of the shards, in an affine-shuffled
    order fixed by the seed; `batch_at(i)` is random access."""

    def __init__(self, paths: Sequence[str], batch: int, seq_len: int, seed: int = 0):
        self.batch, self.seq = int(batch), int(seq_len)
        self._arrays: List[np.ndarray] = []
        prefix = [0]
        for p in paths:
            arr = np.fromfile(p, dtype="<i4")
            n_win = arr.size // self.seq
            if n_win == 0:
                continue
            self._arrays.append(arr[: n_win * self.seq].reshape(n_win, self.seq))
            prefix.append(prefix[-1] + n_win)
        self.n_windows = prefix[-1]
        if self.n_windows == 0:
            raise ValueError(f"no [{seq_len}]-token windows in shards {list(paths)}")
        self._prefix = np.asarray(prefix[:-1], dtype=np.uint64)
        self.mul, self.add = _affine_params(seed, self.n_windows)

    def _window(self, w: int) -> np.ndarray:
        shard = int(np.searchsorted(self._prefix, w, side="right")) - 1
        return self._arrays[shard][w - int(self._prefix[shard])]

    def batch_at(self, batch_id: int) -> np.ndarray:
        out = np.empty((self.batch, self.seq), np.int32)
        for j in range(self.batch):
            w = (self.mul * ((batch_id * self.batch + j) % self.n_windows)
                 + self.add) % self.n_windows
            out[j] = self._window(w)
        return out
