"""Paged KV cache: block-pool allocator + prefix sharing + device pool (the
port's copy of kubedl_tpu/serving/kv_pool.py).

The contiguous engine reserves max_len KV positions per slot up front,
so concurrency is capped by the WORST-case request even when traffic is
mostly short. Paged KV carves the same memory into fixed-size blocks
handed out on demand:

  * `BlockPool` -- the host-side truth: a free list plus per-block
    refcounts. Requests hold blocks through per-request block TABLES
    (logical block i -> physical block id); a block is returned to the
    free list when its last reference drops.
  * `PrefixIndex` -- copy-on-write prefix sharing: every FULL block of a
    prompt is indexed by the hash of the prompt up to and including that
    block. A later prompt with the same prefix re-REFERENCES those
    blocks (one incref per block, zero prefill compute for the shared
    tokens); nobody ever writes a shared block in place -- writes land in
    fresh tail blocks, and `BlockPool.writable` copies on demand if a
    shared block must ever be extended.
  * device pool -- per layer, one [rows, kv_heads, head_dim] tensor where
    row r = block (r // block_size), offset (r % block_size). The decode
    tick gathers a slot's logical view through its row map and copies the
    one written row back (serving/engine_decode.py).

The allocator is numpy and stdlib only: its block ids, refcounts and
`stats()` equal the JAX package's for the same sequence of operations.

Block 0 is reserved as the TRASH block: frozen slots' stale writes and
row-map padding point at it, so a freed block can be re-allocated to a
new request without a stale write from the old slot corrupting it.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """Not enough free KV blocks — caller must evict, release shared
    prefixes, or defer admission."""


class BlockPool:
    """Refcounted fixed-size KV block allocator (host-side accounting).

    Invariants (tests/test_torch_kv_pool.py):
      * free + in_use == num_blocks, always;
      * a block is on the free list iff its refcount is 0;
      * free() below refcount 0 raises (double-free is a bug, not a
        no-op — silent double-frees become cross-request KV corruption
        when the block is handed out twice).
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the reserved trash block), "
                f"got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._ref = [0] * num_blocks
        # LIFO free list: recently-freed blocks are re-used first (their
        # rows are most likely still warm in whatever cache hierarchy)
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref[0] = 1  # block 0: the trash block, pinned forever
        self.alloc_count = 0
        self.cow_copies = 0

    # -- allocation --------------------------------------------------------

    @property
    def trash_block(self) -> int:
        return 0

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """n fresh blocks (refcount 1 each) — all or nothing."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} KV blocks, {len(self._free)} free "
                f"(of {self.num_blocks})")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        self.alloc_count += n
        return out

    def incref(self, blocks: List[int]) -> None:
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"incref on free block {b}")
            self._ref[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; blocks reaching 0 return to the
        free list."""
        for b in blocks:
            if b == 0:
                raise ValueError("freeing the trash block")
            if self._ref[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def writable(self, block: int) -> Tuple[int, bool]:
        """Copy-on-write entry point: a block about to be WRITTEN.

        Exclusive blocks (refcount 1) are returned as-is. Shared blocks
        get a fresh copy target: (new_block, True) — the caller drops
        one reference on the original and copies the device rows. The
        sharing index never hands out partially-filled blocks, so this
        fires only if a caller extends a block it shares — the mechanism
        is here so that invariant is enforced mechanically, not by
        convention."""
        if self._ref[block] <= 0:
            raise ValueError(f"writable() on free block {block}")
        if self._ref[block] == 1 and block != 0:
            return block, False
        new = self.alloc(1)[0]
        self.cow_copies += 1
        return new, True

    def stats(self) -> Dict:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_free": self.blocks_free,
            "blocks_in_use": self.blocks_in_use,
            "alloc_count": self.alloc_count,
            "cow_copies": self.cow_copies,
        }


def _prefix_key(tokens: np.ndarray) -> bytes:
    # content hash, not Python hash(): stable across processes so a
    # router can compare hit-rates between pods
    return hashlib.sha1(np.ascontiguousarray(tokens, np.int32).tobytes()).digest()


class PrefixIndex:
    """Prompt-prefix hash -> physical block, one entry per FULL block.

    Entry i for a prompt maps sha1(prompt[: (i+1)*block_size]) to the
    physical block holding those block_size KV rows. The index holds ONE
    reference on every indexed block (so shared prefixes outlive the
    request that computed them); `match` walks the chain block by block
    and increfs each hit for the caller. Matching is capped at
    floor((len-1)/block_size) blocks so at least one prompt token is
    always left for the prefill to compute — the first generated token
    needs the last prompt position's logits.

    Eviction is LRU over entries; a mid-chain eviction just shortens
    future matches (match stops at the first miss), it can never corrupt
    one."""

    def __init__(self, pool: BlockPool) -> None:
        self.pool = pool
        # key -> [block_id, last_hit_clock]
        self._entries: Dict[bytes, list] = {}
        self._clock = 0
        self.hit_tokens = 0
        self.miss_tokens = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, tokens: np.ndarray) -> List[int]:
        """Longest indexed full-block prefix of `tokens`; increfs every
        matched block for the caller (caller frees them with the rest of
        its table). Never matches the whole prompt (see class doc)."""
        bs = self.pool.block_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        limit = (len(tokens) - 1) // bs  # leave >= 1 token to prefill
        self._clock += 1
        blocks: List[int] = []
        for i in range(limit):
            ent = self._entries.get(_prefix_key(tokens[: (i + 1) * bs]))
            if ent is None:
                break
            ent[1] = self._clock
            blocks.append(ent[0])
        if blocks:
            self.pool.incref(blocks)
        self.hit_tokens += len(blocks) * bs
        self.miss_tokens += len(tokens) - len(blocks) * bs
        return blocks

    def insert(self, tokens: np.ndarray, table: List[int]) -> int:
        """Index every full block of `tokens` (physical ids from the
        request's `table`); newly-indexed blocks gain the index's
        reference. Returns how many entries were added."""
        bs = self.pool.block_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_full = min(len(tokens) // bs, len(table))
        added = 0
        self._clock += 1
        for i in range(n_full):
            key = _prefix_key(tokens[: (i + 1) * bs])
            if key in self._entries:
                continue
            self.pool.incref([table[i]])
            self._entries[key] = [table[i], self._clock]
            added += 1
        return added

    def release_lru(self, n_blocks: int) -> int:
        """Drop least-recently-hit entries until `n_blocks` blocks have
        actually returned to the free list — called under pool pressure
        so cached prefixes never starve live traffic. Entries whose
        block a live table still references are SKIPPED: the index holds
        one of several refs there, so dropping them frees nothing now
        and forfeits future hits for no capacity. Returns blocks
        actually released (callers retry alloc only when > 0)."""
        victims = sorted(self._entries.items(), key=lambda kv: kv[1][1])
        released = 0
        for key, (block, _) in victims:
            if released >= n_blocks:
                break
            if self.pool.refcount(block) > 1:
                continue  # shared with a live table; freeing yields nothing
            del self._entries[key]
            self.pool.free([block])
            released += 1
        return released

    def hit_rate(self) -> float:
        total = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / total if total else 0.0

    def stats(self) -> Dict:
        return {
            "prefix_entries": len(self._entries),
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_hit_rate": round(self.hit_rate(), 4),
        }


# -- device-side pool -------------------------------------------------------


def init_device_pool(config, num_blocks: int, block_size: int,
                     device="cuda") -> Dict:
    """Per-layer paged KV rows: [num_blocks * block_size, kv_heads,
    head_dim] zeros in the model dtype on `device`. Row-major by (block,
    offset) so a block's rows are contiguous -- the cross-pod handoff
    serializes and scatters whole blocks as flat row ranges."""
    import torch

    from kubedl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rows = num_blocks * block_size
    shape = (rows, config.n_kv_heads, config.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=config.dtype, device=dev)
              for _ in range(config.n_layers)],
        "v": [torch.zeros(shape, dtype=config.dtype, device=dev)
              for _ in range(config.n_layers)],
    }


def table_to_rows(table: List[int], block_size: int, max_len: int,
                  trash_row: int = 0) -> np.ndarray:
    """[max_len] int32 physical row per logical position; positions past
    the table point at the trash row (masked by lengths, overwritten on
    growth)."""
    rows = np.full((max_len,), trash_row, np.int32)
    for i, b in enumerate(table):
        lo = i * block_size
        hi = min(lo + block_size, max_len)
        if lo >= max_len:
            break
        rows[lo:hi] = b * block_size + np.arange(hi - lo, dtype=np.int32)
    return rows
