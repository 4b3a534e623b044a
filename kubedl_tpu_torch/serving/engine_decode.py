"""DecodeEngine -- tick-only decode over the paged KV pool (the port's copy
of kubedl_tpu/serving/engine_decode.py).

The tick gathers each slot's logical KV view through its row map (block
table flattened to per-position physical rows), runs the same
`decode.decode_step` as the contiguous engine -- identical shapes
([slots, kv_heads, max_len, head_dim], made contiguous), identical masks,
so identical tokens -- and copies the one newly written row per slot back
into the pool. The gather is a copy: `decode_step` writes the new row into
that copy, so the row is read back from the returned cache at each slot's
length and written into the pool; the pool is never assumed to alias the
view. Admission is a scatter of prefilled rows into freshly allocated
blocks; a shared prefix is admitted by REFERENCE (the matched blocks join
the slot's table with a refcount bump, zero bytes moved).

Unlike the contiguous engine, a slot's rows change hands when a request
finishes, so frozen slots must never write where they used to: freed
slots' row maps point at the reserved trash block, and the tick routes
every inactive slot's stale write there too.

Capacity is managed ahead of the tick: `ensure_capacity(k)` allocates
the blocks the next k ticks will write (releasing least-recently-used
shared prefixes under pressure) and raises `PoolExhausted` when the
pool genuinely cannot cover them -- the caller then evicts a stream (its
request re-prefills later; greedy outputs are unchanged by
construction) instead of silently corrupting a neighbour's blocks.

Sampling draws come from the generator a caller passes to `tick` /
`tick_block` (the facade's, so its draws line up with the monolithic
engine's), else from the engine's own, seeded with `seed`.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kubedl_tpu_torch.models import decode
from kubedl_tpu_torch.models.llama import LlamaConfig
from kubedl_tpu_torch.models.serving import (
    Request,
    chosen_logprob,
    emit_token,
    sample_tokens,
)
from kubedl_tpu_torch.serving.engine_prefill import sample_mode
from kubedl_tpu_torch.serving.handoff import HandoffItem
from kubedl_tpu_torch.serving.kv_pool import (
    BlockPool,
    PoolExhausted,
    PrefixIndex,
    init_device_pool,
    table_to_rows,
)


class DecodeEngine:
    """Paged continuous-batching decode for one model on one device."""

    def __init__(
        self,
        params: Dict,
        config: LlamaConfig,
        slots: int = 8,
        max_len: int = 1024,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        max_top_k: int = 64,
        share_prefixes: bool = True,
    ) -> None:
        if max_len % block_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of block_size "
                f"{block_size} (the row map flattens whole blocks)")
        self.params = params
        self.config = config
        self.device = dev = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = max_len // block_size
        if num_blocks is None:
            # EQUAL MEMORY to the contiguous [slots, max_len] cache, plus
            # the trash block -- the capacity win comes from mixed-length
            # traffic not hoarding max_len rows per slot, not from more
            # memory
            num_blocks = slots * self.blocks_per_slot + 1
        self.pool = BlockPool(num_blocks, block_size)
        self.prefix_index = PrefixIndex(self.pool) if share_prefixes else None
        self.pages = init_device_pool(config, num_blocks, block_size, device=dev)
        self.temperature = temperature
        self.max_top_k = max_top_k
        self.generator = torch.Generator(device=dev).manual_seed(seed)

        self.row_map = torch.zeros((slots, max_len), dtype=torch.long, device=dev)
        self.lengths = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.cur_tokens = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self.samp_temps = torch.full((slots,), float(temperature),
                                     dtype=torch.float32, device=dev)
        self.samp_topk = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.samp_topp = torch.ones((slots,), dtype=torch.float32, device=dev)
        self._slot_ids = torch.arange(slots, device=dev)
        self._tables: List[List[int]] = [[] for _ in range(slots)]
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._slot_seq = [0] * slots  # admission order (eviction picks max)
        self._admit_seq = 0
        self._ticks = 0
        self._tokens_out = 0
        self._admitted = 0
        self._evictions = 0
        self._decode_time = 0.0
        self._t0 = time.monotonic()

    # -- device pieces -----------------------------------------------------

    def _views(self):
        """Per-layer logical KV views gathered through the row map:
        [slots, max_len, h, d] -> [slots, h, max_len, d], contiguous -- the
        exact layout the contiguous cache feeds `decode.decode_step`, so
        the attention math (and therefore every token) is identical.
        Positions past a slot's length gather trash/stale rows the ragged
        attend mask already excludes. Each view is a copy of its rows."""
        rm = self.row_map
        ks = [p[rm].permute(0, 2, 1, 3).contiguous() for p in self.pages["k"]]
        vs = [p[rm].permute(0, 2, 1, 3).contiguous() for p in self.pages["v"]]
        return ks, vs

    def _tick_core(self, generator, mode: str):
        """One tick over every slot: (next tokens, their logprobs); the
        pool gains each active slot's new row, the lengths advance."""
        lengths = self.lengths
        ks, vs = self._views()
        cache = {"k": ks, "v": vs, "lengths": lengths}
        logits, cache = decode.decode_step(self.params, self.cur_tokens, cache,
                                           self.config, check=False)
        nxt = sample_tokens(logits, generator, self.samp_temps, self.samp_topk,
                            self.samp_topp, mode, self.max_top_k)
        nxt = torch.where(self.active, nxt, torch.zeros_like(nxt))
        lp = chosen_logprob(logits, nxt)
        self.lengths = torch.where(self.active, cache["lengths"], lengths)
        # the step wrote each slot's row into the gathered copy at its
        # length (clamped into the buffer, as decode's write is); copy it
        # to its physical row. Frozen slots land in the trash block: their
        # old rows may already belong to someone else
        at = lengths.long().clamp(max=self.max_len - 1)
        wrow = self.row_map.gather(1, at[:, None])[:, 0]
        wrow = torch.where(self.active, wrow, torch.zeros_like(wrow))
        for name, views in (("k", cache["k"]), ("v", cache["v"])):
            for page, view in zip(self.pages[name], views):
                page[wrow] = view[self._slot_ids, :, at]
        self.cur_tokens = nxt
        return nxt, lp

    def _scatter(self, rows_k, rows_v, wr: torch.Tensor) -> None:
        """Write [t_pad, h, d] prefilled rows at physical rows `wr`
        (pad/invalid entries point at the trash block)."""
        for name, rows in (("k", rows_k), ("v", rows_v)):
            for page, r in zip(self.pages[name], rows):
                page[wr] = torch.as_tensor(r).to(device=self.device, dtype=page.dtype)

    def _copy_block(self, src0: int, dst0: int) -> None:
        """Copy-on-write: duplicate one block's rows (src -> dst)."""
        bs = self.block_size
        for name in ("k", "v"):
            for page in self.pages[name]:
                page[dst0:dst0 + bs] = page[src0:src0 + bs]

    # -- admission ---------------------------------------------------------

    def match_prefix(self, prompt: np.ndarray) -> List[int]:
        """Longest indexed full-block prefix (increfed for the caller);
        empty when sharing is off."""
        if self.prefix_index is None:
            return []
        return self.prefix_index.match(prompt)

    def build_prefix_scratch(self, blocks: List[int]) -> Dict:
        """Uniform batch-1 scratch cache holding the shared prefix rows
        ([max_len], trash-padded past the prefix), for
        `PrefillEngine.prefill_suffix`."""
        bs = self.block_size
        idx = np.zeros((self.max_len,), np.int64)
        for i, b in enumerate(blocks):
            idx[i * bs:(i + 1) * bs] = b * bs + np.arange(bs, dtype=np.int64)
        idx = torch.from_numpy(idx).to(self.device)
        ks = [p[idx].transpose(0, 1)[None].contiguous() for p in self.pages["k"]]
        vs = [p[idx].transpose(0, 1)[None].contiguous() for p in self.pages["v"]]
        return {"k": ks, "v": vs,
                "lengths": torch.tensor(len(blocks) * bs, dtype=torch.int32,
                                        device=self.device)}

    def free_slots(self) -> int:
        return sum(1 for r in self._slot_req if r is None)

    def claim(self, slot: int, req: Request) -> None:
        """Reserve a slot for a request mid-admission (so `.index(None)`
        advances while a wave builds up, mirroring the monolithic pop
        loop)."""
        self._slot_req[slot] = req

    def _set_rows(self, slot: int, table: List[int]) -> np.ndarray:
        rows = table_to_rows(table, self.block_size, self.max_len)
        self.row_map[slot] = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        return rows

    def admit(self, item: HandoffItem, req: Request,
              slot: Optional[int] = None) -> int:
        """Scatter a prefilled request into the paged batch. Allocates
        ceil(total/block_size) blocks minus the shared-prefix blocks the
        item already references; raises PoolExhausted (after dropping
        the prefix references) if they aren't available -- the caller
        requeues the request, nothing is half-admitted."""
        if slot is None:
            slot = self._slot_req.index(None)
        bs = self.block_size
        total = item.total_len
        if total > self.max_len:
            raise ValueError(f"prompt of {total} tokens > max_len {self.max_len}")
        table = list(item.matched_blocks)
        n_blocks = -(-total // bs)
        try:
            fresh = self.pool.alloc(n_blocks - len(table))
        except PoolExhausted:
            if self.prefix_index is not None:
                released = self.prefix_index.release_lru(
                    n_blocks - len(table) - self.pool.blocks_free)
                if released:
                    try:
                        fresh = self.pool.alloc(n_blocks - len(table))
                    except PoolExhausted:
                        if item.matched_blocks:
                            self.pool.free(item.matched_blocks)
                        raise
                else:
                    if item.matched_blocks:
                        self.pool.free(item.matched_blocks)
                    raise
            else:
                raise
        table += fresh
        rows = self._set_rows(slot, table)
        # scatter the prefilled rows (positions [valid_from, total) of
        # the item's [start, start + t_pad) window; everything else --
        # padding, already-resident prefix rows -- goes to trash)
        t_pad = int(item.rows_k[0].shape[0])
        valid_from = int(item.meta.get("valid_from", item.start))
        pos = item.start + np.arange(t_pad)
        keep = (pos >= valid_from) & (pos < total)
        wr = np.where(keep, rows[np.minimum(pos, self.max_len - 1)], 0)
        self._scatter(item.rows_k, item.rows_v,
                      torch.from_numpy(wr.astype(np.int64)).to(self.device))
        self.lengths[slot] = total
        self.cur_tokens[slot] = item.first_token
        self.active[slot] = True
        self.samp_temps[slot] = req.temperature
        self.samp_topk[slot] = req.top_k
        self.samp_topp[slot] = req.top_p
        self._tables[slot] = table
        self._slot_req[slot] = req
        self._admit_seq += 1
        self._slot_seq[slot] = self._admit_seq
        self._admitted += 1
        req.cache_len = total
        if self.prefix_index is not None:
            self.prefix_index.insert(item.prompt, table)
        return slot

    def free_slot(self, slot: int) -> None:
        if self._tables[slot]:
            self.pool.free(self._tables[slot])
            self._tables[slot] = []
        self.row_map[slot] = 0
        self._slot_req[slot] = None
        self.active[slot] = False

    def evict_slot(self, slot: int) -> Request:
        """Free a live stream's blocks under pool pressure; the caller
        re-queues its request with prompt + emitted tokens (greedy
        continuations are exact -- the re-prefill recomputes the same
        KV)."""
        req = self._slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        self.free_slot(slot)
        self._evictions += 1
        return req

    def cancel_slot(self, req: Request) -> bool:
        for slot, r in enumerate(self._slot_req):
            if r is req:
                self.free_slot(slot)
                return True
        return False

    # -- capacity ----------------------------------------------------------

    def ensure_capacity(self, k: int) -> None:
        """Allocate the blocks the next k ticks will write, for every
        active stream; copy-on-write any shared block that would be
        extended in place. Raises PoolExhausted when the pool can't
        cover it (after releasing LRU shared prefixes)."""
        bs = self.block_size
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            table = self._tables[slot]
            need = min(req.cache_len + k, self.max_len)
            nb = -(-need // bs)
            if nb > len(table):
                want = nb - len(table)
                if want > self.pool.blocks_free and self.prefix_index is not None:
                    self.prefix_index.release_lru(
                        want - self.pool.blocks_free)
                fresh = self.pool.alloc(want)  # raises PoolExhausted
                table.extend(fresh)
                self._set_rows(slot, table)
            # COW guard: the block holding the next write must be
            # exclusively ours. The sharing index only indexes FULL
            # prompt blocks and writes land past the prompt, so this
            # almost never copies -- it's the mechanical enforcement of
            # "never write a shared block", not a hot path.
            bi = min(req.cache_len, self.max_len - 1) // bs
            if bi < len(table):
                nb2, copied = self.pool.writable(table[bi])
                if copied:
                    self._copy_block(table[bi] * bs, nb2 * bs)
                    self.pool.free([table[bi]])
                    table[bi] = nb2
                    self._set_rows(slot, table)

    # -- ticking -----------------------------------------------------------

    def decoding(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is not None]

    def sample_mode(self) -> str:
        return sample_mode([r for r in self._slot_req if r is not None])

    def tick(self, generator: Optional[torch.Generator] = None) -> int:
        decoding = self.decoding()
        if not decoding:
            return 0
        self.ensure_capacity(1)
        t0 = time.monotonic()
        nxt, lp = self._tick_core(generator or self.generator, self.sample_mode())
        self._ticks += 1
        emitted, lps = nxt.tolist(), lp.tolist()
        self._decode_time += time.monotonic() - t0
        for slot in decoding:
            req = self._slot_req[slot]
            if req is not None:
                req.cache_len += 1
                self._emit(slot, int(emitted[slot]), float(lps[slot]))
        return len(decoding)

    def tick_block(self, k: int, generator: Optional[torch.Generator] = None) -> int:
        """k ticks chained on the device with ONE host sync, re-gathering
        the (updated) pool each step. Activity and sampling params can't
        change mid-block; overshoot past an EOS is trimmed host-side."""
        decoding = self.decoding()
        if not decoding:
            return 0
        if k <= 1:
            return self.tick(generator)
        self.ensure_capacity(k)
        t0 = time.monotonic()
        gen, mode = generator or self.generator, self.sample_mode()
        toks, lps = [], []
        for _ in range(k):
            nxt, lp = self._tick_core(gen, mode)
            toks.append(nxt)
            lps.append(lp)
        self._ticks += k
        block, block_lp = torch.stack(toks).tolist(), torch.stack(lps).tolist()
        self._decode_time += time.monotonic() - t0
        for i in range(k):
            for slot in decoding:
                req = self._slot_req[slot]
                if req is not None:
                    req.cache_len += 1
                    self._emit(slot, int(block[i][slot]), float(block_lp[i][slot]))
        return len(decoding)

    def _emit(self, slot: int, token: int, logprob: float = 0.0) -> None:
        req = self._slot_req[slot]
        self._tokens_out += 1
        if emit_token(req, token, logprob):
            self.free_slot(slot)

    # -- introspection -----------------------------------------------------

    def blocks_outstanding(self) -> int:
        return self.pool.blocks_in_use

    def stats(self) -> Dict:
        wall = max(time.monotonic() - self._t0, 1e-9)
        busy = sum(1 for r in self._slot_req if r is not None)
        out = {
            "slots": self.slots,
            "slots_busy": busy,
            "admitted": self._admitted,
            "ticks": self._ticks,
            "tokens_out": self._tokens_out,
            "tokens_per_sec": self._tokens_out / wall,
            "decode_time_s": round(self._decode_time, 4),
            "evictions": self._evictions,
            "kv_blocks_in_use": self.pool.blocks_in_use,
            "kv_blocks_total": self.pool.num_blocks,
            **self.pool.stats(),
        }
        if self.prefix_index is not None:
            out.update(self.prefix_index.stats())
        return out
