"""DisaggregatedEngine -- the monolithic `ServingEngine` API over the split
prefill/decode stack, with exact-token parity (the port's copy of
kubedl_tpu/serving/disaggregated.py).

This is the compatibility facade: `submit`/`step`/`step_block`/
`serve_all`/`cancel`/`stats`/`has_pending` behave like the port's
`models.serving.ServingEngine` and -- for the same traffic, seed and slot
count -- produce the SAME tokens, greedy and sampled:

  * admission pops, slot assignment, bucket clustering and batch
    padding replicate the monolithic `_admit`/`_admit_batch`;
  * the generator discipline is identical: one torch.Generator seeded
    with `seed`, one sample draw per prefill cluster and one per tick,
    the same sample shapes, the shared `sample_tokens`;
  * the paged tick gathers the same [slots, max_len] logical view the
    contiguous cache holds, so the decode math is identical.

The one scheduling difference is deliberate: chunked prefill runs to
completion inside the prefill engine instead of interleaving one chunk
per step -- with a dedicated prefill lane there is nothing to interleave
WITH. Per-request greedy outputs don't depend on tick scheduling (each
slot's next token is a function of its own cache), so greedy parity
covers mixed chunked traffic too; sampled parity holds whenever the
draw sequence lines up (no chunked or prefix-shared admissions).

What this facade does NOT cover (use the monolithic engine): LoRA
adapters, speculative decoding, int8 KV and ring caches -- each needs
its own paged story.
"""
from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.models.llama import LlamaConfig
from kubedl_tpu_torch.models.serving import Request, _bucket, validate_sampling
from kubedl_tpu_torch.serving.engine_decode import DecodeEngine
from kubedl_tpu_torch.serving.engine_prefill import PrefillEngine, _pow2
from kubedl_tpu_torch.serving.handoff import HandoffItem
from kubedl_tpu_torch.serving.kv_pool import PoolExhausted

_log = logging.getLogger("kubedl_tpu_torch.serving.disagg")


def serving_env(environ: Optional[Dict[str, str]] = None) -> Dict:
    """Pod-side view of the operator's ``spec.serving`` injection: the six
    ``KUBEDL_SERVING_*`` vars, parsed. Missing vars fall back to the
    engine defaults so a hand-run pod behaves as if the job had no
    serving block. ``role`` is the replica's prefill/decode assignment --
    routing, not engine shape -- so :meth:`DisaggregatedEngine.from_env`
    drops it; fleet runners read it to pick their lane."""
    env = os.environ if environ is None else environ
    return {
        "role": env.get("KUBEDL_SERVING_ROLE", ""),
        "slots": int(env.get("KUBEDL_SERVING_SLOTS", 8)),
        "max_len": int(env.get("KUBEDL_SERVING_MAX_LEN", 1024)),
        "block_size": int(env.get("KUBEDL_SERVING_BLOCK_SIZE", 16)),
        "num_blocks": int(env.get("KUBEDL_SERVING_KV_BLOCKS", 0)) or None,
        "share_prefixes":
            env.get("KUBEDL_SERVING_SHARE_PREFIXES", "1") != "0",
    }


class DisaggregatedEngine:
    """Paged prefill/decode serving behind the monolithic engine's API, on
    the device the parameters lie on."""

    def __init__(
        self,
        params: Dict,
        config: LlamaConfig,
        slots: int = 8,
        max_len: int = 1024,
        prompt_buckets: Optional[List[int]] = None,
        temperature: float = 0.0,
        seed: int = 0,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        share_prefixes: bool = True,
        max_top_k: int = 64,
        prefill_chunk: int = 256,
        kv_dtype=None,
        ring: Optional[bool] = None,
    ) -> None:
        if kv_dtype is not None:
            raise ValueError(
                "the paged decode path stores KV in the model dtype; "
                "kv_dtype='int8' needs paged scale pages — serve int8 KV "
                "from the monolithic ServingEngine")
        if ring:
            raise ValueError(
                "ring (sliding-window) caches are already O(window) — "
                "paging buys nothing; serve them from the monolithic "
                "ServingEngine")
        self.config = config
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.role = ""  # set by from_env for operator-run replicas
        self.prefill = PrefillEngine(
            params, config, max_len=max_len, prompt_buckets=prompt_buckets,
            prefill_chunk=prefill_chunk, max_top_k=max_top_k)
        self.decode = DecodeEngine(
            params, config, slots=slots, max_len=max_len,
            block_size=block_size, num_blocks=num_blocks,
            temperature=temperature, seed=seed, max_top_k=max_top_k,
            share_prefixes=share_prefixes)
        self.device = self.decode.device
        self.prompt_buckets = self.prefill.prompt_buckets
        self.prefill_chunk = self.prefill.prefill_chunk
        self.share_prefixes = share_prefixes
        self.max_top_k = max_top_k
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._queue: deque = deque()
        self._next_id = 0
        self._t0 = time.monotonic()
        self._handoffs = 0
        self._requeues = 0

    @classmethod
    def from_env(cls, params: Dict, config: LlamaConfig,
                 **overrides) -> "DisaggregatedEngine":
        """Build the engine a serving replica was admitted for: the
        paged-KV shape comes from the ``KUBEDL_SERVING_*`` injection;
        keyword overrides win over the env."""
        knobs = serving_env()
        role = knobs.pop("role")
        knobs.update(overrides)
        eng = cls(params, config, **knobs)
        eng.role = role
        return eng

    # -- submission (monolithic contract) ---------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        eos_token: Optional[int] = None,
        temperature: Optional[float] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        logprobs: bool = False,
        stop: Optional[list] = None,
    ) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        stop_seqs = validate_sampling(
            temperature, top_k, top_p, self.max_top_k, stop)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens "
                f"exceeds max_len {self.max_len}")
        if (prompt.size > self.prompt_buckets[-1]
                and not self._chunk_eligible(prompt.size)):
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prompt bucket {self.prompt_buckets[-1]}")
        req = Request(self._next_id, prompt, max_new_tokens, eos_token,
                      temperature=(self.temperature if temperature is None
                                   else float(temperature)),
                      top_k=int(top_k), top_p=float(top_p),
                      logprobs=bool(logprobs),
                      stop_sequences=tuple(stop_seqs))
        self._next_id += 1
        self._queue.append(req)
        return req

    def _chunk_eligible(self, prompt_len: int) -> bool:
        # same predicate as the monolithic engine (sans ring)
        if self.prefill_chunk <= 0:
            return False
        if prompt_len <= self.prompt_buckets[-1]:
            return False
        blocks = -(-prompt_len // self.prefill_chunk)
        return blocks * self.prefill_chunk <= self.max_len

    # -- admission ---------------------------------------------------------

    def _admit(self) -> None:
        """Pop every admissible request; route each through the right
        prefill lane (shared-prefix suffix append, chunked, or the
        bucketed wave); admit the results into the paged decode batch.
        Pop order, slot assignment and the per-cluster draw discipline
        mirror the monolithic `_admit` so token parity holds."""
        wave: List[Tuple[int, object, object]] = []
        batch: List[Request] = []
        batch_slots: List[int] = []
        while self._queue and self.decode.free_slots() > 0:
            req = self._queue.popleft()
            slot = self.decode._slot_req.index(None)
            prompt = np.asarray(req.prompt, np.int32)
            matched = []
            if (self.share_prefixes
                    and len(prompt) > self.decode.block_size
                    and not self._chunk_eligible(len(prompt))):
                matched = self.decode.match_prefix(prompt)
            try:
                if matched:
                    self._admit_shared(req, slot, prompt, matched, wave)
                elif self._chunk_eligible(len(prompt)):
                    self._admit_chunked(req, slot, prompt, wave)
                else:
                    batch.append(req)
                    batch_slots.append(slot)
                    self.decode.claim(slot, req)
            except PoolExhausted:
                # nothing was admitted for this request (admit() frees
                # the prefix references it was handed before raising);
                # put it back and stop admitting -- the pool frees up as
                # streams finish
                self._queue.appendleft(req)
                self._requeues += 1
                break
            except Exception as e:  # noqa: BLE001 — a poisoned prefill
                # must fail ITS request, not wedge the slot forever
                _log.exception("admission failed (request %d)",
                               req.request_id)
                req.error = f"prefill failed: {e}"
                req.done = True
                req.finished_at = time.monotonic()
        if batch:
            self._admit_batch(batch, batch_slots, wave)
        if wave:
            firsts = torch.stack([f for _, f, _ in wave]).tolist()
            lps = torch.stack([lp for _, _, lp in wave]).tolist()
            for (slot, _, _), tok, lp in zip(wave, firsts, lps):
                self.decode._emit(slot, int(tok), float(lp))

    def _admit_shared(self, req, slot, prompt, matched, wave) -> None:
        """Shared-prefix admission: the matched blocks join the slot's
        table by reference; only the suffix is prefilled (over a scratch
        seeded from the pool)."""
        start = len(matched) * self.decode.block_size
        try:
            scratch = self.decode.build_prefix_scratch(matched)
            first, first_lp, cache, total = self.prefill.prefill_suffix(
                scratch, prompt[start:], req, self.generator)
        except Exception:
            # the matched blocks were increfed for this request and
            # admit() never ran to take or release them
            self.decode.pool.free(matched)
            raise
        t_rows = total - start
        t_pad = min(_pow2(t_rows), self.max_len)
        cs = min(start, self.max_len - t_pad)  # clamped window start
        rows_k = [k[0, :, cs:cs + t_pad].transpose(0, 1) for k in cache["k"]]
        rows_v = [v[0, :, cs:cs + t_pad].transpose(0, 1) for v in cache["v"]]
        item = HandoffItem(
            request=req, prompt=prompt, total_len=total, start=cs,
            rows_k=rows_k, rows_v=rows_v, first_token=int(first),
            first_logprob=0.0, matched_blocks=matched,
            meta={"valid_from": start})
        self.decode.admit(item, req, slot=slot)
        self._handoffs += 1
        wave.append((slot, first, first_lp))

    def _admit_chunked(self, req, slot, prompt, wave) -> None:
        first, first_lp, rows_k, rows_v, t, _t_pad = \
            self.prefill.prefill_chunked(req, self.generator)
        item = HandoffItem(
            request=req, prompt=prompt, total_len=t, start=0,
            rows_k=rows_k, rows_v=rows_v, first_token=int(first),
            first_logprob=0.0)
        self.decode.admit(item, req, slot=slot)
        self._handoffs += 1
        wave.append((slot, first, first_lp))

    def _admit_batch(self, reqs: List[Request], slots: List[int],
                     wave: list) -> None:
        """Bucket clusters within a 4x span share one prefill dispatch --
        the monolithic `_admit_batch` economics, one draw per cluster."""
        row_bucket = [_bucket(len(r.prompt), self.prompt_buckets)
                      for r in reqs]
        clusters: List[Tuple[int, int]] = []
        for b in sorted(set(row_bucket)):
            if clusters and b <= 4 * clusters[-1][0]:
                clusters[-1] = (clusters[-1][0], b)
            else:
                clusters.append((b, b))
        for lo, hi in clusters:
            idxs = [i for i, b in enumerate(row_bucket) if lo <= b <= hi]
            g_reqs = [reqs[i] for i in idxs]
            g_slots = [slots[i] for i in idxs]
            try:
                self._admit_group(g_reqs, g_slots, hi, wave)
            except Exception as e:  # noqa: BLE001 — poisoned cluster:
                # fail ITS requests only, keep serving (same isolation
                # policy as the monolithic engine)
                _log.exception("prefill cluster failed (bucket=%d)", hi)
                for req, slot in zip(g_reqs, g_slots):
                    if self.decode._slot_req[slot] is req and not req.cache_len:
                        self.decode._slot_req[slot] = None
                        req.error = f"prefill failed: {e}"
                        req.done = True
                        req.finished_at = time.monotonic()

    def _admit_group(self, reqs, slots, bucket, wave) -> None:
        firsts, lps, rows, lengths = self.prefill.prefill_group(
            reqs, bucket, self.generator)
        first_ids = firsts.tolist()
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            rows_k, rows_v = self.prefill.extract_rows(rows, i, bucket)
            item = HandoffItem(
                request=req, prompt=np.asarray(req.prompt, np.int32),
                total_len=int(lengths[i]), start=0,
                rows_k=rows_k, rows_v=rows_v,
                first_token=int(first_ids[i]), first_logprob=0.0)
            # the slot was pre-claimed with the bare request; hand the
            # real admission the same slot
            self.decode._slot_req[slot] = None
            try:
                self.decode.admit(item, req, slot=slot)
            except PoolExhausted:
                # the wave prefill succeeded but the pool can't hold the
                # rows; requeue this and the cluster's remainder in FIFO
                # order -- nothing is half-admitted
                rest = list(zip(reqs[i:], slots[i:]))
                for r2, s2 in reversed(rest):
                    if self.decode._slot_req[s2] is r2:
                        self.decode._slot_req[s2] = None
                    self._queue.appendleft(r2)
                    self._requeues += 1
                return
            self._handoffs += 1
            wave.append((slot, firsts[i], lps[i]))

    # -- stepping (monolithic contract) -----------------------------------

    def _evict_for_capacity(self, k: int) -> None:
        """Make the next k ticks affordable, youngest stream first."""
        while True:
            try:
                self.decode.ensure_capacity(k)
                return
            except PoolExhausted:
                decoding = self.decode.decoding()
                if len(decoding) <= 1:
                    raise
                victim = max(decoding,
                             key=lambda s: self.decode._slot_seq[s])
                req = self.decode.evict_slot(victim)
                # continuation: prompt grows by the emitted tokens; the
                # re-prefill recomputes the same KV, so greedy streams
                # resume exactly where they left off
                req.prompt = np.concatenate(
                    [np.asarray(req.prompt, np.int32),
                     np.asarray(req.tokens, np.int32)])
                self._queue.appendleft(req)
                self._requeues += 1

    def step(self) -> int:
        self._admit()
        return self._step_inner()

    def _step_inner(self) -> int:
        decoding = self.decode.decoding()
        if not decoding:
            return 0
        self._evict_for_capacity(1)
        return self.decode.tick(self.generator)

    def step_block(self, max_block: int = 32) -> int:
        """The monolithic `step_block` heuristics verbatim (EOS cap,
        queue cap, power-of-two sizing, KV headroom ceiling) -- block
        boundaries are part of the sampled-token contract."""
        self._admit()
        decoding = self.decode.decoding()
        reqs = [self.decode._slot_req[s] for s in decoding]
        if not reqs:
            return 0
        k = min(r.max_new_tokens - len(r.tokens) for r in reqs)
        k = min(k, max_block)
        if any(r.eos_token is not None or r.stop_sequences for r in reqs):
            k = min(k, 8)
        elif self._queue:
            k = min(k, max(max_block // 4, 8))
        if k <= 1:
            return self._step_inner()
        k = 1 << max(k - 1, 1).bit_length()
        if k > max_block:
            k = 1 << (max_block.bit_length() - 1)
        head = self.max_len - max(r.cache_len for r in reqs)
        if k > head:
            k = 1 << (head.bit_length() - 1) if head >= 1 else 0
        if k <= 1:
            return self._step_inner()
        self._evict_for_capacity(k)
        return self.decode.tick_block(int(k), self.generator)

    def serve_all(self, prompts, max_new_tokens: int,
                  eos_token: Optional[int] = None) -> List[List[int]]:
        reqs = [self.submit(p, max_new_tokens, eos_token) for p in prompts]
        while not all(r.done for r in reqs):
            self.step_block()
        return [r.tokens for r in reqs]

    def has_pending(self) -> bool:
        return bool(self._queue) or bool(self.decode.decoding())

    def cancel(self, req: Request) -> None:
        if req.done:
            return
        try:
            self._queue.remove(req)
            req.done = True
            return
        except ValueError:
            pass
        if self.decode.cancel_slot(req):
            req.done = True

    def stats(self) -> Dict:
        wall = max(time.monotonic() - self._t0, 1e-9)
        d = self.decode.stats()
        return {
            **d,
            **self.prefill.stats(),
            "queue_depth": len(self._queue),
            "slot_utilization": d["slots_busy"] / self.slots,
            "tokens_per_sec": d["tokens_out"] / wall,
            "handoffs": self._handoffs,
            "requeues": self._requeues,
        }
