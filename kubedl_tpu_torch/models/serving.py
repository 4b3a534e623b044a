"""Continuous-batching serving engine (kubedl_tpu/models/serving.py).

One static decode batch ([slots, max_len] ragged KV cache) lives on the
device for the engine's lifetime and requests come and go by writing rows:

  * admission pops every waiting request a free slot can take, groups the
    wave into bucket clusters (buckets within a 4x span share one prefill,
    padded to the cluster's largest bucket and to a power-of-two batch),
    runs one batched `decode.prefill` per cluster through the flash kernel,
    and splices each row into the live batch;
  * each tick is one ragged `decode.decode_step` over every slot plus
    per-slot sampling, with an activity mask that freezes finished and
    empty slots; `step_block` chains up to k ticks with one host sync;
  * a cluster whose prefill raises fails only its own requests.

`kv_dtype="int8"` keeps the live cache and the prefill scratch in int8
codes with bf16 scales (models/decode.py). With a `mesh`, the parameters
are DTensors (`llama.param_specs`) and the engine runs on every rank of the
group with the same submissions in the same order: its slots are
replicated, only the tensor axis splits the work, the local views of the
leaves are taken once here, and every rank samples the same tokens from
the gathered logits with the same seeded generator.

Not ported yet, and refused with NotImplementedError where they would be
asked for: speculative decoding, LoRA adapters, prefix caching, chunked
prefill and ring KV caches (ROADMAP.md).
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.models import decode
from kubedl_tpu_torch.models.llama import LlamaConfig

_log = logging.getLogger("kubedl_tpu_torch.serving")


def _bucket(n: int, buckets: List[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds the largest bucket {buckets[-1]}")


def sample_tokens(logits, generator, temps, top_ks, top_ps, mode: str,
                  max_top_k: int):
    """[slots, V] logits -> [slots] int32 token ids, per-slot parameters.

    `mode` is chosen from what the active requests use: "greedy" (argmax
    only), "plain" (one categorical over the full vocab; temp-0 rows take
    argmax) or "filtered" (top_k / top_p within the top `max_top_k`
    candidates; rows that set neither knob still draw from the full
    vocab). Draws come from `generator`."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if mode == "greedy":
        return greedy
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    plain = decode._categorical(scaled, generator).to(torch.int32)
    if mode == "plain":
        return torch.where(temps > 0, plain, greedy)
    K = min(max_top_k, logits.shape[-1])
    vals, idx = torch.topk(scaled, K, dim=-1)  # sorted descending
    kk = torch.where(top_ks > 0, top_ks.clamp(max=K), torch.full_like(top_ks, K))
    kmask = torch.arange(K, device=logits.device)[None, :] < kk[:, None]
    neg = torch.full_like(vals, float("-inf"))
    probs = torch.softmax(torch.where(kmask, vals, neg), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # nucleus: the smallest prefix with mass >= top_p; the first candidate
    # is always kept (cum - probs == 0 < top_p)
    keep = (cum - probs) < top_ps[:, None]
    choice = decode._categorical(torch.where(kmask & keep, vals, neg), generator)
    filtered = idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)
    row_filtered = (top_ks > 0) | (top_ps < 1.0)
    sampled = torch.where(row_filtered, filtered, plain)
    return torch.where(temps > 0, sampled, greedy)


def chosen_logprob(logits, chosen):
    """log p(chosen) under the model's untempered distribution."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return logits.gather(-1, chosen[:, None].long())[:, 0] - lse


def emit_token(req: "Request", token: int, logprob: float = 0.0) -> bool:
    """Append one decoded token to `req` and apply the termination
    contract: stop-sequence rollback, EOS, max_new_tokens. Returns True
    when the request just finished."""
    # logprob before token: a reader gated on len(tokens) must find both
    if req.logprobs:
        req.token_logprobs.append(logprob)
    req.tokens.append(token)
    if req.first_token_at is None:
        req.first_token_at = time.monotonic()
    hit_stop = False
    for seq in req.stop_sequences:
        n = len(seq)
        if len(req.tokens) >= n and tuple(req.tokens[-n:]) == seq:
            # OpenAI convention: the matched stop sequence is excluded
            del req.tokens[-n:]
            if req.logprobs:
                del req.token_logprobs[-n:]
            hit_stop = True
            break
    if (hit_stop or len(req.tokens) >= req.max_new_tokens
            or (req.eos_token is not None and token == req.eos_token)):
        req.done = True
        req.finished_at = time.monotonic()
        return True
    return False


def validate_sampling(temperature, top_k, top_p, max_top_k, stop) -> List[tuple]:
    """Submit-time validation of the sampling/termination knobs; returns
    the parsed stop sequences (at most 4, each 1..16 tokens) as tuples."""
    if temperature is not None and temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if not 0 <= top_k <= max_top_k:
        raise ValueError(
            f"top_k must be in [0, {max_top_k}] (engine max_top_k), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    stop_seqs = []
    for s in (stop or []):
        ids = [int(t) for t in s]
        if not ids:
            raise ValueError("empty stop sequence")
        if len(ids) > 16:
            raise ValueError(f"stop sequence of {len(ids)} tokens (max 16)")
        stop_seqs.append(tuple(ids))
    if len(stop_seqs) > 4:
        raise ValueError(f"{len(stop_seqs)} stop sequences (max 4)")
    return stop_seqs


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # [t] int32
    max_new_tokens: int
    eos_token: Optional[int] = None
    # temperature None = engine default; 0 = greedy. top_k 0 and top_p 1.0
    # are off; filtering runs within the engine's top-max_top_k candidates
    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 1.0
    logprobs: bool = False
    stop_sequences: tuple = ()
    # filled by the engine
    tokens: List[int] = field(default_factory=list)
    token_logprobs: List[float] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None  # set when the engine failed the request
    cache_len: int = 0  # prompt tokens + device ticks consumed
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def needs_filter(self) -> bool:
        return self.top_k > 0 or self.top_p < 1.0


def _to_host(tensors):
    """Device -> host for a tuple of tensors; the one sync of a wave."""
    return tuple(t.cpu() for t in tensors)


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported to kubedl_tpu_torch yet "
                               f"(ROADMAP.md: serving features deferred from "
                               f"slice 1)")


class ServingEngine:
    """Slot-based continuous batching for one model on one device (the
    device its params lie on), or on this rank's device of a `mesh`."""

    def __init__(
        self,
        params: Dict,
        config: LlamaConfig,
        slots: int = 8,
        max_len: int = 1024,
        prompt_buckets: Optional[List[int]] = None,
        temperature: float = 0.0,
        seed: int = 0,
        kv_dtype=None,
        ring: Optional[bool] = None,
        max_top_k: int = 64,
        prefill_chunk: int = 0,
        draft_params: Optional[Dict] = None,
        draft_config: Optional[LlamaConfig] = None,
        mesh=None,
        rules=None,
    ) -> None:
        if ring:
            raise _unported("ring KV caches (ring=True)")
        if prefill_chunk:
            raise _unported("chunked prefill (prefill_chunk > 0)")
        if draft_params is not None or draft_config is not None:
            raise _unported("speculative decoding (draft_params)")
        self.params = params
        self.config = config
        self.kv_dtype = kv_dtype
        self.mesh, self.rules = mesh, rules
        self._local, self._par = decode._mesh_context(params, config, mesh, rules)
        self.device = self._local["embed"].device
        self.slots = slots
        self.max_len = max_len
        if prompt_buckets is None:
            prompt_buckets = []
            b = 16
            while b < max_len:
                prompt_buckets.append(b)
                b *= 2
            prompt_buckets.append(max_len)
        self.prompt_buckets = sorted(prompt_buckets)
        if self.prompt_buckets[-1] > max_len:
            raise ValueError(
                f"largest prompt bucket {self.prompt_buckets[-1]} exceeds "
                f"max_len {max_len} — prefill could not fit the scratch cache")
        self.temperature = temperature
        self.max_top_k = max_top_k
        dev = self.device
        # per-slot sampling state on the device, written only at admission
        self.samp_temps = torch.full((slots,), float(temperature),
                                     dtype=torch.float32, device=dev)
        self.samp_topk = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.samp_topp = torch.ones((slots,), dtype=torch.float32, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.cache = self._new_cache(slots, max_len)
        self.cur_tokens = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._queue: deque = deque()
        self._next_id = 0
        self._ticks = 0
        self._tokens_out = 0
        self._admitted = 0
        self._t0 = time.monotonic()
        # where the wall clock goes: prefill spans admission to the wave's
        # host sync, decode spans tick launch to its host sync
        self._prefill_time = 0.0
        self._decode_time = 0.0
        self._prefill_batches = 0
        # the wave's device->host sync; an attribute so a test can poison
        # one cluster's fetch
        self._wave_sync = _to_host
        self._wave_failures = 0
        self._wave_resets = 0

    # -- device pieces -----------------------------------------------------

    def _new_cache(self, batch: int, max_len: int) -> Dict:
        return decode.init_kv_cache(self.config, batch, max_len, kv_dtype=self.kv_dtype,
                                    device=self.device, mesh=self.mesh, rules=self.rules)

    def _insert(self, rows: Dict, i: int, slot: int, length: int, first) -> None:
        """Splice row i of a prefill cache (K/V and any int8 scales) into
        `slot` of the live batch."""
        L = rows["k"][0].shape[2]
        for name in ("k", "v", "ks", "vs"):
            for big, small in zip(self.cache.get(name, ()), rows.get(name, ())):
                big[slot, :, :L] = small[i]
        self.cache["lengths"][slot] = length
        self.cur_tokens[slot] = first
        self.active[slot] = True

    def _tick(self, mode: str):
        """One decode tick over every slot: (next tokens, their logprobs)."""
        old = self.cache["lengths"]
        logits, self.cache = decode._decode_block_step(
            self._local, self.cur_tokens[:, None], self.cache, self.config,
            check=False, par=self._par)
        logits = logits[:, 0]
        nxt = sample_tokens(logits, self.generator, self.samp_temps,
                            self.samp_topk, self.samp_topp, mode, self.max_top_k)
        nxt = torch.where(self.active, nxt, torch.zeros_like(nxt))
        lp = chosen_logprob(logits, nxt)
        # frozen slots: the length must not advance (their write at the old
        # position is dead data the next admission overwrites)
        self.cache["lengths"] = torch.where(self.active, self.cache["lengths"], old)
        self.cur_tokens = nxt
        return nxt, lp

    # -- public API --------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        eos_token: Optional[int] = None,
        prefix_id: Optional[int] = None,
        temperature: Optional[float] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        logprobs: bool = False,
        adapter_id: int = 0,
        stop: Optional[list] = None,
    ) -> Request:
        if prefix_id is not None:
            raise _unported("prefix caching (prefix_id)")
        if adapter_id:
            raise _unported("LoRA adapter serving (adapter_id)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        stop_seqs = validate_sampling(
            temperature, top_k, top_p, self.max_top_k, stop)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens exceeds "
                f"max_len {self.max_len}")
        if prompt.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the largest prompt "
                f"bucket {self.prompt_buckets[-1]} (chunked prefill, which "
                f"lifts this cap, is not ported yet)")
        req = Request(self._next_id, prompt, max_new_tokens, eos_token,
                      temperature=(self.temperature if temperature is None
                                   else float(temperature)),
                      top_k=int(top_k), top_p=float(top_p),
                      logprobs=bool(logprobs), stop_sequences=tuple(stop_seqs))
        self._next_id += 1
        self._queue.append(req)
        return req

    def _admit(self) -> None:
        """Pop every request a free slot can take and prefill the wave in
        bucket clusters; one host sync fetches every first token."""
        t0 = time.monotonic()
        wave = []  # (slot, first token, its logprob, cluster key)
        batch: List[Request] = []
        batch_slots: List[int] = []
        while self._queue and None in self._slot_req:
            req = self._queue.popleft()
            slot = self._slot_req.index(None)
            batch.append(req)
            batch_slots.append(slot)
            self._slot_req[slot] = req  # claim so .index(None) advances
        if batch:
            self._admit_batch(batch, batch_slots, wave)
        if wave:
            try:
                firsts, lps = self._wave_sync(
                    (torch.stack([f for _, f, _, _ in wave]),
                     torch.stack([l for _, _, l, _ in wave])))
            except Exception:  # noqa: BLE001 — isolate per cluster below
                _log.exception("admission wave sync failed; isolating per cluster")
                self._recover_wave(wave)
                self._prefill_time += time.monotonic() - t0
                return
            for (slot, _, _, _), tok, lp in zip(wave, firsts.tolist(), lps.tolist()):
                self._emit(slot, int(tok), float(lp))
        self._prefill_time += time.monotonic() - t0

    def _fail(self, slot: int, req: Request, reason: str) -> None:
        req.error = reason
        req.done = True
        req.finished_at = time.monotonic()
        if self._slot_req[slot] is req:
            self._release(slot)

    def _release(self, slot: int) -> None:
        self._slot_req[slot] = None
        self.active[slot] = False

    def _recover_wave(self, wave) -> None:
        """A wave sync raised: re-sync each prefill cluster alone so only
        the poisoned one's requests fail, then check that the live cache
        is still readable; if it is not, rebuild it empty and fail every
        in-flight request rather than serve garbage."""
        clusters: Dict[str, list] = {}
        for entry in wave:
            clusters.setdefault(entry[3], []).append(entry)
        for ckey, entries in clusters.items():
            try:
                firsts, lps = self._wave_sync(
                    (torch.stack([f for _, f, _, _ in entries]),
                     torch.stack([l for _, _, l, _ in entries])))
            except Exception as e:  # noqa: BLE001 — fail THIS cluster only
                self._wave_failures += 1
                _log.exception("prefill cluster %s poisoned (%d request(s))",
                               ckey, len(entries))
                for slot, _, _, _ in entries:
                    req = self._slot_req[slot]
                    if req is not None:
                        self._fail(slot, req, f"prefill failed: {e}")
                continue
            for (slot, _, _, _), tok, lp in zip(entries, firsts.tolist(), lps.tolist()):
                self._emit(slot, int(tok), float(lp))
        try:
            self._wave_sync((self.cache["lengths"], self.cur_tokens))
        except Exception:  # noqa: BLE001
            self._wave_resets += 1
            _log.exception("device cache poisoned after wave failure; rebuilding empty")
            for slot, req in enumerate(self._slot_req):
                if req is not None:
                    self._fail(slot, req, "engine cache rebuilt after prefill failure")
            self.cache = self._new_cache(self.slots, self.max_len)
            self.cur_tokens = torch.zeros((self.slots,), dtype=torch.int32,
                                          device=self.device)
            self.active = torch.zeros((self.slots,), dtype=torch.bool,
                                      device=self.device)

    def _claim_slot(self, slot: int, req: Request, cache_len: int) -> None:
        self.samp_temps[slot] = req.temperature
        self.samp_topk[slot] = req.top_k
        self.samp_topp[slot] = req.top_p
        self._slot_req[slot] = req
        self._admitted += 1
        req.cache_len = cache_len

    def _decoding(self) -> List[int]:
        return [s for s, r in enumerate(self._slot_req) if r is not None]

    def _admit_batch(self, reqs: List[Request], slots: List[int], wave: list) -> None:
        """Wave prefill in bucket clusters: buckets within a 4x span share
        one prefill padded to the cluster's largest bucket. A cluster whose
        prefill raises fails only its requests; the engine keeps serving."""
        row_bucket = [_bucket(len(r.prompt), self.prompt_buckets) for r in reqs]
        clusters: List[Tuple[int, int]] = []  # (smallest, largest) bucket
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
                self._admit_group(g_reqs, g_slots, hi, wave,
                                  cluster=f"bucket:{lo}-{hi}")
            except Exception as e:  # noqa: BLE001 — a failed prefill must
                # not wedge its claimed slots
                _log.exception("prefill batch failed (bucket=%d, k=%d)",
                               hi, len(g_reqs))
                for req, slot in zip(g_reqs, g_slots):
                    if self._slot_req[slot] is req and not req.cache_len:
                        self._fail(slot, req, f"prefill failed: {e}")

    def _admit_group(self, reqs: List[Request], slots: List[int], bucket: int,
                     wave: list, cluster: str = "") -> None:
        """One prefill for a bucket cluster: rows padded to the bucket, the
        batch padded to a power of two with dummy rows (length 1, token 0)
        that are never inserted."""
        k = len(reqs)
        k_pad = 1 << (k - 1).bit_length()
        padded = np.zeros((k_pad, bucket), np.int32)
        lengths = np.ones((k_pad,), np.int32)
        temps = np.zeros((k_pad,), np.float32)
        topks = np.zeros((k_pad,), np.int32)
        topps = np.ones((k_pad,), np.float32)
        for i, r in enumerate(reqs):
            t = len(r.prompt)
            padded[i, :t] = r.prompt
            lengths[i] = t
            temps[i] = r.temperature
            topks[i] = r.top_k
            topps[i] = r.top_p
        dev = self.device
        logits, rows = decode._prefill(
            self._local, torch.from_numpy(padded).to(dev), self._new_cache(k_pad, bucket),
            self.config, torch.from_numpy(lengths).to(dev), self._par)
        self._prefill_batches += 1
        if any(r.needs_filter for r in reqs):
            mode = "filtered"
        elif any(r.temperature > 0 for r in reqs):
            mode = "plain"
        else:
            mode = "greedy"
        firsts = sample_tokens(
            logits, self.generator, torch.from_numpy(temps).to(dev),
            torch.from_numpy(topks).to(dev), torch.from_numpy(topps).to(dev),
            mode, self.max_top_k)
        lps = chosen_logprob(logits, firsts)
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            self._insert(rows, i, slot, int(lengths[i]), firsts[i])
            self._claim_slot(slot, req, int(lengths[i]))
            wave.append((slot, firsts[i], lps[i], cluster))

    def _emit(self, slot: int, token: int, logprob: float = 0.0) -> None:
        req = self._slot_req[slot]
        self._tokens_out += 1
        if emit_token(req, token, logprob):
            self._release(slot)

    def has_pending(self) -> bool:
        """True while any request is queued or occupying a slot."""
        return bool(self._queue) or any(r is not None for r in self._slot_req)

    def _sample_mode(self) -> str:
        reqs = [r for r in self._slot_req if r is not None]
        if any(r.needs_filter for r in reqs):
            return "filtered"
        if any(r.temperature > 0 for r in reqs):
            return "plain"
        return "greedy"

    def cancel(self, req: Request) -> None:
        """Drop a request: dequeue it if waiting, or free its slot. A no-op
        on finished requests."""
        if req.done:
            return
        try:
            self._queue.remove(req)
            req.done = True
            return
        except ValueError:
            pass
        for slot, r in enumerate(self._slot_req):
            if r is req:
                req.done = True
                self._release(slot)
                return

    def step(self) -> int:
        """Admit waiting requests, then advance every active slot one
        token. Returns the number of decoding slots this tick."""
        self._admit()
        return self._step_inner()

    def _step_inner(self) -> int:
        decoding = self._decoding()
        if not decoding:
            return 0
        t0 = time.monotonic()
        nxt, lp = self._tick(self._sample_mode())
        self._ticks += 1
        emitted, lps = (a.tolist() for a in _to_host((nxt, lp)))
        self._decode_time += time.monotonic() - t0
        for slot in decoding:
            req = self._slot_req[slot]
            if req is not None:
                req.cache_len += 1
                self._emit(slot, int(emitted[slot]), float(lps[slot]))
        return len(decoding)

    def step_block(self, max_block: int = 32) -> int:
        """Admit, then advance up to `max_block` ticks with ONE host sync.

        The block adapts down to the smallest token budget left, to the KV
        headroom of the fullest slot, and to a small cap while requests
        queue or an EOS/stop is possible; sizes are powers of two and the
        overshoot past a budget is trimmed on the host. Degenerates to one
        tick when the block would be 1."""
        self._admit()
        decoding = self._decoding()
        reqs = [self._slot_req[s] for s in decoding]
        if not reqs:
            return 0
        k = min(r.max_new_tokens - len(r.tokens) for r in reqs)
        k = min(k, max_block)
        if any(r.eos_token is not None or r.stop_sequences for r in reqs):
            k = min(k, 8)  # post-EOS/stop ticks are pure waste; stay short
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
        t0 = time.monotonic()
        mode = self._sample_mode()
        toks, lps = [], []
        for _ in range(k):
            nxt, lp = self._tick(mode)
            toks.append(nxt)
            lps.append(lp)
        self._ticks += k
        block, block_lp = (a.tolist() for a in
                           _to_host((torch.stack(toks), torch.stack(lps))))
        self._decode_time += time.monotonic() - t0
        for i in range(k):
            for slot in decoding:
                req = self._slot_req[slot]
                if req is not None:
                    req.cache_len += 1
                    self._emit(slot, int(block[i][slot]), float(block_lp[i][slot]))
        return len(reqs)

    def serve_all(self, prompts, max_new_tokens: int,
                  eos_token: Optional[int] = None) -> List[List[int]]:
        """Submit everything, run to drain, return per-prompt tokens."""
        reqs = [self.submit(p, max_new_tokens, eos_token) for p in prompts]
        while not all(r.done for r in reqs):
            self.step_block()
        return [r.tokens for r in reqs]

    def stats(self) -> Dict:
        wall = max(time.monotonic() - self._t0, 1e-9)
        busy = sum(1 for r in self._slot_req if r is not None)
        return {
            "slots": self.slots,
            "slots_busy": busy,
            "queue_depth": len(self._queue),
            "admitted": self._admitted,
            "ticks": self._ticks,
            "tokens_out": self._tokens_out,
            "tokens_per_sec": self._tokens_out / wall,
            "slot_utilization": busy / self.slots,
            "prefill_time_s": round(self._prefill_time, 4),
            "decode_time_s": round(self._decode_time, 4),
            "prefill_batches": self._prefill_batches,
            "wave_failures": self._wave_failures,
            "wave_resets": self._wave_resets,
            "kv_cache_bytes": decode.cache_bytes(self.cache),
        }
