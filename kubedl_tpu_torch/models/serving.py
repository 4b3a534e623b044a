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
  * a cluster whose prefill raises fails only its own requests;
  * a prompt longer than the largest bucket prefills in `prefill_chunk`
    block steps, one chunk per engine step, so the decoding slots keep
    emitting between chunks (one such prompt at a time);
  * a registered prefix (`register_prefix`, a shared system prompt) is
    prefilled once; a request naming it appends only its suffix, to a copy
    of the prefix's cache;
  * sliding-window models keep ring caches by default (the window's rows,
    not max_len's); a prefill row is spliced into ring order;
  * with `draft_params`, each engine step over all-greedy traffic is a
    speculative round: the draft proposes `spec_k` tokens a slot, one
    ragged block step of the target verifies every slot, each keeps its
    longest accepted prefix and the target's next token. Sampled traffic
    falls back to plain ticks, with the draft cache kept in step;
  * LoRA adapters registered with `register_adapter` are chosen per
    request (`adapter_id`, 0 the base model): their deltas ride the shared
    prefill, chunk append, tick and verify as stacks gathered by each
    slot's id (models/llama.py `_proj`); the draft runs without them. With
    no adapter registered nothing of this runs.

`kv_dtype="int8"` keeps the live cache and the prefill scratch in int8
codes with bf16 scales (models/decode.py). With a `mesh`, the parameters
are DTensors (`llama.param_specs`) and the engine runs on every rank of the
group with the same submissions in the same order: its slots are
replicated, only the tensor axis splits the work, the local views of the
leaves are taken once here, and every rank samples the same tokens from
the gathered logits with the same seeded generator. Every feature above
runs there too: a ring, a registered prefix and the chunker's cache hold
this rank's KV heads, and a draft takes its own local views of a tree
sharded alike. LoRA adapters under a mesh are refused (NotImplementedError
naming ROADMAP.md 12d), as is a mesh context axis above 1 (12f).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.models import decode
from kubedl_tpu_torch.models.llama import LlamaConfig
from kubedl_tpu_torch.models.quant import is_quantized

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
    if req.token_times is not None:
        req.token_times.append(time.monotonic())
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
    prompt: np.ndarray  # [t] int32 (the suffix when prefix_id is set)
    max_new_tokens: int
    eos_token: Optional[int] = None
    prefix_id: Optional[int] = None
    # temperature None = engine default; 0 = greedy. top_k 0 and top_p 1.0
    # are off; filtering runs within the engine's top-max_top_k candidates
    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 1.0
    logprobs: bool = False
    stop_sequences: tuple = ()
    # LoRA adapter id from engine.register_adapter (0 = base model)
    adapter_id: int = 0
    # filled by the engine
    tokens: List[int] = field(default_factory=list)
    token_logprobs: List[float] = field(default_factory=list)
    done: bool = False
    error: Optional[str] = None  # set when the engine failed the request
    cache_len: int = 0  # prompt (+ prefix) tokens + device ticks consumed
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # per-token wall clocks, kept only when a caller sets a list here
    token_times: Optional[List[float]] = None

    @property
    def needs_filter(self) -> bool:
        return self.top_k > 0 or self.top_p < 1.0


def _to_host(tensors):
    """Device -> host for a tuple of tensors; the one sync of a wave."""
    return tuple(t.cpu() for t in tensors)


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
        max_prefixes: int = 8,
        kv_dtype=None,
        ring: Optional[bool] = None,
        max_top_k: int = 64,
        prefill_chunk: int = 256,
        draft_params: Optional[Dict] = None,
        draft_config: Optional[LlamaConfig] = None,
        spec_k: int = 4,
        mesh=None,
        rules=None,
        max_adapters: int = 8,
    ) -> None:
        # ring caches (sliding-window models): the live buffers hold the
        # window's rows; max_len stays each slot's token budget. On by
        # default whenever the window is smaller than max_len.
        if ring is None:
            ring = bool(config.sliding_window) and config.sliding_window < max_len
        if ring and not config.sliding_window:
            raise ValueError("ring=True requires config.sliding_window")
        self.ring = bool(ring)
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
        # multi-adapter serving: stacked LoRA deltas chosen per slot inside
        # the shared tick; adapter 0 is the base model (an all-zero row).
        # None until the first register_adapter.
        self.max_adapters = max_adapters
        self.lora: Optional[Dict] = None
        self._adapter_rows: list = []  # host f32 copies for stack rebuilds
        self._adapter_meta = None  # (rank, per-layer target tuple)
        self.slot_adapter = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.cache = self._new_cache(slots, max_len, ring=self.ring)
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
        # chunked prefill: one long prompt at a time, one chunk an engine
        # step; 0 sends everything through the batched wave
        self.prefill_chunk = int(prefill_chunk)
        self._chunking: Optional[Dict] = None  # {req, slot, cache, pos}
        self._chunked_prefills = 0
        # prefix caching: each prefix holds a batch-1 [max_len] cache
        self._prefixes: Dict[int, tuple] = {}
        self._next_prefix_id = 0
        self.max_prefixes = max_prefixes
        self._prefix_lock = threading.Lock()
        # speculative serving: the draft shares the slot structure with a
        # ragged cache of its own, prefilled beside the target's
        self._spec = draft_params is not None
        if self._spec:
            if draft_config is None:
                raise ValueError("draft_params needs draft_config")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_config.vocab_size} != target "
                    f"{config.vocab_size}; the models must share a tokenizer")
            if self.ring:
                raise ValueError("speculative serving is unsupported with ring caches "
                                 "(the verify block can't wrap)")
            if spec_k < 2:
                raise ValueError(f"spec_k must be >= 2, got {spec_k}")
            self.draft_params = draft_params
            self.draft_config = draft_config
            # the draft's local views and collectives, on the target's mesh
            self._draft_local, self._draft_par = decode._mesh_context(
                draft_params, draft_config, mesh, rules)
            self.spec_k = int(spec_k)
            self.draft_cache = self._new_cache(slots, max_len, config=draft_config)
            self._spec_rounds = 0
            self._spec_slot_rounds = 0  # sum over rounds of decoding slots
            self._spec_accepted = 0

    # -- device pieces -----------------------------------------------------

    def _new_cache(self, batch: int, max_len: int, ring: bool = False,
                   uniform: bool = False, config: Optional[LlamaConfig] = None) -> Dict:
        return decode.init_kv_cache(config or self.config, batch, max_len, uniform=uniform,
                                    kv_dtype=self.kv_dtype, ring=ring, device=self.device,
                                    mesh=self.mesh, rules=self.rules)

    def _prefill_rows(self, params, config, padded: np.ndarray, lengths: np.ndarray,
                      par=None, adapters: Optional[np.ndarray] = None):
        """Batched one-pass prefill of right-padded prompts into a scratch
        cache as long as the padding: (last-token logits, rows). `adapters`
        [rows] are the rows' adapter ids, when adapters are registered."""
        dev = self.device
        cache = decode.init_kv_cache(config, padded.shape[0], padded.shape[1],
                                     kv_dtype=self.kv_dtype, device=dev,
                                     mesh=self.mesh if par is not None else None,
                                     rules=self.rules)
        return decode._prefill(params, torch.from_numpy(padded).to(dev), cache, config,
                               torch.from_numpy(lengths).to(dev), par,
                               **self._lora_for(adapters))

    def _lora_for(self, adapters: Optional[np.ndarray]) -> Dict:
        """The decode functions' adapter arguments for rows with adapter ids
        `adapters`: none when no adapter is registered or no ids are given
        (the base model's path takes no adapter arguments)."""
        if self.lora is None or adapters is None:
            return {}
        return {"lora": self.lora,
                "adapter_ids": torch.from_numpy(adapters).to(self.device)}

    @staticmethod
    def _splice(cache: Dict, rows: Dict, i: int, slot: int, length: int) -> None:
        """Row i of a full-layout prefill cache (K/V and any int8 scales)
        into `slot` of `cache`. A ring takes the prompt's last positions in
        ring order (the formula the attention reads them with)."""
        L = rows["k"][0].shape[2]
        idx = None
        if "ring" in cache:
            W = cache["k"][0].shape[2]
            idx = decode.ring_rows(torch.tensor(length, device=cache["k"][0].device),
                                   W, L)
        for name in ("k", "v", "ks", "vs"):
            for big, small in zip(cache.get(name, ()), rows.get(name, ())):
                if idx is None:
                    big[slot, :, :L] = small[i]
                else:
                    big[slot] = small[i][:, idx]
        cache["lengths"][slot] = length

    def _insert(self, rows: Dict, i: int, slot: int, length: int, first) -> None:
        """Splice row i of a prefill cache into `slot` of the live batch,
        with the slot's first token, and mark the slot active."""
        self._splice(self.cache, rows, i, slot, length)
        self.cur_tokens[slot] = first
        self.active[slot] = True

    def _tick(self, mode: str):
        """One decode tick over every slot: (next tokens, their logprobs)."""
        old = self.cache["lengths"]
        logits, self.cache = decode._decode_block_step(
            self._local, self.cur_tokens[:, None], self.cache, self.config,
            check=False, par=self._par, lora=self.lora, adapter_ids=self.slot_adapter)
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

    def _append_block(self, toks: np.ndarray, cache: Dict, adapter_id: Optional[int] = None):
        """A block step of a uniform batch-1 cache, in place: (hidden rows
        [1, T, d], cache). The chunked prefill (with its request's adapter)
        and the suffix append (base model only)."""
        return decode._decode_block_step(
            self._local, torch.from_numpy(np.ascontiguousarray(toks[None])).to(self.device),
            cache, self.config, check=False, par=self._par, return_hidden=True,
            **self._lora_for(None if adapter_id is None else np.array([adapter_id], np.int32)))

    def _head(self, hidden):
        """Logits [1, V] of the hidden row [1, d]."""
        return decode._full_logits(
            decode._lm_head(hidden[:, None], self._local, self.config, self._par)[:, 0],
            self._par)

    def _spec_round(self, cur, active, base, d_base):
        """One greedy speculative round over the whole slot batch: (new
        current tokens, emit [slots, k], accepted [slots], logprobs [slots,
        k]). Slot s produced emit[s, :accepted+1] (accepted drafts, then
        the target's next token); both caches roll back to base + accepted
        + 1, frozen slots to base. The verify block is k wide: the k-th
        draft can never be emitted (acceptance caps at k-1 so the draft
        cache, which saw k inputs, stays aligned), but its draft step's
        write is needed at full acceptance."""
        k = self.spec_k
        tok, drafted = cur, []
        for _ in range(k):
            lg, self.draft_cache = decode._decode_block_step(
                self._draft_local, tok[:, None], self.draft_cache, self.draft_config,
                check=False, par=self._draft_par)
            tok = torch.where(active, lg[:, 0].argmax(dim=-1).to(torch.int32),
                              torch.zeros_like(tok))
            drafted.append(tok)
        drafted = torch.stack(drafted, dim=1)  # [s, k]
        blk = torch.cat([cur[:, None], drafted[:, : k - 1]], dim=1)  # [s, k]
        blk_logits, self.cache = decode._decode_block_step(
            self._local, blk, self.cache, self.config, check=False, par=self._par,
            lora=self.lora, adapter_ids=self.slot_adapter)
        ta = blk_logits.argmax(dim=-1).to(torch.int32)  # [s, k]
        matches = (drafted[:, : k - 1] == ta[:, : k - 1]).to(torch.int32)
        a = torch.cumprod(matches, dim=1).sum(dim=1)  # [s], <= k-1
        bonus = ta.gather(1, a[:, None].long())[:, 0]
        cols = torch.arange(k, device=cur.device)[None, :]
        emit = torch.where(cols < a[:, None], drafted, torch.zeros_like(drafted))
        emit = torch.where(cols == a[:, None], bonus[:, None], emit)
        lg32 = blk_logits.float()  # position j's logits predict emit j
        lp = lg32.gather(2, emit[:, :, None].long())[:, :, 0] - torch.logsumexp(lg32, dim=-1)
        adv = (a + 1).to(torch.int32)
        self.cache["lengths"] = torch.where(active, base + adv, base)
        self.draft_cache["lengths"] = torch.where(active, d_base + adv, d_base)
        return (torch.where(active, bonus, cur), emit,
                torch.where(active, a, torch.zeros_like(a)), lp)

    def _spec_block(self, r: int):
        """r speculative rounds chained on the device with one host sync
        (the tick block applied to rounds): [r, slots, ...] on the host."""
        emits, accs, lps = [], [], []
        cur = self.cur_tokens
        for _ in range(r):
            cur, emit, acc, lp = self._spec_round(
                cur, self.active, self.cache["lengths"], self.draft_cache["lengths"])
            emits.append(emit)
            accs.append(acc)
            lps.append(lp)
        self.cur_tokens = cur
        return _to_host((torch.stack(emits), torch.stack(accs), torch.stack(lps)))

    def _spec_head(self, decoding: List[int]) -> int:
        """KV headroom of the fullest decoding slot, shared by the go/no-go
        guard and the round sizing (head >= spec_k implies r >= 1)."""
        return self.max_len - max(self._slot_req[s].cache_len for s in decoding)

    def _use_spec_round(self, head: int) -> bool:
        """Rounds need all-greedy traffic and spec_k positions of headroom
        on every decoding slot: the rounds' block writes are unchecked
        (a check would read the lengths back every step), so the guard
        lives here."""
        return self._sample_mode() == "greedy" and head >= self.spec_k

    def _spec_rounds_for(self, decoding: List[int], head: int) -> int:
        """Rounds in one dispatch: bounded by headroom (a round writes
        spec_k positions), the smallest budget left (a round emits >= 1),
        a cap of 2 while requests queue, a prefill is chunking or an EOS
        could end a request mid-block; a power of two."""
        reqs = [self._slot_req[s] for s in decoding]
        r = min(4, head // self.spec_k)
        if any(q.eos_token is not None or q.stop_sequences for q in reqs):
            r = min(r, 2)
        if self._queue or self._chunking is not None:
            r = min(r, 2)
        budget = min(q.max_new_tokens - len(q.tokens) for q in reqs)
        r = max(min(r, budget), 1)
        return 1 << (r.bit_length() - 1)

    def _draft_sync(self) -> None:
        """Append the tick's input tokens to the draft cache (frozen slots
        do not advance), so plain ticks keep the draft aligned."""
        old = self.draft_cache["lengths"]
        _, self.draft_cache = decode._decode_block_step(
            self._draft_local, self.cur_tokens[:, None], self.draft_cache,
            self.draft_config, check=False, par=self._draft_par)
        self.draft_cache["lengths"] = torch.where(self.active, self.draft_cache["lengths"], old)

    def _spec_step(self, decoding: List[int], head: int) -> int:
        """Advance every greedy decoding slot r fused speculative rounds
        (up to r * spec_k tokens each) with one host sync."""
        t0 = time.monotonic()
        r = self._spec_rounds_for(decoding, head)
        emits, accs, lps = (x.tolist() for x in self._spec_block(r))
        self._ticks += r
        self._decode_time += time.monotonic() - t0
        self._spec_rounds += r
        for slot in decoding:
            req = self._slot_req[slot]
            if req is None:
                continue
            for ri in range(r):
                if req.done:
                    break  # later fused rounds of a finished slot: junk
                self._spec_slot_rounds += 1
                n = accs[ri][slot] + 1
                emitted = 0
                for j in range(n):
                    if req.done:
                        break  # EOS/stop mid-round: the rest is dropped
                    req.cache_len += 1
                    self._emit(slot, int(emits[ri][slot][j]), float(lps[ri][slot][j]))
                    emitted += 1
                # only drafts that became output count toward acceptance
                self._spec_accepted += min(emitted, accs[ri][slot])
        return len(decoding)

    # -- public API --------------------------------------------------------

    def register_adapter(self, adapters: Dict, alpha=None) -> int:
        """Register a LoRA adapter tree (models/lora.py `lora_init` layout:
        {"layers": [{name: {"a": [in, r], "b": [r, out]}}]}) for
        per-request selection; returns its id (0 is always the base
        model). The alpha/r scale folds into b, and every adapter joins
        per-target stacks ([N+1, ...], row 0 zeros) that ride the shared
        tick: per-request adapters with no per-request weights.

        All registered adapters must share rank and target set (the stacks
        are rectangular). Registration rebuilds the stacks; register
        adapters before opening traffic, not per request. Refused under a
        mesh (NotImplementedError) and on an int8 weight tree (ValueError)."""
        if self.mesh is not None:
            raise NotImplementedError("LoRA adapters under a mesh are not ported to "
                                      "kubedl_tpu_torch yet (ROADMAP.md 12d)")
        layers = adapters["layers"]
        base = self.params["layers"]
        if len(layers) != len(base):
            raise ValueError(f"adapter has {len(layers)} layers, model has {len(base)}")
        meta = tuple(tuple(sorted(entry)) for entry in layers)
        ranks = {ab["a"].shape[1] for entry in layers for ab in entry.values()}
        if len(ranks) != 1:
            raise ValueError(f"mixed ranks within adapter: {sorted(ranks)}")
        rank = ranks.pop()
        # dimension check against this model's weights: a wrong-width
        # checkpoint would otherwise register and fail later inside the
        # serve pump's prefill, for every client
        for li, entry in enumerate(layers):
            for name, ab in entry.items():
                w = base[li].get(name)
                if w is None:
                    raise ValueError(f"adapter targets {name!r} but layer {li} has no "
                                     f"such projection")
                if is_quantized(w):
                    raise ValueError(
                        f"adapter {name!r} at layer {li} targets an int8 weight "
                        f"(quant.quantize_params): LoRA adapters serve on "
                        f"unquantized weights only")
                if (ab["a"].shape[0], ab["b"].shape[1]) != (w.shape[0], w.shape[1]):
                    raise ValueError(
                        f"adapter {name!r} at layer {li} is "
                        f"{ab['a'].shape[0]}x{ab['b'].shape[1]}, model "
                        f"weight is {w.shape[0]}x{w.shape[1]} — wrong "
                        f"checkpoint/model pairing")
        if self._adapter_meta is not None and self._adapter_meta != (rank, meta):
            raise ValueError(
                "adapter rank/targets differ from already-registered "
                "adapters — stacks must be rectangular (serve mixed "
                "shapes from separate engines)")
        if len(self._adapter_rows) >= self.max_adapters:
            raise ValueError(f"adapter registry full ({self.max_adapters})")
        scale = (float(alpha) if alpha is not None else float(rank)) / rank
        row = [{name: {"a": torch.as_tensor(ab["a"]).detach().float().cpu(),
                       "b": torch.as_tensor(ab["b"]).detach().float().cpu() * scale}
                for name, ab in entry.items()}
               for entry in layers]
        # build the new stacks whole before committing any state, so a
        # failure leaves the registry and the stacks consistent; they are
        # stored in the model dtype (_proj's cast is then a no-op)
        rows = self._adapter_rows + [row]
        stacked = []
        for li, entry in enumerate(layers):
            out = {}
            for name in entry:
                out[name] = {
                    part: torch.stack(
                        [torch.zeros_like(rows[0][li][name][part])]
                        + [r[li][name][part] for r in rows]
                    ).to(dtype=self.config.dtype, device=self.device)
                    for part in ("a", "b")}
            stacked.append(out)
        self._adapter_rows = rows
        self._adapter_meta = (rank, meta)
        self.lora = {"layers": stacked}
        return len(self._adapter_rows)

    def register_prefix(self, tokens) -> int:
        """Prefill a shared prompt prefix (a system prompt) once: requests
        submitted with the returned id prefill only their suffix, appended
        to a copy of this cache. Each prefix holds a batch-1 [max_len]
        cache on the device; register a handful."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if self.ring:
            # the suffix append runs block steps, which a ring cannot take
            raise ValueError("prefix caching is unsupported with ring "
                             "(sliding-window) caches")
        if tokens.size == 0:
            raise ValueError("empty prefix")
        if tokens.size >= self.max_len:
            raise ValueError(f"prefix of {tokens.size} tokens leaves no room in "
                             f"max_len {self.max_len}")
        with self._prefix_lock:
            if len(self._prefixes) >= self.max_prefixes:
                raise ValueError(f"prefix registry full ({self.max_prefixes}); "
                                 f"unregister_prefix one first")
        # the prefill runs outside the lock
        cache = self._new_cache(1, self.max_len, uniform=True)
        _, cache = decode._prefill(self._local, torch.from_numpy(tokens[None]).to(self.device),
                                   cache, self.config, None, self._par)
        with self._prefix_lock:
            if len(self._prefixes) >= self.max_prefixes:
                raise ValueError(f"prefix registry full ({self.max_prefixes}); "
                                 f"unregister_prefix one first")
            pid = self._next_prefix_id
            self._next_prefix_id += 1
            self._prefixes[pid] = (cache, int(tokens.size))
        return pid

    def unregister_prefix(self, prefix_id: int) -> None:
        """Release a prefix's cache. Queued requests still naming it fail
        at admission (no tokens, done)."""
        with self._prefix_lock:
            self._prefixes.pop(prefix_id, None)

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
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        stop_seqs = validate_sampling(
            temperature, top_k, top_p, self.max_top_k, stop)
        if not 0 <= adapter_id <= len(self._adapter_rows):
            raise ValueError(
                f"unknown adapter_id {adapter_id} "
                f"({len(self._adapter_rows)} registered; 0 = base)")
        if adapter_id and prefix_id is not None:
            # a shared prefix's K/V was computed with base projections;
            # reusing it under an adapter would silently mix models
            raise ValueError("adapter_id cannot combine with prefix_id "
                             "(prefix K/V is base-model state)")
        if self._spec and prefix_id is not None:
            # the draft has no prefix cache; a cold draft would floor acceptance
            raise ValueError("prefix caching is unsupported with speculative serving")
        if prompt.size == 0:
            raise ValueError("empty prompt (with a prefix, pass at least the first "
                             "suffix token)")
        prefix_len = 0
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            prefix_len = self._prefixes[prefix_id][1]
        if prefix_len + prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix {prefix_len} + prompt {prompt.size} + {max_new_tokens} new "
                f"tokens exceeds max_len {self.max_len}")
        chunk_eligible = self._chunk_eligible(prompt.size)
        if prefix_id is None and prompt.size > self.prompt_buckets[-1] and not chunk_eligible:
            # rejected here, not when _admit pops it; the chunked path needs
            # no bucket, so it lifts this cap (max_len still bounds it)
            hint = ""
            if self.prefill_chunk > 0 and not self.ring:
                blocks = -(-int(prompt.size) // self.prefill_chunk)
                if blocks * self.prefill_chunk > self.max_len:
                    hint = (f" (chunked prefill would pad to "
                            f"{blocks * self.prefill_chunk} cache positions, past "
                            f"max_len {self.max_len} — raise max_len to a multiple "
                            f"of prefill_chunk {self.prefill_chunk})")
            raise ValueError(f"prompt of {prompt.size} tokens exceeds the largest "
                             f"prompt bucket {self.prompt_buckets[-1]}{hint}")
        req = Request(self._next_id, prompt, max_new_tokens, eos_token,
                      prefix_id=prefix_id,
                      temperature=(self.temperature if temperature is None
                                   else float(temperature)),
                      top_k=int(top_k), top_p=float(top_p),
                      logprobs=bool(logprobs), stop_sequences=tuple(stop_seqs),
                      adapter_id=int(adapter_id))
        self._next_id += 1
        self._queue.append(req)
        return req

    def _suffix_prefill(self, prefix_id: int, suffix: np.ndarray):
        """Append the suffix to a copy of the prefix's cache in one block
        step: (last-token logits, row cache). The block step writes in
        place, so the copy is what keeps the registered cache unchanged."""
        cache = decode.clone_cache(self._prefixes[prefix_id][0])
        hidden, cache = self._append_block(suffix, cache)
        return self._head(hidden[:, -1]), cache

    def _admit(self) -> None:
        """Pop every request a free slot can take: prefix requests append
        their suffix, a prompt past the largest bucket starts the chunker,
        the rest prefill as a wave in bucket clusters; one host sync
        fetches every first token."""
        t0 = time.monotonic()
        wave = []  # (slot, first token, its logprob, cluster key)
        batch: List[Request] = []
        batch_slots: List[int] = []
        deferred: List[Request] = []  # long prompts waiting for the chunker
        while self._queue and None in self._slot_req:
            req = self._queue.popleft()
            slot = self._slot_req.index(None)
            if req.prefix_id is not None:
                entry = self._prefixes.get(req.prefix_id)
                if entry is None:  # unregistered while queued
                    req.done = True
                    continue
                t = len(req.prompt) + entry[1]
                logits, row_cache = self._suffix_prefill(req.prefix_id, req.prompt)
                first, first_lp = self._sample_first(logits, req)
                self._insert(row_cache, 0, slot, t, first[0])
                self._claim_slot(slot, req, t)
                wave.append((slot, first[0], first_lp[0], f"prefix:{req.request_id}"))
            elif self._chunk_eligible(len(req.prompt)):
                if self._chunking is not None:
                    # one chunked prefill at a time; shorter requests behind
                    # it may still admit
                    deferred.append(req)
                    continue
                self._slot_req[slot] = req  # claimed; decode skips it
                self._chunking = {"req": req, "slot": slot, "pos": 0,
                                  "cache": self._new_cache(1, self.max_len, uniform=True)}
            else:
                batch.append(req)
                batch_slots.append(slot)
                self._slot_req[slot] = req  # claim so .index(None) advances
        for req in reversed(deferred):
            self._queue.appendleft(req)
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
            self.cache = self._new_cache(self.slots, self.max_len, ring=self.ring)
            self.cur_tokens = torch.zeros((self.slots,), dtype=torch.int32,
                                          device=self.device)
            self.active = torch.zeros((self.slots,), dtype=torch.bool,
                                      device=self.device)
            self._chunking = None

    def _sample_first(self, logits, req: Request):
        """First token and its logprob ([1] each) for one request's [1, V]
        logits: the tail of the batch-1 admissions (prefix, chunked)."""
        dev = self.device
        mode = ("filtered" if req.needs_filter
                else ("plain" if req.temperature > 0 else "greedy"))
        first = sample_tokens(
            logits, self.generator,
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            mode, self.max_top_k)
        return first, chosen_logprob(logits, first)

    def _claim_slot(self, slot: int, req: Request, cache_len: int) -> None:
        self.samp_temps[slot] = req.temperature
        self.samp_topk[slot] = req.top_k
        self.samp_topp[slot] = req.top_p
        self.slot_adapter[slot] = req.adapter_id
        self._slot_req[slot] = req
        self._admitted += 1
        req.cache_len = cache_len

    def _chunk_eligible(self, prompt_len: int) -> bool:
        """Chunked prefill takes only the prompts the wave cannot (past the
        largest bucket), and only when every padded chunk fits the cache:
        the last chunk writes ceil(len/chunk)*chunk positions, and past
        max_len the clamped write would overwrite earlier positions. A
        misaligned prompt falls back to the wave if a bucket fits it and is
        rejected at submit otherwise. Ring caches take no block steps.
        Both submit and _admit route by this one predicate."""
        if self.prefill_chunk <= 0 or self.ring:
            return False
        if prompt_len <= self.prompt_buckets[-1]:
            return False  # the wave admits it in one batched prefill
        blocks = -(-prompt_len // self.prefill_chunk)
        return blocks * self.prefill_chunk <= self.max_len

    def _advance_chunk(self) -> None:
        """One prefill_chunk block step of the chunked prefill in flight; on
        the last chunk, sample the first token and splice the row into the
        live batch. A chunk that raises fails its request and frees the
        slot and the chunker."""
        st = self._chunking
        if st is None:
            return
        try:
            self._advance_chunk_inner(st)
        except Exception as e:  # noqa: BLE001 — must not wedge the chunker
            _log.exception("chunked prefill failed (slot=%d)", st["slot"])
            self._fail(st["slot"], st["req"], f"chunked prefill failed: {e}")
            self._chunking = None

    def _advance_chunk_inner(self, st: Dict) -> None:
        t0 = time.monotonic()
        req: Request = st["req"]
        c = self.prefill_chunk
        prompt = req.prompt
        t = len(prompt)
        pos = st["pos"]
        toks = prompt[pos:pos + c]
        tail = len(toks)
        if tail < c:
            # one chunk shape; the pad positions' K/V lie past the length
            # the splice sets, so nothing attends them
            toks = np.pad(toks, (0, c - tail))
        hidden, st["cache"] = self._append_block(toks, st["cache"], req.adapter_id)
        st["pos"] = pos + c
        if st["pos"] < t:
            self._prefill_time += time.monotonic() - t0
            return
        first, first_lp = self._sample_first(self._head(hidden[:, tail - 1]), req)
        slot = st["slot"]
        self._insert(st["cache"], 0, slot, t, first[0])
        if self._spec:
            # the draft's state for the long prompt in one prefill, its
            # width a power of two
            t_pad = min(1 << (t - 1).bit_length(), self.max_len)
            padded = np.zeros((1, t_pad), np.int32)
            padded[0, :t] = prompt
            _, d_rows = self._prefill_rows(self._draft_local, self.draft_config, padded,
                                           np.array([t], np.int32), self._draft_par)
            self._splice(self.draft_cache, d_rows, 0, slot, t)
        self._claim_slot(slot, req, t)
        self._chunking = None
        self._chunked_prefills += 1
        tok, lp = _to_host((first, first_lp))
        self._emit(slot, int(tok[0]), float(lp[0]))
        self._prefill_time += time.monotonic() - t0

    def _decoding(self) -> List[int]:
        """Slots whose request is in the decode batch (not the slot of a
        prompt still chunk-prefilling)."""
        busy = self._chunking["slot"] if self._chunking else -1
        return [s for s, r in enumerate(self._slot_req) if r is not None and s != busy]

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
        that are never inserted. A speculative engine prefills the draft on
        the same wave and splices its rows beside the target's."""
        k = len(reqs)
        k_pad = 1 << (k - 1).bit_length()
        padded = np.zeros((k_pad, bucket), np.int32)
        lengths = np.ones((k_pad,), np.int32)
        temps = np.zeros((k_pad,), np.float32)
        topks = np.zeros((k_pad,), np.int32)
        topps = np.ones((k_pad,), np.float32)
        adapters = np.zeros((k_pad,), np.int32)
        for i, r in enumerate(reqs):
            t = len(r.prompt)
            padded[i, :t] = r.prompt
            lengths[i] = t
            adapters[i] = r.adapter_id
            temps[i] = r.temperature
            topks[i] = r.top_k
            topps[i] = r.top_p
        dev = self.device
        logits, rows = self._prefill_rows(self._local, self.config, padded, lengths,
                                          self._par, adapters)
        self._prefill_batches += 1
        d_rows = None
        if self._spec:
            _, d_rows = self._prefill_rows(self._draft_local, self.draft_config, padded,
                                           lengths, self._draft_par)
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
            if d_rows is not None:
                self._splice(self.draft_cache, d_rows, i, slot, int(lengths[i]))
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
        """Drop a request: dequeue it if waiting, or free its slot (and the
        chunker, mid-prefill). A no-op on finished requests."""
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
                if self._chunking is not None and self._chunking["req"] is req:
                    self._chunking = None
                return

    def step(self) -> int:
        """Admit waiting requests, advance the chunked prefill in flight one
        chunk, then every decoding slot one token (or one speculative
        round). Returns the number of decoding slots."""
        self._admit()
        self._advance_chunk()
        return self._step_inner()

    def _step_inner(self) -> int:
        """One tick after admission and chunk work, shared by step() and
        step_block()'s fallbacks (which must not advance the chunker
        again)."""
        decoding = self._decoding()
        if not decoding:
            return 0
        if self._spec:
            head = self._spec_head(decoding)
            if self._use_spec_round(head):
                return self._spec_step(decoding, head)
        t0 = time.monotonic()
        if self._spec:
            # the draft must see the tokens the target sees, or speculation
            # resumes out of step after this tick
            self._draft_sync()
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
        queue, a prefill is chunking or an EOS/stop is possible; sizes are
        powers of two and the overshoot past a budget is trimmed on the
        host. Degenerates to one tick when the block would be 1. A
        speculative engine runs a round block instead (or, on sampled
        traffic, single ticks, which keep the draft in step)."""
        self._admit()
        self._advance_chunk()
        decoding = self._decoding()
        reqs = [self._slot_req[s] for s in decoding]
        if not reqs:
            return 0
        if self._spec:
            head = self._spec_head(decoding)
            if self._use_spec_round(head):
                return self._spec_step(decoding, head)
            return self._step_inner()
        k = min(r.max_new_tokens - len(r.tokens) for r in reqs)
        k = min(k, max_block)
        if any(r.eos_token is not None or r.stop_sequences for r in reqs):
            k = min(k, 8)  # post-EOS/stop ticks are pure waste; stay short
        elif self._queue or self._chunking is not None:
            # a slot freed mid-block cannot admit, and the chunker advances
            # only between blocks
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
        out = {
            "slots": self.slots,
            "slots_busy": busy,
            "queue_depth": len(self._queue),
            "admitted": self._admitted,
            "ticks": self._ticks,
            "tokens_out": self._tokens_out,
            "tokens_per_sec": self._tokens_out / wall,
            "slot_utilization": busy / self.slots,
            "prefixes_registered": len(self._prefixes),
            "adapters_registered": len(self._adapter_rows),
            "prefill_time_s": round(self._prefill_time, 4),
            "decode_time_s": round(self._decode_time, 4),
            "prefill_batches": self._prefill_batches,
            "chunked_prefills": self._chunked_prefills,
            "wave_failures": self._wave_failures,
            "wave_resets": self._wave_resets,
            "kv_cache_bytes": decode.cache_bytes(self.cache),
        }
        if self._spec:
            # accepted drafts per (round, decoding slot) over the cap k-1
            out["spec_rounds"] = self._spec_rounds
            out["spec_acceptance"] = round(
                self._spec_accepted / max(self._spec_slot_rounds * (self.spec_k - 1), 1), 4)
        return out
