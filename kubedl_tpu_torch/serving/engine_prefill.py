"""PrefillEngine -- prompt ingestion with NO decode ticks in its path (the
port's copy of kubedl_tpu/serving/engine_prefill.py).

The monolithic engine runs prefill and decode on one thread over one
cache, so a burst of long prompts freezes every in-flight stream between
ticks. This engine owns prefill alone: bucketed wave batches (the
clustering of the monolithic `_admit_batch`), chunked block appends for
prompts past the largest bucket, and suffix appends over a shared-prefix
scratch. Output is a `HandoffItem` per request -- KV rows plus the
sampled first token -- which a decode engine admits by reference (same
process) or after a serialized hop (cross-pod).

The wave path is `decode.prefill`, whose attention is the flash forward
kernel (K1) on a CUDA tensor. It pads prompts to the same buckets, pads
the batch to the same power of two, and samples first tokens through the
same `sample_tokens` draw from the caller's generator as the monolithic
engine (models/serving.py), so a facade driving both stacks with the same
seed gets the same tokens, greedy AND sampled. The chunked and suffix
paths are block steps over a cache (plain torch attention, as in the
reference).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.models import decode
from kubedl_tpu_torch.models.llama import LlamaConfig, _lm_head
from kubedl_tpu_torch.models.serving import Request, chosen_logprob, sample_tokens

SUFFIX_CHUNK = 16  # block size for prefix-suffix appends (engine parity)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def sample_mode(reqs: List[Request]) -> str:
    """The sampler mode these requests need (models/serving.py
    `sample_tokens`)."""
    if any(r.needs_filter for r in reqs):
        return "filtered"
    if any(r.temperature > 0 for r in reqs):
        return "plain"
    return "greedy"


class PrefillEngine:
    """Prefill half of the disaggregated plane (one model on the device its
    parameters lie on)."""

    def __init__(
        self,
        params: Dict,
        config: LlamaConfig,
        max_len: int = 1024,
        prompt_buckets: Optional[List[int]] = None,
        prefill_chunk: int = 256,
        max_top_k: int = 64,
    ) -> None:
        self.params = params
        self.config = config
        self.device = params["embed"].device
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
                f"max_len {max_len}")
        self.prefill_chunk = int(prefill_chunk)
        self.max_top_k = max_top_k
        self._prefills = 0
        self._chunked_prefills = 0
        self._prefill_time = 0.0

    def _append(self, toks: np.ndarray, cache: Dict):
        """A block step of a uniform batch-1 cache, in place: (hidden rows
        [1, T, d], cache)."""
        t = torch.from_numpy(np.ascontiguousarray(toks, np.int32)[None]).to(self.device)
        return decode.decode_block_step(self.params, t, cache, self.config,
                                        check=False, return_hidden=True)

    def _head(self, hidden, tail: int):
        """Logits [1, V] of ONE row (the last real token): a full [T, vocab]
        head matmul would dominate every chunk."""
        return _lm_head(hidden[:, tail - 1:tail], self.params, self.config)[:, 0]

    def sample_first(self, logits, req: Request, generator):
        """First-token sample (+ model logprob) for one request's [1, V]
        logits: the monolithic engine's `_sample_first`. Returns ([1], [1])
        device tensors."""
        dev = self.device
        first = sample_tokens(
            logits, generator,
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            sample_mode([req]), self.max_top_k)
        return first, chosen_logprob(logits, first)

    # -- wave (bucketed batch) prefill ------------------------------------

    def prefill_group(self, reqs: List[Request], bucket: int, generator):
        """One prefill forward for a same-bucket cluster; returns
        (firsts, lps, rows_cache, lengths) with the monolithic engine's
        exact padding: rows to `bucket`, batch to the next power of two
        (dummy length-1 rows never leave the device). One sample draw
        from `generator` for the cluster."""
        t0 = time.monotonic()
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
        # scratch capacity = the padded prompt width: prefill writes
        # positions [0, t) only, and the handoff slices exactly the rows
        # it needs
        scratch = decode.init_kv_cache(self.config, k_pad, bucket, device=dev)
        logits, rows = decode.prefill(
            self.params, torch.from_numpy(padded).to(dev), scratch, self.config,
            lengths=torch.from_numpy(lengths).to(dev))
        firsts = sample_tokens(
            logits, generator, torch.from_numpy(temps).to(dev),
            torch.from_numpy(topks).to(dev), torch.from_numpy(topps).to(dev),
            sample_mode(reqs), self.max_top_k)
        lps = chosen_logprob(logits, firsts)
        self._prefills += len(reqs)
        self._prefill_time += time.monotonic() - t0
        return firsts, lps, rows, lengths

    @staticmethod
    def extract_rows(rows: Dict, i: int, t_pad: int):
        """Row i of a wave cache as pool-layout [t_pad, h, d] per layer
        (views of the wave cache)."""
        out_k = [k[i, :, :t_pad].transpose(0, 1) for k in rows["k"]]
        out_v = [v[i, :, :t_pad].transpose(0, 1) for v in rows["v"]]
        return out_k, out_v

    # -- chunked prefill (prompts past the largest bucket) ----------------

    def prefill_chunked(self, req: Request, generator) -> Tuple:
        """All chunks back to back -- this engine has no decode ticks to
        interleave with, that is the point of the split. Returns
        (first_token_dev, first_lp_dev, rows_k, rows_v, t, t_pad)."""
        t0 = time.monotonic()
        c = self.prefill_chunk
        prompt = np.asarray(req.prompt, np.int32)
        t = len(prompt)
        blocks = -(-t // c)
        cap = blocks * c
        if cap > self.max_len:
            raise ValueError(
                f"chunked prefill of {t} tokens pads to {cap} positions, "
                f"past max_len {self.max_len}")
        cache = decode.init_kv_cache(self.config, 1, cap, uniform=True,
                                     device=self.device)
        hidden = None
        tail = c
        for pos in range(0, t, c):
            toks = prompt[pos:pos + c]
            tail = len(toks)
            if tail < c:
                # pad to the ONE chunk shape; pad K/V past the real
                # length is masked by the ragged attend and never
                # extracted into the handoff
                toks = np.pad(toks, (0, c - tail))
            hidden, cache = self._append(toks, cache)
        logits = self._head(hidden, tail)
        first, first_lp = self.sample_first(logits, req, generator)
        t_pad = min(_pow2(t), cap)
        if t_pad < t:
            t_pad = cap
        rows_k, rows_v = self.extract_rows(cache, 0, t_pad)
        self._chunked_prefills += 1
        self._prefill_time += time.monotonic() - t0
        return first[0], first_lp[0], rows_k, rows_v, t, t_pad

    # -- suffix append over a shared-prefix scratch -----------------------

    def prefill_suffix(self, scratch_cache: Dict, suffix: np.ndarray,
                       req: Request, generator) -> Tuple:
        """Append `suffix` to a scratch cache already holding the shared
        prefix (lengths = prefix rows); fixed SUFFIX_CHUNK block steps.
        Returns (first, first_lp, cache_with_suffix, total_len)."""
        t0 = time.monotonic()
        start = int(scratch_cache["lengths"])
        hidden = None
        for i in range(0, len(suffix), SUFFIX_CHUNK):
            hidden, scratch_cache = self._append(suffix[i:i + SUFFIX_CHUNK],
                                                 scratch_cache)
        logits = self._head(hidden, hidden.shape[1])
        first, first_lp = self.sample_first(logits, req, generator)
        self._prefills += 1
        self._prefill_time += time.monotonic() - t0
        return first[0], first_lp[0], scratch_cache, start + len(suffix)

    def stats(self) -> Dict:
        return {
            "prefills": self._prefills,
            "chunked_prefills": self._chunked_prefills,
            "prefill_time_s": round(self._prefill_time, 4),
        }
