"""KV-cache autoregressive decoding (kubedl_tpu/models/decode.py).

Caches are dicts: ``k`` and ``v`` are lists of per-layer
[b, kv_heads, max_len, head_dim] buffers in the model dtype, ``lengths``
is one scalar (a uniform batch) or [b] (ragged, right-padded rows). The
one-pass `prefill` runs the whole prompt through one forward whose
attention is the flash kernel; decode steps attend over the cache with the
plain masked product of `_attend_cached`, as the JAX package does (it has
no kernel there either). MoE layers route each step's tokens through the
grouped matmul kernels (models/moe.py); int8 weight trees (models/quant.py)
run through every entry point.

Unlike the JAX functions, which return new arrays, these write K/V into the
given cache's buffers in place (a copy per token would double the cache
traffic) and return a dict that shares them. Write offsets are clamped to
the buffer, as JAX's dynamic_update_slice clamps them, so an overflowing
write lands on the last rows instead of faulting; the ``check`` guards
raise first unless a caller that sized the cache itself turns them off.

Not ported yet: ring caches, int8 KV, speculative and chunked prefill
(ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from kubedl_tpu_torch.models.llama import (
    LlamaConfig,
    _attn_out,
    _embed,
    _lm_head,
    _mlp_block,
    _qkv,
    rms_norm,
)
from kubedl_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from kubedl_tpu_torch.utils.device import resolve_device

NEG_INF = -1e30


def init_kv_cache(
    config: LlamaConfig,
    batch: int,
    max_len: int,
    uniform: bool = False,
    kv_dtype: Optional[str] = None,
    ring: bool = False,
    device="cuda",
) -> Dict:
    """Per-layer K/V buffers (model dtype) + write positions: a scalar
    length when `uniform`, else one length per row."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    if kv_dtype == "int8":
        raise NotImplementedError("int8 KV caches are not ported yet (ROADMAP.md)")
    if ring:
        raise NotImplementedError("ring KV caches are not ported yet (ROADMAP.md)")
    dev = resolve_device(device)
    shape = (batch, config.n_kv_heads, max_len, config.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=config.dtype, device=dev)
              for _ in range(config.n_layers)],
        "v": [torch.zeros(shape, dtype=config.dtype, device=dev)
              for _ in range(config.n_layers)],
        "lengths": torch.zeros((() if uniform else (batch,)), dtype=torch.int32,
                               device=dev),
    }


def _attend_cached(q, ck, cv, limits, n_rep, window=None, softcap=None):
    """q [b, hq, tq, d] against cache [b, hkv, L, d]: query t of row i sees
    cache positions < its limit (`limits` [b] with tq == 1, or [b, tq]) and,
    with a window, >= limit - window. Queries are grouped under their KV
    head, so the cache is read at hkv heads. Scores and the output are f32
    on operands in the model dtype, as the JAX einsums with
    preferred_element_type=f32 compute them. (The JAX function also
    narrows the cache read to the window; that changes only which
    already-masked positions are read.)"""
    b, hq, tq, d = q.shape
    hkv, L = ck.shape[1], ck.shape[2]
    lim = limits[:, None] if limits.dim() == 1 else limits  # [b, tq]
    k_pos = torch.arange(L, device=q.device)
    qg = q.reshape(b, hkv, n_rep, tq, d).float()
    s = torch.einsum("bhgtd,bhkd->bhgtk", qg, ck.float()) / math.sqrt(d)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    limb = lim[:, None, None, :, None]
    attend = k_pos < limb
    if window is not None:
        attend &= k_pos >= limb - window
    s = s.masked_fill(~attend, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    out = torch.einsum("bhgtk,bhkd->bhgtd", p, cv.float())
    return out.reshape(b, hq, tq, d)


def _write(buf, new, positions):
    """buf [b, h, L, d] <- new [b, h, T, d] at per-row positions [b, T]."""
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, :, positions] = new.transpose(1, 2).to(buf.dtype)


def _check_capacity(pos, T: int, max_cap: int) -> None:
    top = int(pos.max())  # waits for the device
    if top + T > max_cap:
        raise ValueError(
            f"cache holds {top} of {max_cap} positions; appending {T} more "
            f"overflows it — init a larger max_len")


def decode_step(params: Dict, token, cache: Dict, config: LlamaConfig,
                check: bool = True) -> Tuple[torch.Tensor, Dict]:
    """One decode step for token [b]: (logits [b, vocab], cache).

    A uniform cache is decode_block_step's T=1 case; a ragged one writes
    each row at its own length. `check=False` skips the capacity guard
    (it reads the lengths back from the device) for callers that sized
    the cache themselves."""
    c = config
    pos = cache["lengths"]
    if pos.dim() == 0:
        logits, cache = decode_block_step(params, token[:, None], cache, config,
                                          check=check)
        return logits[:, 0], cache
    max_cap = cache["k"][0].shape[2]
    if check:
        _check_capacity(pos, 1, max_cap)
    positions = pos[:, None].to(torch.int32)  # [b, 1]
    wpos = positions.long().clamp(max=max_cap - 1)
    x = _embed(params, token[:, None], c)  # [b, 1, d]
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.rms_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, positions)
        ck, cv = cache["k"][i], cache["v"][i]
        _write(ck, k, wpos)
        _write(cv, v, wpos)
        attn = _attend_cached(q, ck, cv, pos + 1, c.n_heads // c.n_kv_heads,
                              window=c.window_for(i),
                              softcap=c.attn_logit_softcap or None)
        attn = attn.transpose(1, 2).reshape(x.shape[0], 1, c.n_heads * c.head_dim)
        x = _attn_out(x, attn, layer, c)
        x, _ = _mlp_block(x, layer, c)
    out = {"k": cache["k"], "v": cache["v"], "lengths": pos + 1}
    return _lm_head(x, params, c)[:, 0], out


def decode_block_step(params: Dict, tokens, cache: Dict, config: LlamaConfig,
                      check: bool = True) -> Tuple[torch.Tensor, Dict]:
    """T tokens per row [b, T] through the cache in one forward: (logits
    [b, T, vocab], cache advanced by T). Query i sees the cache plus the
    block up to itself. Uniform caches write every row at the one length,
    ragged caches each row at its own."""
    c = config
    b, T = tokens.shape
    pos = cache["lengths"]
    ragged = pos.dim() == 1
    max_cap = cache["k"][0].shape[2]
    if T > max_cap:
        raise ValueError(f"block of {T} tokens exceeds cache max_len {max_cap}")
    if check:
        _check_capacity(pos, T, max_cap)
    steps = torch.arange(T, dtype=torch.int32, device=tokens.device)[None]
    positions = (pos[:, None] if ragged else pos) + steps
    positions = positions.expand(b, T)
    # JAX's dynamic_update_slice clamps the block start into the buffer
    wpos = (positions[:, :1].long().clamp(max=max_cap - T)
            + steps.long())
    limits = positions + 1
    x = _embed(params, tokens, c)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.rms_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, positions)
        ck, cv = cache["k"][i], cache["v"][i]
        _write(ck, k, wpos)
        _write(cv, v, wpos)
        attn = _attend_cached(q, ck, cv, limits, c.n_heads // c.n_kv_heads,
                              window=c.window_for(i),
                              softcap=c.attn_logit_softcap or None)
        attn = attn.transpose(1, 2).reshape(b, T, c.n_heads * c.head_dim)
        x = _attn_out(x, attn, layer, c)
        x, _ = _mlp_block(x, layer, c)
    return _lm_head(x, params, c), {"k": cache["k"], "v": cache["v"],
                                    "lengths": pos + T}


def prefill(params: Dict, tokens, cache: Dict, config: LlamaConfig,
            lengths=None):
    """One full-sequence forward over prompt tokens [b, t] (right-padded
    when ragged), writing K/V positions [0, t) of the cache. Returns
    (logits at each row's last real token [b, vocab], cache). Padding is
    safe under the causal mask: a real query only attends keys at or
    before it, and pad positions are never attended later (per-row
    lengths)."""
    c = config
    b, t = tokens.shape
    uniform = cache["lengths"].dim() == 0
    if uniform:
        if lengths is not None:
            raise ValueError("per-row lengths need a ragged cache: "
                             "init_kv_cache(..., uniform=False)")
    elif lengths is None:
        lengths = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
    attend = flash_attention if c.use_flash else attention_reference
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)[None].expand(b, t)
    x = _embed(params, tokens, c)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.rms_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, positions)
        cache["k"][i][:, :, :t] = k
        cache["v"][i][:, :, :t] = v
        # GQA is handled inside the attention entry points
        attn = attend(q, k, v, causal=True, window=c.window_for(i),
                      softcap=c.attn_logit_softcap or None)
        attn = attn.transpose(1, 2).reshape(b, t, c.n_heads * c.head_dim)
        x = _attn_out(x, attn, layer, c)
        x, _ = _mlp_block(x, layer, c)
    if uniform:
        last = x[:, t - 1]
        new_len = torch.full((), t, dtype=torch.int32, device=tokens.device)
    else:
        last = x[torch.arange(b, device=x.device), lengths.long() - 1]
        new_len = lengths.to(torch.int32)
    # the head runs on the last rows only: row-wise, so the same logits as
    # heading all [b, t] positions and gathering
    logits = _lm_head(last[:, None], params, c)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "lengths": new_len}


def _categorical(logits, generator: Optional[torch.Generator]):
    """One draw per row from softmax(logits) by the Gumbel-max trick
    (-log of an Exp(1) draw is Gumbel); -inf logits are never drawn."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(generator=generator)
    return (logits.float() - torch.log(e)).argmax(dim=-1)


def generate(params: Dict, prompt, config: LlamaConfig, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, lengths=None):
    """Greedy (temperature 0) or sampled continuation [b, max_new_tokens].

    Ragged batches pass right-padded `prompt` plus per-row `lengths`;
    without them the cache is uniform. Sampling draws from `generator`
    (it must live on the prompt's device)."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    if t + max_new_tokens > max_len:
        raise ValueError(f"prompt {t} + {max_new_tokens} new tokens exceeds "
                         f"max_len {max_len}")
    cache = init_kv_cache(config, b, max_len, uniform=lengths is None,
                          device=prompt.device)
    logits, cache = prefill(params, prompt, cache, config, lengths=lengths)
    out = []
    for i in range(max_new_tokens):
        if temperature > 0:
            tok = _categorical(logits / temperature, generator)
        else:
            tok = logits.argmax(dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, tok, cache, config, check=False)
    return torch.stack(out, dim=1)
