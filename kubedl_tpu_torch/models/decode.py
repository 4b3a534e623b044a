"""KV-cache autoregressive decoding (kubedl_tpu/models/decode.py).

Caches are dicts: ``k`` and ``v`` are lists of per-layer
[b, kv_heads, max_len, head_dim] buffers in the model dtype, ``lengths``
is one scalar (a uniform batch) or [b] (ragged, right-padded rows). An
int8 cache (``kv_dtype="int8"``) holds int8 codes in ``k`` and ``v`` and
per-position bf16 scales in ``ks`` and ``vs`` ([b, kv_heads, max_len],
amax/127 over head_dim); the scales fold into the attention products, so
no dequantized cache is made. The one-pass `prefill` runs the whole prompt
through one forward whose attention is the flash kernel on the raw K/V
(only what it writes is quantized); decode steps attend over the cache
with the plain masked product of `_attend_cached`, as the JAX package does
(it has no kernel there either). MoE layers route each step's tokens
through the grouped matmul kernels (models/moe.py); int8 weight trees
(models/quant.py) run through every entry point.

Sharded (`mesh`, `rules`): the tree's leaves are DTensors laid out by
`llama.param_specs`. Every rank runs the whole batch (the token axes
replicate it) on its local views of the leaves, taken once a call (or once
an engine, models/serving.py): its heads, its `mlp` columns and its
vocabulary rows, with any fsdp shards gathered. The cache holds the local
KV heads, one sum over the tensor axis follows `wo` and `w2`, and the
vocabulary shards of the logits are gathered before a token is picked, so
every rank computes the same tokens. MoE layers and int8 weight trees under
a mesh are refused (ROADMAP.md).

Unlike the JAX functions, which return new arrays, these write K/V into the
given cache's buffers in place (a copy per token would double the cache
traffic) and return a dict that shares them. Write offsets are clamped to
the buffer, as JAX's dynamic_update_slice clamps them, so an overflowing
write lands on the last rows instead of faulting; the ``check`` guards
raise first unless a caller that sized the cache itself turns them off.

Not ported yet: ring caches, speculative and chunked prefill (ROADMAP.md).
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
    _local_head,
    _local_layer,
    _mlp_block,
    _Par,
    _qkv,
    rms_norm,
)
from kubedl_tpu_torch.models.quant import _quantize_cols, is_quantized
from kubedl_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from kubedl_tpu_torch.parallel import collectives
from kubedl_tpu_torch.parallel.mesh import ShardingRules, axes_size, live_axes
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
    mesh=None,
    rules: Optional[ShardingRules] = None,
) -> Dict:
    """Per-layer K/V buffers + write positions: a scalar length when
    `uniform`, else one length per row. The buffers are in the model dtype,
    or int8 codes with "ks"/"vs" bf16 scale buffers (ones until written)
    when kv_dtype="int8". With a mesh, a rank's cache holds its
    n_kv_heads / (tensor axis size) local heads."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    if ring:
        raise NotImplementedError("ring KV caches are not ported yet (ROADMAP.md)")
    dev = resolve_device(device)
    n_tp = 1 if mesh is None else axes_size(
        mesh, live_axes(mesh, (rules or ShardingRules()).axes("heads")))
    shape = (batch, config.n_kv_heads // n_tp, max_len, config.head_dim)
    store = torch.int8 if kv_dtype == "int8" else config.dtype
    cache = {
        "k": [torch.zeros(shape, dtype=store, device=dev) for _ in range(config.n_layers)],
        "v": [torch.zeros(shape, dtype=store, device=dev) for _ in range(config.n_layers)],
        "lengths": torch.zeros((() if uniform else (batch,)), dtype=torch.int32,
                               device=dev),
    }
    if kv_dtype == "int8":
        for name in ("ks", "vs"):
            cache[name] = [torch.ones(shape[:3], dtype=torch.bfloat16, device=dev)
                           for _ in range(config.n_layers)]
    return cache


def cache_bytes(cache: Dict) -> int:
    """Bytes of a cache's K/V buffers and scales (this rank's, with a mesh)."""
    return sum(t.numel() * t.element_size()
               for name in ("k", "v", "ks", "vs") for t in cache.get(name, ()))


def _quantize_kv(x):
    """[b, h, t, d] -> (int8 codes, [b, h, t] bf16 scales), amax/127 over d;
    the scale is rounded to bf16 before the codes are computed, as
    quant.quantize does, and is 1 for an all-zero row."""
    leaf = _quantize_cols(x.float(), -1)
    return leaf["q"], leaf["s"]


def _attend_cached(q, ck, cv, limits, n_rep, k_scale=None, v_scale=None,
                   window=None, softcap=None):
    """q [b, hq, tq, d] against cache [b, hkv, L, d]: query t of row i sees
    cache positions < its limit (`limits` [b] with tq == 1, or [b, tq]) and,
    with a window, >= limit - window. Queries are grouped under their KV
    head, so the cache is read at hkv heads. Scores and the output are f32
    on operands in the model dtype, as the JAX einsums with
    preferred_element_type=f32 compute them. An int8 cache passes its
    scales [b, hkv, L]: the K scale multiplies the scores, the V scale the
    softmax weights before they are rounded to the compute dtype. (The JAX
    function also narrows the cache read to the window; that changes only
    which already-masked positions are read.)"""
    b, hq, tq, d = q.shape
    hkv, L = ck.shape[1], ck.shape[2]
    lim = limits[:, None] if limits.dim() == 1 else limits  # [b, tq]
    k_pos = torch.arange(L, device=q.device)
    qg = q.reshape(b, hkv, n_rep, tq, d).float()
    s = torch.einsum("bhgtd,bhkd->bhgtk", qg, ck.float())
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, None, :]
    s = s / math.sqrt(d)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    limb = lim[:, None, None, :, None]
    attend = k_pos < limb
    if window is not None:
        attend &= k_pos >= limb - window
    s = s.masked_fill(~attend, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, None, :]
    out = torch.einsum("bhgtk,bhkd->bhgtd", p.to(q.dtype).float(), cv.float())
    return out.reshape(b, hq, tq, d)


def _write(buf, new, positions):
    """buf [b, h, L(, d)] <- new [b, h, T(, d)] at per-row positions [b, T]."""
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, :, positions] = new.transpose(1, 2).to(buf.dtype)


def _store(cache: Dict, i: int, k, v, put):
    """Layer i's new k, v through `put(buffer, new)`: as they are, or as
    int8 codes and their scales. Returns the layer's (k_scale, v_scale)
    buffers, None for a model-dtype cache."""
    if "ks" not in cache:
        put(cache["k"][i], k)
        put(cache["v"][i], v)
        return None, None
    codes, scales = _quantize_kv(torch.stack((k, v)))  # one pass for both
    for j, name in enumerate(("k", "v")):
        put(cache[name][i], codes[j])
        put(cache[name + "s"][i], scales[j])
    return cache["ks"][i], cache["vs"][i]


def _check_capacity(pos, T: int, max_cap: int) -> None:
    top = int(pos.max())  # waits for the device
    if top + T > max_cap:
        raise ValueError(
            f"cache holds {top} of {max_cap} positions; appending {T} more "
            f"overflows it — init a larger max_len")


def _mesh_context(params: Dict, config: LlamaConfig, mesh, rules=None):
    """(the tree a decode computes on, its _Par): the params and None
    without a mesh; with one, every leaf's local view, taken here once."""
    if mesh is None:
        return params, None
    if config.n_experts > 0:
        raise NotImplementedError(
            "MoE layers under a mesh in decode are not ported to kubedl_tpu_torch "
            "yet (ROADMAP.md)")
    if any(is_quantized(w) for w in params["layers"][0].values()) \
            or is_quantized(params.get("lm_head")):
        raise NotImplementedError(
            "int8 weight trees (quant.quantize_params) under a mesh are not "
            "ported to kubedl_tpu_torch yet (ROADMAP.md)")
    par = _Par(mesh, rules or ShardingRules(), config)
    local = dict(_local_head(params, par))
    local.setdefault("embed", par.view(params["embed"], "vocab", None))
    local["layers"] = [_local_layer(layer, par) for layer in params["layers"]]
    return local, par


def _full_logits(logits, par: Optional[_Par]):
    """Logits over the whole vocabulary: the vocabulary shards gathered over
    the tensor axis (the last dim), the same on every rank."""
    if par is None or par.n_tp == 1:
        return logits
    return collectives.all_gather(logits.movedim(-1, 0), par.mesh, par.tp).movedim(0, -1)


def decode_step(params: Dict, token, cache: Dict, config: LlamaConfig,
                check: bool = True, mesh=None, rules=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step for token [b]: (logits [b, vocab], cache), the T=1
    case of decode_block_step: a uniform cache writes every row at the one
    length, a ragged one each row at its own. `check=False` skips the
    capacity guard (it reads the lengths back from the device) for callers
    that sized the cache themselves."""
    local, par = _mesh_context(params, config, mesh, rules)
    logits, cache = _decode_block_step(local, token[:, None], cache, config, check, par)
    return logits[:, 0], cache


def decode_block_step(params: Dict, tokens, cache: Dict, config: LlamaConfig,
                      check: bool = True, mesh=None, rules=None
                      ) -> Tuple[torch.Tensor, Dict]:
    """T tokens per row [b, T] through the cache in one forward: (logits
    [b, T, vocab], cache advanced by T). Query i sees the cache plus the
    block up to itself. Uniform caches write every row at the one length,
    ragged caches each row at its own."""
    local, par = _mesh_context(params, config, mesh, rules)
    return _decode_block_step(local, tokens, cache, config, check, par)


def _decode_block_step(params, tokens, cache, config, check=True, par=None):
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

    def put(buf, new):
        _write(buf, new, wpos)

    x = _embed(params, tokens, c, par)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.rms_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, positions)
        ks, vs = _store(cache, i, k, v, put)
        attn = _attend_cached(q, cache["k"][i], cache["v"][i], limits,
                              q.shape[1] // k.shape[1], k_scale=ks, v_scale=vs,
                              window=c.window_for(i),
                              softcap=c.attn_logit_softcap or None)
        attn = attn.transpose(1, 2).reshape(b, T, -1)
        x = _attn_out(x, attn, layer, c, par)
        x, _ = _mlp_block(x, layer, c, par)
    logits = _full_logits(_lm_head(x, params, c, par), par)
    return logits, dict(cache, lengths=pos + T)


def prefill(params: Dict, tokens, cache: Dict, config: LlamaConfig,
            lengths=None, mesh=None, rules=None):
    """One full-sequence forward over prompt tokens [b, t] (right-padded
    when ragged), writing K/V positions [0, t) of the cache. Returns
    (logits at each row's last real token [b, vocab], cache). Attention
    reads the raw K/V, so the logits do not depend on the cache's dtype.
    Padding is safe under the causal mask: a real query only attends keys
    at or before it, and pad positions are never attended later (per-row
    lengths)."""
    local, par = _mesh_context(params, config, mesh, rules)
    return _prefill(local, tokens, cache, config, lengths, par)


def _prefill(params, tokens, cache, config, lengths=None, par=None):
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

    def put(buf, new):
        buf[:, :, :t] = new

    x = _embed(params, tokens, c, par)
    for i, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], c.rms_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, positions)
        _store(cache, i, k, v, put)
        # GQA is handled inside the attention entry points
        attn = attend(q, k, v, causal=True, window=c.window_for(i),
                      softcap=c.attn_logit_softcap or None)
        attn = attn.transpose(1, 2).reshape(b, t, -1)
        x = _attn_out(x, attn, layer, c, par)
        x, _ = _mlp_block(x, layer, c, par)
    if uniform:
        last = x[:, t - 1]
        new_len = torch.full((), t, dtype=torch.int32, device=tokens.device)
    else:
        last = x[torch.arange(b, device=x.device), lengths.long() - 1]
        new_len = lengths.to(torch.int32)
    # the head runs on the last rows only: row-wise, so the same logits as
    # heading all [b, t] positions and gathering
    logits = _full_logits(_lm_head(last[:, None], params, c, par)[:, 0], par)
    return logits, dict(cache, lengths=new_len)


def _categorical(logits, generator: Optional[torch.Generator]):
    """One draw per row from softmax(logits) by the Gumbel-max trick
    (-log of an Exp(1) draw is Gumbel); -inf logits are never drawn."""
    e = torch.empty_like(logits, dtype=torch.float32).exponential_(generator=generator)
    return (logits.float() - torch.log(e)).argmax(dim=-1)


def generate(params: Dict, prompt, config: LlamaConfig, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, lengths=None,
             kv_dtype: Optional[str] = None, mesh=None, rules=None):
    """Greedy (temperature 0) or sampled continuation [b, max_new_tokens].

    Ragged batches pass right-padded `prompt` plus per-row `lengths`;
    without them the cache is uniform. kv_dtype="int8" keeps the cache in
    int8 codes with bf16 scales. Sampling draws from `generator` (it must
    live on the prompt's device; under a mesh, seed it alike on every rank,
    which then draw the same tokens). The local views are taken once."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    if t + max_new_tokens > max_len:
        raise ValueError(f"prompt {t} + {max_new_tokens} new tokens exceeds "
                         f"max_len {max_len}")
    local, par = _mesh_context(params, config, mesh, rules)
    cache = init_kv_cache(config, b, max_len, uniform=lengths is None,
                          kv_dtype=kv_dtype, device=prompt.device, mesh=mesh, rules=rules)
    logits, cache = _prefill(local, prompt, cache, config, lengths, par)
    out = []
    for i in range(max_new_tokens):
        if temperature > 0:
            tok = _categorical(logits / temperature, generator)
        else:
            tok = logits.argmax(dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = _decode_block_step(local, tok[:, None], cache, config,
                                               check=False, par=par)
            logits = logits[:, 0]
    return torch.stack(out, dim=1)
