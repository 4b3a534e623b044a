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
`llama.param_specs` (an int8 tree quantized whole, then sharded: parallel/
mesh.py `scale_dims`). Every rank runs the whole batch (the token axes
replicate it) on its local views of the leaves, taken once a call (or once
an engine, models/serving.py) and gathered through parallel/collectives.py:
its heads, its `mlp` columns, its experts and its vocabulary rows, with any
fsdp shards gathered; an int8 leaf's scales follow its output dim. The cache
holds the local KV heads, one sum over the tensor axis follows `wo` and
`w2`, a MoE layer routes the whole batch on every rank and sums its experts'
and columns' parts over the expert and tensor axes (models/moe.py
`moe_mlp_decode`), and the vocabulary shards of the logits are gathered
before a token is picked, so every rank computes the same tokens. LoRA
adapters (ROADMAP.md 12d) and a context axis above 1 (12f) are refused
under a mesh.

Unlike the JAX functions, which return new arrays, these write K/V into the
given cache's buffers in place (a copy per token would double the cache
traffic) and return a dict that shares them. A caller that must keep a
cache (a registered prefix, models/serving.py) clones it first. Write
offsets are clamped to the buffer, as JAX's dynamic_update_slice clamps
them, so an overflowing write lands on the last rows instead of faulting;
the ``check`` guards raise first unless a caller that sized the cache
itself turns them off (they read the lengths back from the device).

Ring caches (``init_kv_cache(ring=True)``, sliding-window models) hold only
the window's rows, position p at row p % window; ``lengths`` still counts
every token, and `_ring_positions` recovers the position a row holds, so
the window mask applies unchanged. Decode steps on a ring are single-token.
`prefill_chunked` appends a prompt in block steps, `generate_speculative`
drafts with a small model and verifies in one block step a round; both,
and the ring, are plain torch over the cache, as the JAX package computes
them outside any kernel. Each takes `mesh` and `rules` as the other
entry points do (the JAX functions run on a sharded tree as they are).

`decode_step`, `decode_block_step` and `prefill` take per-row LoRA adapters
(`lora`, the serving engine's stacks, and `adapter_ids` [b]): two batched
products a projection on top of the main one (models/llama.py `_proj`),
plain torch as the reference's einsums are.
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
from kubedl_tpu_torch.models.quant import _quantize_cols
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
    n_kv_heads / (tensor axis size) local heads, a ring's too.

    ring=True (sliding-window models): the buffers hold the window's rows,
    [b, h, window, d], written at lengths % window, and the dict carries a
    "ring" marker. `lengths` still counts every token seen."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
    if ring:
        if not config.sliding_window:
            raise ValueError("ring=True requires config.sliding_window")
        if config.layer_windows is not None:
            # one buffer length is shared by every layer's K/V
            raise ValueError("ring=True is unsupported with layer_windows")
        if max_len < int(config.sliding_window):
            # a buffer below the window would wrap away keys the mask expects
            raise ValueError(
                f"ring cache needs max_len >= sliding_window "
                f"({config.sliding_window}), got {max_len}; drop ring=True")
        max_len = int(config.sliding_window)
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
    if ring:
        cache["ring"] = torch.zeros((), dtype=torch.int32, device=dev)  # marker only
    return cache


def _ring_positions(total, L: int):
    """Absolute position held by each of L ring rows after `total` tokens
    ([b] or scalar): row j holds the last write whose index is j mod L,
    p(j) = total-1 - ((total-1 - j) mod L). Rows never written (total < L)
    come out negative. Returns [b, L] (or [L])."""
    last = torch.as_tensor(total)[..., None] - 1
    return last - torch.remainder(last - torch.arange(L, device=last.device), L)


def clone_cache(cache: Dict) -> Dict:
    """A copy of a cache whose buffers the decode functions may write."""
    return {name: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
            for name, v in cache.items()}


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
                   window=None, ring_total=None, softcap=None):
    """q [b, hq, tq, d] against cache [b, hkv, L, d]: query t of row i sees
    cache positions < its limit (`limits` [b] with tq == 1, or [b, tq]) and,
    with a window, >= limit - window. Queries are grouped under their KV
    head, so the cache is read at hkv heads. Scores and the output are f32
    on operands in the model dtype, as the JAX einsums with
    preferred_element_type=f32 compute them. An int8 cache passes its
    scales [b, hkv, L]: the K scale multiplies the scores, the V scale the
    softmax weights before they are rounded to the compute dtype. (The JAX
    function also narrows the cache read to the window; that changes only
    which already-masked positions are read.) A ring cache passes
    `ring_total`, the tokens each row has seen ([b] or scalar): its rows'
    positions come from `_ring_positions` and rows never written are
    masked."""
    b, hq, tq, d = q.shape
    hkv, L = ck.shape[1], ck.shape[2]
    lim = limits[:, None] if limits.dim() == 1 else limits  # [b, tq]
    if ring_total is not None:
        k_pos = _ring_positions(ring_total.reshape(-1).expand(b), L)[:, None, None, None, :]
    else:
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
    if ring_total is not None:
        attend &= k_pos >= 0  # ring rows not written yet
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


def _mesh_context(params: Dict, config: LlamaConfig, mesh, rules=None, lora=None):
    """(the tree a decode computes on, its _Par): the params and None
    without a mesh; with one, every leaf's local view, taken here once."""
    if mesh is None:
        return params, None
    from torch.distributed.tensor import DTensor

    if lora is not None:
        raise NotImplementedError(
            "LoRA adapters under a mesh are not ported to kubedl_tpu_torch yet "
            "(ROADMAP.md 12d)")
    par = _Par(mesh, rules or ShardingRules(), config, decode=True)
    if par.n_ctx > 1:
        raise NotImplementedError(
            "a mesh context axis > 1 in decode (a KV cache over sequence blocks) is "
            "not ported to kubedl_tpu_torch yet (ROADMAP.md 12f)")
    split = par.tp + live_axes(mesh, par.rules.axes("expert"))
    if split and not isinstance(params["embed"], DTensor):
        # a plain tree's full leaves would be summed over the split axes
        raise ValueError(f"the mesh splits {split}: shard the tree first "
                         f"(parallel/mesh.py shard_tree with llama.param_specs)")
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
                check: bool = True, mesh=None, rules=None, lora: Optional[Dict] = None,
                adapter_ids=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step for token [b]: (logits [b, vocab], cache), the T=1
    case of decode_block_step: a uniform cache writes every row at the one
    length, a ragged one each row at its own, a ring cache at the length
    modulo its window. `check=False` skips the capacity guard (it reads the
    lengths back from the device) for callers that sized the cache
    themselves. `lora` ({"layers": [per-layer stacks]}) and `adapter_ids`
    [b] add each row's adapter delta (models/llama.py `_proj`; id 0 is the
    base model)."""
    local, par = _mesh_context(params, config, mesh, rules, lora)
    logits, cache = _decode_block_step(local, token[:, None], cache, config, check, par,
                                       lora=lora, adapter_ids=adapter_ids)
    return logits[:, 0], cache


def decode_block_step(params: Dict, tokens, cache: Dict, config: LlamaConfig,
                      check: bool = True, mesh=None, rules=None,
                      return_hidden: bool = False, lora: Optional[Dict] = None,
                      adapter_ids=None) -> Tuple[torch.Tensor, Dict]:
    """T tokens per row [b, T] through the cache in one forward: (logits
    [b, T, vocab], cache advanced by T), or with return_hidden the pre-head
    activations [b, T, d]. Query i sees the cache plus the block up to
    itself. Uniform caches write every row at the one length, ragged caches
    each row at its own. Ring caches take uniform single-token steps only.
    A caller that keeps fewer than T positions (speculative decoding) rolls
    back by shrinking ``lengths``: later positions are masked and written
    over. `lora`, `adapter_ids` as in decode_step."""
    if "ring" in cache and (tokens.shape[1] > 1 or cache["lengths"].dim() == 1):
        # a block can wrap over its own writes; ragged rings step through
        # decode_step, as the JAX package's do
        raise ValueError("ring caches support uniform single-token steps only")
    local, par = _mesh_context(params, config, mesh, rules, lora)
    return _decode_block_step(local, tokens, cache, config, check, par, return_hidden,
                              lora, adapter_ids)


def _layer_lora(lora, i: int):
    return None if lora is None else lora["layers"][i]


def _decode_block_step(params, tokens, cache, config, check=True, par=None,
                       return_hidden=False, lora=None, adapter_ids=None):
    c = config
    b, T = tokens.shape
    pos = cache["lengths"]
    ragged = pos.dim() == 1
    max_cap = cache["k"][0].shape[2]
    ring = "ring" in cache
    if ring and T > 1:
        raise ValueError("ring caches support uniform single-token steps only")
    if T > max_cap:
        raise ValueError(f"block of {T} tokens exceeds cache max_len {max_cap}")
    if check and not ring:
        _check_capacity(pos, T, max_cap)
    steps = torch.arange(T, dtype=torch.int32, device=tokens.device)[None]
    positions = (pos[:, None] if ragged else pos) + steps
    positions = positions.expand(b, T)
    if ring:
        wpos = torch.remainder(positions.long(), max_cap)  # the ring wraps
    else:
        # JAX's dynamic_update_slice clamps the block start into the buffer
        wpos = (positions[:, :1].long().clamp(max=max_cap - T)
                + steps.long())
    limits = positions + 1

    def put(buf, new):
        _write(buf, new, wpos)

    x = _embed(params, tokens, c, par)
    for i, layer in enumerate(params["layers"]):
        llayer = _layer_lora(lora, i)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, positions, llayer, adapter_ids)
        ks, vs = _store(cache, i, k, v, put)
        attn = _attend_cached(q, cache["k"][i], cache["v"][i], limits,
                              q.shape[1] // k.shape[1], k_scale=ks, v_scale=vs,
                              window=c.window_for(i),
                              ring_total=(pos + T) if ring else None,
                              softcap=c.attn_logit_softcap or None)
        attn = attn.transpose(1, 2).reshape(b, T, -1)
        x = _attn_out(x, attn, layer, c, par, llayer, adapter_ids)
        x, _ = _mlp_block(x, layer, c, par, llayer, adapter_ids)
    out = dict(cache, lengths=pos + T)
    if return_hidden:
        return x, out
    return _full_logits(_lm_head(x, params, c, par), par), out


def prefill(params: Dict, tokens, cache: Dict, config: LlamaConfig,
            lengths=None, mesh=None, rules=None, lora: Optional[Dict] = None,
            adapter_ids=None):
    """One full-sequence forward over prompt tokens [b, t] (right-padded
    when ragged), writing K/V positions [0, t) of the cache. Returns
    (logits at each row's last real token [b, vocab], cache). Attention
    reads the raw K/V, so the logits do not depend on the cache's dtype.
    Padding is safe under the causal mask: a real query only attends keys
    at or before it, and pad positions are never attended later (per-row
    lengths). A ring cache takes each row's last `window` positions, in
    ring order. `lora`, `adapter_ids` as in decode_step."""
    local, par = _mesh_context(params, config, mesh, rules, lora)
    return _prefill(local, tokens, cache, config, lengths, par, lora, adapter_ids)


def ring_rows(lengths, W: int, t: int):
    """Index into a [.., t, ..] full-layout axis for each of the W rows of a
    ring after `lengths` tokens ([b] or scalar): row j takes position
    t-1-((t-1-j) mod W) of its row; rows not written yet take a clamped
    position the attention mask ignores."""
    return _ring_positions(lengths, W).clamp(0, t - 1)


def _prefill(params, tokens, cache, config, lengths=None, par=None, lora=None,
             adapter_ids=None):
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

    if "ring" in cache:
        W = cache["k"][0].shape[2]
        n = torch.full((b,), t, device=tokens.device) if uniform else lengths
        idx = ring_rows(n.long(), W, t)  # [b, W]

        def put(buf, new):
            gather = idx.view(b, 1, W, *([1] * (new.dim() - 3)))
            buf.copy_(new.gather(2, gather.expand(-1, new.shape[1], -1, *new.shape[3:])))
    else:
        def put(buf, new):
            buf[:, :, :t] = new

    x = _embed(params, tokens, c, par)
    for i, layer in enumerate(params["layers"]):
        llayer = _layer_lora(lora, i)
        h = rms_norm(x, layer["attn_norm"], c.rms_eps, c.norm_offset)
        q, k, v = _qkv(h, layer, c, positions, llayer, adapter_ids)
        _store(cache, i, k, v, put)
        # GQA is handled inside the attention entry points
        attn = attend(q, k, v, causal=True, window=c.window_for(i),
                      softcap=c.attn_logit_softcap or None)
        attn = attn.transpose(1, 2).reshape(b, t, -1)
        x = _attn_out(x, attn, layer, c, par, llayer, adapter_ids)
        x, _ = _mlp_block(x, layer, c, par, llayer, adapter_ids)
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


def prefill_chunked(params: Dict, tokens, cache: Dict, config: LlamaConfig,
                    chunk_size: int = 2048, mesh=None, rules=None):
    """Append prompt tokens [b, t] to a uniform cache in block steps of
    `chunk_size` (multi-turn serving ingests a new turn without re-running
    the earlier ones). The whole append is checked against the cache's
    capacity first; a trailing partial chunk runs as one extra block step
    (padding would put pad tokens into the cache); the LM head runs once,
    on the last hidden row. Returns (last-token logits [b, vocab], cache).
    The block attention is the plain masked product over the cache, so a
    single long prompt is better served by the one-pass `prefill`. `mesh`,
    `rules` as in decode_step."""
    b, t = tokens.shape
    if cache["lengths"].dim() != 0:
        raise ValueError("prefill_chunked requires a uniform cache "
                         "(init_kv_cache(..., uniform=True))")
    _check_capacity(cache["lengths"], t, cache["k"][0].shape[2])
    local, par = _mesh_context(params, config, mesh, rules)
    x_last = None
    for s0 in range(0, t, chunk_size):
        x, cache = _decode_block_step(local, tokens[:, s0:s0 + chunk_size], cache,
                                      config, check=False, par=par, return_hidden=True)
        x_last = x[:, -1]
    return _full_logits(_lm_head(x_last[:, None], local, config, par)[:, 0], par), cache


def _categorical(logits, generator: Optional[torch.Generator]):
    """One draw per row from softmax(logits) by the Gumbel-max trick
    (-log of an Exp(1) draw is Gumbel); -inf logits are never drawn. The
    noise is drawn in row-major order whatever the logits' strides (logits
    gathered over a tensor axis are not contiguous), so a mesh draws one
    device's tokens."""
    e = torch.empty(logits.shape, dtype=torch.float32,
                    device=logits.device).exponential_(generator=generator)
    return (logits.float() - torch.log(e)).argmax(dim=-1)


def generate(params: Dict, prompt, config: LlamaConfig, max_new_tokens: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, lengths=None,
             kv_dtype: Optional[str] = None, with_logprobs: bool = False,
             mesh=None, rules=None):
    """Greedy (temperature 0) or sampled continuation [b, max_new_tokens].

    Ragged batches pass right-padded `prompt` plus per-row `lengths`;
    without them the cache is uniform. kv_dtype="int8" keeps the cache in
    int8 codes with bf16 scales. Sampling draws from `generator` (it must
    live on the prompt's device; under a mesh, seed it alike on every rank,
    which then draw the same tokens). The local views are taken once.

    with_logprobs=True also returns [b, max_new_tokens] f32 log-probs of
    each emitted token under the untempered distribution (log_softmax of
    the logits that picked it; under a mesh those logits are already
    gathered over the tensor axis, the same on every rank)."""
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    if t + max_new_tokens > max_len:
        raise ValueError(f"prompt {t} + {max_new_tokens} new tokens exceeds "
                         f"max_len {max_len}")
    local, par = _mesh_context(params, config, mesh, rules)
    cache = init_kv_cache(config, b, max_len, uniform=lengths is None,
                          kv_dtype=kv_dtype, device=prompt.device, mesh=mesh, rules=rules)
    logits, cache = _prefill(local, prompt, cache, config, lengths, par)
    out, lps = [], []
    for i in range(max_new_tokens):
        if temperature > 0:
            tok = _categorical(logits / temperature, generator)
        else:
            tok = logits.argmax(dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok)
        if with_logprobs:
            lps.append(torch.log_softmax(logits.float(), dim=-1)
                       .gather(-1, tok[:, None].long())[:, 0])
        if i + 1 < max_new_tokens:
            logits, cache = _decode_block_step(local, tok[:, None], cache, config,
                                               check=False, par=par)
            logits = logits[:, 0]
    toks = torch.stack(out, dim=1)
    if with_logprobs:
        return toks, torch.stack(lps, dim=1)
    return toks


def generate_speculative(params: Dict, draft_params: Dict, prompt, config: LlamaConfig,
                         draft_config: LlamaConfig, max_new_tokens: int, k: int = 4,
                         kv_dtype: Optional[str] = None, return_stats: bool = False,
                         temperature: float = 0.0,
                         generator: Optional[torch.Generator] = None, mesh=None,
                         rules=None):
    """Speculative decoding of one sequence: [1, max_new_tokens] from the
    target's distribution in fewer target passes. Each round the draft
    proposes k tokens one step at a time and the target verifies them in
    one block step, keeping the longest accepted prefix (at most k-1, so
    the draft cache, which saw k inputs, stays aligned) and its own next
    token; both caches roll back by their lengths. temperature 0 emits
    exactly the target's greedy continuation (up to the block step's
    reduction order); temperature > 0 accepts draft x with probability
    min(1, p(x)/q(x)) and otherwise draws from normalize(max(p - q, 0)),
    which samples the target's distribution. return_stats=True also
    returns {"rounds", "acceptance"}: accepted drafts a round over k-1.
    Every round reads its accepted count back to the host once. Under a
    `mesh` both trees are sharded alike and each caches its local heads;
    every rank runs the rounds on the gathered logits, so all accept alike
    (a sampled run needs `generator` seeded alike on every rank)."""
    b, t = prompt.shape
    if b != 1:
        raise ValueError(f"speculative decoding is batch=1 (got batch {b})")
    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k}); k=1 degenerates to "
                         "vanilla greedy with an extra draft pass")
    if draft_config.vocab_size != config.vocab_size:
        raise ValueError(
            f"draft vocab {draft_config.vocab_size} != target vocab "
            f"{config.vocab_size}; the models must share a tokenizer")
    max_len = t + max_new_tokens + k  # slack: the last block may overshoot
    dev = prompt.device
    sampled = temperature > 0
    params, par = _mesh_context(params, config, mesh, rules)
    draft_params, d_par = _mesh_context(draft_params, draft_config, mesh, rules)
    t_cache = init_kv_cache(config, 1, max_len, uniform=True, kv_dtype=kv_dtype, device=dev,
                            mesh=mesh, rules=rules)
    logits, t_cache = _prefill(params, prompt, t_cache, config, par=par)
    d_cache = init_kv_cache(draft_config, 1, max_len, uniform=True, kv_dtype=kv_dtype,
                            device=dev, mesh=mesh, rules=rules)
    _, d_cache = _prefill(draft_params, prompt, d_cache, draft_config, par=d_par)

    def pick(lg):
        if sampled:
            return _categorical(lg / temperature, generator).to(torch.int32)
        return lg.argmax(dim=-1).to(torch.int32)

    cur = pick(logits)  # [1]
    out = [cur]
    n, rounds, acc = 1, 0, 0
    while n < max_new_tokens:
        pos = t_cache["lengths"]
        drafted, qs, tok = [], [], cur
        for _ in range(k):
            lg, d_cache = _decode_block_step(draft_params, tok[:, None], d_cache,
                                             draft_config, check=False, par=d_par)
            tok = pick(lg[:, 0])
            drafted.append(tok)
            if sampled:
                qs.append(torch.softmax(lg[0, 0].float() / temperature, dim=-1))
        drafted = torch.cat(drafted)  # [k]
        blk = torch.cat([cur, drafted])[None]  # [1, k+1]
        blk_logits, t_cache = _decode_block_step(params, blk, t_cache, config, check=False,
                                                 par=par)
        if sampled:
            p = torch.softmax(blk_logits[0].float() / temperature, dim=-1)  # [k+1, V]
            q = torch.stack(qs)  # [k, V]
            idx = drafted[: k - 1, None].long()
            px, qx = p[: k - 1].gather(1, idx)[:, 0], q[: k - 1].gather(1, idx)[:, 0]
            u = torch.rand(k - 1, generator=generator, device=dev)
            a = int(torch.cumprod((u * qx < px).int(), 0).sum())
            # slot a: the residual after a rejection, plain p after the
            # capped full acceptance (that draft was never tested)
            residual = (p[a] - q[a]).clamp_min(0.0)
            rs = float(residual.sum())
            final = p[a] if a == k - 1 or rs <= 0 else residual / max(rs, 1e-30)
            bonus = _categorical(torch.log(final)[None], generator).to(torch.int32)
        else:
            ta = blk_logits[0].argmax(dim=-1).to(torch.int32)  # [k+1]
            a = int(torch.cumprod((drafted[: k - 1] == ta[: k - 1]).int(), 0).sum())
            bonus = ta[a:a + 1]
        out += [drafted[:a], bonus]
        # roll both caches back to the accepted prefix (cur + a drafts)
        t_cache = dict(t_cache, lengths=pos + a + 1)
        d_cache = dict(d_cache, lengths=pos + a + 1)
        cur = bonus
        n, rounds, acc = n + a + 1, rounds + 1, acc + a
    toks = torch.cat(out)[None, :max_new_tokens]
    if not return_stats:
        return toks
    # acceptance counts the verifier's accepted drafts, not the trimmed n
    mean_accepted = acc / rounds if rounds else 0.0
    return toks, {"rounds": rounds, "acceptance": mean_accepted / (k - 1)}
