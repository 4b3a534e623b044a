"""Llama-family decoder, dense path (kubedl_tpu/models/llama.py).

Parameters are the JAX package's tree: a dict with ``embed`` [vocab, d],
``layers`` (a list of per-layer dicts ``attn_norm``, ``wq``, ``wk``,
``wv``, ``wo``, ``mlp_norm``, ``w1``, ``w3``, ``w2`` and the optional
``bq``/``bk``/``bv`` and ``post_*_norm``), ``final_norm`` and, unless the
embedding is tied, ``lm_head``. Matrices are ``[in, out]`` (``x @ w``),
norms and biases f32, everything else ``config.dtype``. Functions take
tensors and run where the tensors lie; attention goes through
ops/flash_attention.py, so a CUDA forward runs the hand-written kernel and,
under autograd, its backward runs the flash backward kernels.

Training: `loss_fn` is the next-token cross entropy, with the chunked
variant (`ce_chunks`) that never holds the [b, t, vocab] logits; with
``config.remat`` each layer runs under torch.utils.checkpoint
(non-reentrant), recomputing everything (``remat_policy=None``) or saving
the weight matmuls' outputs (``"dots"``).

Not ported yet: MoE layers, context parallelism and the pipelined forward
(ROADMAP.md).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from kubedl_tpu_torch.models.quant import matmul as _mm
from kubedl_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from kubedl_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class RopeScaling:
    """RoPE frequency rescaling ("llama3" or "linear"); see _rope_freqs."""

    kind: str  # "llama3" | "linear"
    factor: float
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass(frozen=True)
class LlamaConfig:
    """Field for field the JAX package's LlamaConfig (same names, same
    defaults; ``dtype`` is a torch dtype). Fields of paths the port does
    not run yet (MoE, context parallelism) are kept
    so a JAX config carries across whole."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: Optional[str] = None
    use_flash: bool = True
    context_parallel: str = "ring"
    act: str = "silu"  # "silu" | "gelu_tanh"
    norm_offset: float = 0.0  # rms_norm multiplies by (weight + offset)
    embed_scale: float = 1.0
    head_dim_override: Optional[int] = None
    post_block_norms: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_pre_attn_scalar: Optional[float] = None
    sliding_window: Optional[int] = None
    layer_windows: Optional[tuple] = None
    attn_qkv_bias: bool = False
    tie_embeddings: bool = False
    ce_chunks: int = 0
    n_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_dropless: Optional[bool] = None
    moe_fused: Optional[bool] = None
    moe_a2a_chunks: int = 1

    def __post_init__(self):
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1 or None, got {self.sliding_window}")
        if self.layer_windows is not None:
            if len(self.layer_windows) != self.n_layers:
                raise ValueError(
                    f"layer_windows has {len(self.layer_windows)} entries "
                    f"for {self.n_layers} layers")
            for i, w in enumerate(self.layer_windows):
                if w is not None and w < 1:
                    raise ValueError(
                        f"layer_windows[{i}] must be >= 1 or None, got {w}")

    def window_for(self, i: int) -> Optional[int]:
        """Layer i's attention window: layer_windows wins, else the
        global sliding_window, else None (full causal)."""
        if self.layer_windows is not None:
            return self.layer_windows[i]
        return self.sliding_window

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def q_prescale(self) -> float:
        """Multiplier on q after RoPE so the kernels' 1/sqrt(head_dim)
        nets out to 1/sqrt(query_pre_attn_scalar)."""
        if self.query_pre_attn_scalar is None:
            return 1.0
        return (self.head_dim / self.query_pre_attn_scalar) ** 0.5

    @staticmethod
    def llama_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test/dry-run size."""
        defaults = dict(
            vocab_size=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=256, max_seq_len=256,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def config_for(name: str) -> "LlamaConfig":
        """Named configs shared by the generate/serve entry points."""
        factories = {
            "tiny": LlamaConfig.tiny,
            "bench-150m": LlamaConfig.bench_150m,
            "bench-1b": LlamaConfig.bench_1b,
            "llama-7b": LlamaConfig.llama_7b,
        }
        if name not in factories:
            raise ValueError(
                f"unknown model {name!r} (choose from {sorted(factories)})")
        return factories[name]()

    @staticmethod
    def bench_150m(**kw) -> "LlamaConfig":
        defaults = dict(
            vocab_size=32000, d_model=1024, n_layers=8, n_heads=8,
            n_kv_heads=8, d_ff=2816, max_seq_len=1024,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def bench_1b(**kw) -> "LlamaConfig":
        defaults = dict(
            vocab_size=32000, d_model=2048, n_layers=16, n_heads=16,
            n_kv_heads=16, d_ff=5632, max_seq_len=2048,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init(config: LlamaConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> Dict:
    """Fresh parameters on `device` (truncated normal in [-2, 2], scaled by
    1/sqrt(fan_in), as the JAX init; the draws differ, since torch's and
    JAX's generators do). `generator` must live on `device`; None seeds
    one with 0. Each matrix is drawn in f32 on the device and cast, so a
    7B init never holds the whole model in f32 or touches host memory."""
    if config.n_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP.md)")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, dff, hd = config.d_model, config.d_ff, config.head_dim
    nq, nkv = config.n_heads, config.n_kv_heads
    dt = config.dtype

    def dense(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (w * (1.0 / math.sqrt(fan_in))).to(dt)

    def norm():
        return torch.full((d,), 1.0 - config.norm_offset, dtype=torch.float32,
                          device=dev)

    layers = []
    for _ in range(config.n_layers):
        layer = {
            "attn_norm": norm(),
            "wq": dense((d, nq * hd), d),
            "wk": dense((d, nkv * hd), d),
            "wv": dense((d, nkv * hd), d),
            "wo": dense((nq * hd, d), nq * hd),
            "mlp_norm": norm(),
        }
        if config.attn_qkv_bias:
            for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
                layer[name] = torch.zeros((n * hd,), dtype=torch.float32, device=dev)
        if config.post_block_norms:
            layer["post_attn_norm"] = norm()
            layer["post_mlp_norm"] = norm()
        layer["w1"] = dense((d, dff), d)
        layer["w3"] = dense((d, dff), d)
        layer["w2"] = dense((dff, d), dff)
        layers.append(layer)
    params = {
        "embed": dense((config.vocab_size, d), d),
        "layers": layers,
        "final_norm": norm(),
    }
    if not config.tie_embeddings:
        params["lm_head"] = dense((d, config.vocab_size), d)
    return params


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """The same nested dict/list tree with fn applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def param_count(params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps, offset: float = 0.0):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    w = weight + offset if offset else weight
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def softcap(x, cap: float):
    """Gemma-2 logit softcapping: cap * tanh(x / cap)."""
    return torch.tanh(x / cap) * cap


def _act(x, kind: str):
    if kind == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if kind != "silu":
        raise ValueError(f"unknown activation {kind!r} (silu, gelu_tanh)")
    return F.silu(x)


def _scale(x, s: float):
    """x * s with s first rounded to x's dtype, as the JAX package's
    ``x * jnp.asarray(s, x.dtype)`` does; no device tensor is made."""
    return x * float(torch.tensor(s, dtype=x.dtype))


def _rope_freqs(half: int, theta: float, scaling) -> np.ndarray:
    """Inverse rotary frequencies, optionally rescaled, in numpy f32 —
    the JAX package's function line for line, so the frequencies are
    bit-identical."""
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    if scaling is None:
        return freqs
    if scaling.kind == "linear":
        return (freqs / scaling.factor).astype(np.float32)
    if scaling.kind != "llama3":
        raise ValueError(f"unknown rope scaling kind {scaling.kind!r} "
                         "(linear, llama3)")
    orig = float(scaling.original_max_position_embeddings)
    low_wl = orig / scaling.low_freq_factor
    high_wl = orig / scaling.high_freq_factor
    wavelen = 2.0 * np.pi / freqs
    smooth = (orig / wavelen - scaling.low_freq_factor) / (
        scaling.high_freq_factor - scaling.low_freq_factor)
    scaled = np.where(
        wavelen > low_wl, freqs / scaling.factor,
        np.where(wavelen < high_wl, freqs,
                 (1.0 - smooth) * freqs / scaling.factor + smooth * freqs))
    return scaled.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _rope_freqs_on(half: int, theta: float, scaling, device: torch.device):
    """_rope_freqs as a tensor on `device`, copied there once per process
    (read-only; every layer and step reuses it)."""
    return torch.from_numpy(_rope_freqs(half, theta, scaling)).to(device)


def _rope(x, positions, theta, scaling=None):
    """Rotary embeddings over [b, h, t, d_head]; positions [b, t]."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs_on(half, float(theta), scaling, x.device)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, None]  # [b, 1, t, half]
    sin = torch.sin(angles)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _proj(h, layer, name):
    """h @ layer['w<name>'], plus the optional f32 QKV bias (Qwen2) added
    in the activation dtype."""
    out = _mm(h, layer["w" + name])
    bias = layer.get("b" + name)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _qkv(h, layer, c: LlamaConfig, positions):
    """Projected, rotated q [b, hq, t, hd] and k, v [b, hkv, t, hd]."""
    b, t, _ = h.shape
    q = _proj(h, layer, "q").reshape(b, t, c.n_heads, c.head_dim).transpose(1, 2)
    k = _proj(h, layer, "k").reshape(b, t, c.n_kv_heads, c.head_dim).transpose(1, 2)
    v = _proj(h, layer, "v").reshape(b, t, c.n_kv_heads, c.head_dim).transpose(1, 2)
    q = _rope(q, positions, c.rope_theta, c.rope_scaling)
    k = _rope(k, positions, c.rope_theta, c.rope_scaling)
    if c.q_prescale != 1.0:
        q = _scale(q, c.q_prescale)
    return q, k, v


def _attn_out(x, attn, layer, c: LlamaConfig):
    """Residual add of the output projection of attn [b, t, hq*hd]."""
    out = _mm(attn.to(c.dtype), layer["wo"]).to(x.dtype)
    if "post_attn_norm" in layer:
        out = rms_norm(out, layer["post_attn_norm"], c.rms_eps, c.norm_offset)
    return x + out


def _attention_block(x, layer, config: LlamaConfig, positions, window=None):
    b, t, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], config.rms_eps, config.norm_offset)
    q, k, v = _qkv(h, layer, config, positions)
    attend = flash_attention if config.use_flash else attention_reference
    attn = attend(q, k, v, causal=True, window=window,
                  softcap=config.attn_logit_softcap or None)
    attn = attn.transpose(1, 2).reshape(b, t, config.n_heads * config.head_dim)
    return _attn_out(x, attn, layer, config)


def _mlp_block(x, layer, config: LlamaConfig):
    """Dense FFN with the residual add."""
    if "moe" in layer:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP.md)")
    h = rms_norm(x, layer["mlp_norm"], config.rms_eps, config.norm_offset)
    gate = _act(_proj(h, layer, "1").float(), config.act).to(h.dtype)
    up = _proj(h, layer, "3")
    y = _proj(gate * up, layer, "2").to(x.dtype)
    if "post_mlp_norm" in layer:
        y = rms_norm(y, layer["post_mlp_norm"], config.rms_eps, config.norm_offset)
    return x + y


def _embed(params, tokens, c: LlamaConfig):
    x = params["embed"][tokens.long()].to(c.dtype)
    if c.embed_scale != 1.0:
        x = _scale(x, c.embed_scale)
    return x


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of matmuls without batch dims (the weight products),
    recompute the rest, flash forward included: the JAX package's
    ``dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: Optional[str]):
    """fn under non-reentrant torch.utils.checkpoint: policy None saves
    nothing (full recompute), "dots" saves the weight matmuls."""
    if policy is None:
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy != "dots":
        raise ValueError(f"unknown remat_policy {policy!r} (None | 'dots')")
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))


def _backbone(params: Dict, tokens, config: LlamaConfig):
    """Pre-final-norm activations [batch, seq, d]. With config.remat and
    grad enabled, each layer's activations are recomputed in backward."""
    b, t = tokens.shape
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)[None].expand(b, t)
    x = _embed(params, tokens, config)
    remat = config.remat and torch.is_grad_enabled()
    for i, layer in enumerate(params["layers"]):
        def layer_fn(x, layer=layer, window=config.window_for(i)):
            x = _attention_block(x, layer, config, positions, window=window)
            return _mlp_block(x, layer, config)

        x = _remat(layer_fn, config.remat_policy)(x) if remat else layer_fn(x)
    return x


def forward(params, tokens, config: LlamaConfig):
    """Logits [batch, seq, vocab] (f32) for tokens [batch, seq]."""
    return _lm_head(_backbone(params, tokens, config), params, config)


def _head_matrix(params, config: LlamaConfig):
    """[d, vocab] LM head: separate weights or the tied embedding table."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.to(config.dtype)
    return head


def _lm_head(x, params, config: LlamaConfig):
    """Final norm + LM head -> f32 logits (final softcap when set)."""
    x = rms_norm(x, params["final_norm"], config.rms_eps, config.norm_offset)
    logits = _mm(x, _head_matrix(params, config)).float()
    if config.final_logit_softcap:
        logits = softcap(logits, config.final_logit_softcap)
    return logits


def _next_token_ce(logits, targets):
    """Mean negative log-likelihood of targets [b, t] under f32 logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


def _next_token_ce_chunked(x, params, config: LlamaConfig, targets, n_chunks: int):
    """CE without materializing [b, t, V] f32 logits: the vocab runs in
    n_chunks slices, each slice's logits recomputed in backward
    (torch.utils.checkpoint) and only [b, t] statistics kept; an online
    logsumexp merges the chunks exactly."""
    xn = rms_norm(x, params["final_norm"], config.rms_eps, config.norm_offset)
    head = _head_matrix(params, config)
    d, V = head.shape
    if V % n_chunks:
        raise ValueError(f"vocab {V} not divisible by ce_chunks {n_chunks}")
    cs = V // n_chunks
    targets = targets.long()

    def chunk_stats(h_c, off: int):
        logits = (xn @ h_c).float()  # [b, t, cs]
        if config.final_logit_softcap:
            # elementwise, so capping per chunk == capping the full logits
            logits = softcap(logits, config.final_logit_softcap)
        m = logits.amax(dim=-1)
        l = torch.exp(logits - m[..., None]).sum(dim=-1)
        in_chunk = (targets >= off) & (targets < off + cs)
        idx = (targets - off).clamp(0, cs - 1)
        tl = torch.gather(logits, -1, idx[..., None])[..., 0]
        return m, l, torch.where(in_chunk, tl, float("-inf"))

    big_m = torch.full(targets.shape, float("-inf"), device=x.device)
    big_l = torch.zeros(targets.shape, device=x.device)
    tgt = torch.full(targets.shape, float("-inf"), device=x.device)
    for c in range(n_chunks):
        h_c = head[:, c * cs:(c + 1) * cs]
        if torch.is_grad_enabled():
            m, l, tl = checkpoint(chunk_stats, h_c, c * cs, use_reentrant=False)
        else:
            m, l, tl = chunk_stats(h_c, c * cs)
        new_m = torch.maximum(big_m, m)
        big_l = big_l * torch.exp(big_m - new_m) + l * torch.exp(m - new_m)
        # exactly one chunk holds each target; the rest contribute -inf
        big_m, tgt = new_m, torch.maximum(tgt, tl)
    return (big_m + torch.log(big_l) - tgt).mean()


def loss_fn(params, tokens, config: LlamaConfig):
    """Next-token cross entropy over tokens [b, t]: inputs [:, :-1],
    targets [:, 1:]. With config.ce_chunks > 1 the loss runs chunked (the
    full logits never exist). Dense layers only: there is no MoE aux term."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if config.ce_chunks > 1:
        x = _backbone(params, inputs, config)
        return _next_token_ce_chunked(x, params, config, targets, config.ce_chunks)
    return _next_token_ce(forward(params, inputs, config), targets)
