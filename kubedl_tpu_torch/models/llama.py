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

With ``config.n_experts > 0`` every layer's FFN is a top-k-routed MoE
layer (``layer["moe"]``: router and [E, in, out] expert stacks,
models/moe.py) whose expert products run the grouped matmul kernels of
ops/gmm.py; the layers' load-balance aux losses are summed.

Training: `loss_fn` is the next-token cross entropy plus ``moe_aux_coef``
times the aux loss, with the chunked variant (`ce_chunks`) that never holds
the [b, t, vocab] logits; with ``config.remat`` each layer runs under
torch.utils.checkpoint (non-reentrant), recomputing everything
(``remat_policy=None``) or saving the weight matmuls' outputs (``"dots"``).

Sharded (`mesh`, `rules`): the tree's leaves are DTensors laid out by
`param_specs` on a DeviceMesh (parallel/mesh.py) and `tokens` are this
rank's rows of the global batch. Each layer gathers its leaves' fsdp shards
and computes on its local heads, `mlp` columns and experts as plain
tensors, so the kernels run on the local shards; one sum over the tensor
axis follows `wo` and `w2`. The embedding and the LM head are sharded over
the vocabulary, with the cross-entropy computed over the sharded logits.
MoE layers take the expert-parallel routes of models/moe.py.

Context parallelism (the mesh's "context" axis, `config.context_parallel`):
each rank holds its block of every row's positions (parallel/mesh.py
`seq_block`), RoPE reads the global positions, and attention runs over the
axis by ring (ops/ring_attention.py) or Ulysses (ops/ulysses.py); windows
and the attention softcap are refused there, as in the JAX package. The
cross entropy and the MoE statistics are averaged over the context blocks
as over the token blocks, and every gradient is a part summed over both.

Pipelined (`loss_fn_pp`, the "stage" mesh axis): the layers stacked on a
leading dim (`stack_params`, specs `param_specs_pp`) run the GPipe or the
interleaved 1F1B schedule of parallel/pipeline.py, each stage its own
layers through the same `pipeline_layer_fn` body the MPMD stage programs
(train/pipeline_runtime.py) run.
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

from kubedl_tpu_torch.api.validation import validate_pipeline_shapes
from kubedl_tpu_torch.models.moe import moe_init, moe_mlp, moe_mlp_decode, moe_param_specs
from kubedl_tpu_torch.models.quant import is_quantized
from kubedl_tpu_torch.models.quant import matmul as _mm
from kubedl_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from kubedl_tpu_torch.ops.ring_attention import ring_attention
from kubedl_tpu_torch.ops.ulysses import ulysses_attention
from kubedl_tpu_torch.parallel import collectives, pipeline
from kubedl_tpu_torch.parallel.mesh import (P, ShardingRules, axes_index, axes_size,
                                            axis_size, live_axes, local_view, mesh_shape,
                                            scale_dims, seq_index, token_axes, token_index,
                                            view_placements)
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
    defaults; ``dtype`` is a torch dtype), so a JAX config carries across
    whole. ``context_parallel`` picks the attention of a mesh whose context
    axis is above 1: "ring" or "ulysses"."""

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
    def has_windows(self) -> bool:
        return self.sliding_window is not None or (
            self.layer_windows is not None
            and any(w is not None for w in self.layer_windows))

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


def param_specs(config: LlamaConfig, rules: Optional[ShardingRules] = None) -> Dict:
    """PartitionSpec tree matching init(): the sharding contract, the JAX
    package's specs leaf for leaf."""
    r = rules or ShardingRules()
    layer = {
        "attn_norm": r.spec("embed"),
        "wq": r.spec("embed", "heads"),
        "wk": r.spec("embed", "heads"),
        "wv": r.spec("embed", "heads"),
        "wo": r.spec("heads", "embed"),
        "mlp_norm": r.spec("embed"),
    }
    if config.attn_qkv_bias:
        # biases follow their projection's output axis
        layer.update({"bq": r.spec("heads"), "bk": r.spec("heads"), "bv": r.spec("heads")})
    if config.post_block_norms:
        layer.update({"post_attn_norm": r.spec("embed"), "post_mlp_norm": r.spec("embed")})
    if config.n_experts > 0:
        layer["moe"] = moe_param_specs(r)
    else:
        layer.update({"w1": r.spec("embed", "mlp"), "w3": r.spec("embed", "mlp"),
                      "w2": r.spec("mlp", "embed")})
    specs = {
        "embed": r.spec("vocab", "embed"),
        "layers": [dict(layer) for _ in range(config.n_layers)],
        "final_norm": r.spec("embed"),
    }
    if not config.tie_embeddings:
        specs["lm_head"] = r.spec("embed", "vocab")
    return specs


def init(config: LlamaConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> Dict:
    """Fresh parameters on `device` (truncated normal in [-2, 2], scaled by
    1/sqrt(fan_in), as the JAX init; the draws differ, since torch's and
    JAX's generators do). `generator` must live on `device`; None seeds
    one with 0. Each matrix is drawn in f32 on the device and cast, so a
    7B init never holds the whole model in f32 or touches host memory."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d = config.d_model
    layers = [init_layer(config, generator, dev) for _ in range(config.n_layers)]
    params = {
        "embed": _dense((config.vocab_size, d), d, config.dtype, generator, dev),
        "layers": layers,
        "final_norm": _norm(config, dev),
    }
    if not config.tie_embeddings:
        params["lm_head"] = _dense((d, config.vocab_size), d, config.dtype, generator, dev)
    return params


def _dense(shape, fan_in, dtype, generator, dev):
    w = torch.empty(shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def _norm(config: LlamaConfig, dev):
    return torch.full((config.d_model,), 1.0 - config.norm_offset,
                      dtype=torch.float32, device=dev)


def init_layer(config: LlamaConfig, generator: torch.Generator, device) -> Dict:
    """One decoder layer's parameters, drawn as `init` draws them: the dense
    FFN (w1, w3, w2) or, with n_experts > 0, an MoE FFN under "moe"
    (models/moe.py `moe_init`). A caller can build a model layer by layer,
    e.g. quantizing each layer before drawing the next."""
    dev = resolve_device(device)
    d, dff, hd = config.d_model, config.d_ff, config.head_dim
    nq, nkv = config.n_heads, config.n_kv_heads

    def dense(shape, fan_in):
        return _dense(shape, fan_in, config.dtype, generator, dev)

    layer = {
        "attn_norm": _norm(config, dev),
        "wq": dense((d, nq * hd), d),
        "wk": dense((d, nkv * hd), d),
        "wv": dense((d, nkv * hd), d),
        "wo": dense((nq * hd, d), nq * hd),
        "mlp_norm": _norm(config, dev),
    }
    if config.attn_qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            layer[name] = torch.zeros((n * hd,), dtype=torch.float32, device=dev)
    if config.post_block_norms:
        layer["post_attn_norm"] = _norm(config, dev)
        layer["post_mlp_norm"] = _norm(config, dev)
    if config.n_experts > 0:
        layer["moe"] = moe_init(d, dff, config.n_experts, dtype=config.dtype,
                                generator=generator, device=dev)
    else:
        layer["w1"] = dense((d, dff), d)
        layer["w3"] = dense((d, dff), d)
        layer["w2"] = dense((dff, d), dff)
    return layer


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


def _proj(h, layer, name, lora=None, adapter_ids=None):
    """h @ layer['w<name>'], plus the optional f32 QKV bias (Qwen2) added
    in the activation dtype.

    Multi-adapter serving (models/serving.py `register_adapter`): `lora` is
    this layer's stacked adapters {"w<name>": {"a": [N, in, r], "b": [N, r,
    out]}}, row 0 all zeros (the base model) and the alpha/r scale folded
    into b; `adapter_ids` [b] picks each row's adapter. The rank-r delta is
    two batched products with f32 accumulation on top of the main product,
    added in the output dtype."""
    wkey = "w" + name
    out = _mm(h, layer[wkey])
    bias = layer.get("b" + name)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if lora is not None and wkey in lora:
        a = torch.index_select(lora[wkey]["a"], 0, adapter_ids).to(h.dtype)
        bm = torch.index_select(lora[wkey]["b"], 0, adapter_ids).to(h.dtype)
        delta = torch.bmm(h.float(), a.float()).to(h.dtype)  # [b, t, r]
        out = out + torch.bmm(delta.float(), bm.float()).to(out.dtype)
    return out


def _qkv(h, layer, c: LlamaConfig, positions, lora=None, adapter_ids=None):
    """Projected, rotated q [b, hq, t, hd] and k, v [b, hkv, t, hd] (the
    local heads, when the projections are a tensor shard); `lora`,
    `adapter_ids` as in `_proj`."""
    b, t, _ = h.shape
    q = _proj(h, layer, "q", lora, adapter_ids).reshape(b, t, -1, c.head_dim).transpose(1, 2)
    k = _proj(h, layer, "k", lora, adapter_ids).reshape(b, t, -1, c.head_dim).transpose(1, 2)
    v = _proj(h, layer, "v", lora, adapter_ids).reshape(b, t, -1, c.head_dim).transpose(1, 2)
    q = _rope(q, positions, c.rope_theta, c.rope_scaling)
    k = _rope(k, positions, c.rope_theta, c.rope_scaling)
    if c.q_prescale != 1.0:
        q = _scale(q, c.q_prescale)
    return q, k, v


def _attn_out(x, attn, layer, c: LlamaConfig, par: Optional["_Par"] = None,
              lora=None, adapter_ids=None):
    """Residual add of the output projection of attn [b, t, hq*hd]; with
    local heads the partial products are summed over the tensor axis."""
    out = _proj(attn.to(c.dtype), layer, "o", lora, adapter_ids).to(x.dtype)
    if par is not None:
        out = par.psum(out)
    if "post_attn_norm" in layer:
        out = rms_norm(out, layer["post_attn_norm"], c.rms_eps, c.norm_offset)
    return x + out


def _attention_block(x, layer, config: LlamaConfig, positions, window=None,
                     par: Optional["_Par"] = None):
    b, t, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], config.rms_eps, config.norm_offset)
    if par is not None:
        h = par.enter(h)
    q, k, v = _qkv(h, layer, config, positions)
    if par is not None and par.n_ctx > 1:
        attn = _context_attention(q, k, v, config, par)
    else:
        attend = flash_attention if config.use_flash else attention_reference
        attn = attend(q, k, v, causal=True, window=window,
                      softcap=config.attn_logit_softcap or None)
    attn = attn.transpose(1, 2).reshape(b, t, -1)
    return _attn_out(x, attn, layer, config, par)


def _context_attention(q, k, v, config: LlamaConfig, par: "_Par"):
    """Causal attention of this rank's sequence block over the context
    axis: K and V repeated to q's heads, then the ring or Ulysses
    (`config.context_parallel`), as the JAX package's context branch."""
    if config.has_windows:
        raise NotImplementedError(
            "sliding_window + context parallelism is not implemented "
            "(a windowed ring would skip most hops; use full attention "
            "on the context mesh or a single-shard windowed model)")
    if config.attn_logit_softcap:
        raise NotImplementedError(
            "attn_logit_softcap + context parallelism is not "
            "implemented (the ring/all-to-all paths run uncapped "
            "online softmax)")
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if config.context_parallel == "ulysses":
        return ulysses_attention(q, k, v, mesh=par.mesh, axis_name=par.seq[0], causal=True,
                                 use_flash=config.use_flash)
    return ring_attention(q, k, v, mesh=par.mesh, axis_name=par.seq[0], causal=True)


def _mlp_block(x, layer, config: LlamaConfig, par: Optional["_Par"] = None,
               lora=None, adapter_ids=None):
    """Dense or MoE FFN with the residual add: (x, aux), aux the MoE
    load-balance loss (a 0-d f32 tensor) or 0.0 for a dense layer.
    `lora`, `adapter_ids`: per-row serving adapters on w1/w3/w2 (`_proj`);
    MoE layers carry no dense projections for adapters to target."""
    h = rms_norm(x, layer["mlp_norm"], config.rms_eps, config.norm_offset)
    if "moe" in layer and par is not None and par.decode:
        y, aux = moe_mlp_decode(h, layer["moe"], top_k=config.expert_top_k,
                                capacity_factor=config.expert_capacity_factor,
                                mesh=par.mesh, rules=par.rules,
                                dropless=config.moe_dropless, fused=config.moe_fused)
    elif "moe" in layer:
        y, aux = moe_mlp(h, layer["moe"], top_k=config.expert_top_k,
                         capacity_factor=config.expert_capacity_factor,
                         mesh=par.mesh if par is not None else None,
                         rules=par.rules if par is not None else None,
                         dropless=config.moe_dropless, fused=config.moe_fused,
                         a2a_chunks=config.moe_a2a_chunks)
        y = y.to(x.dtype)
    else:
        if par is not None:
            h = par.enter(h)
        gate = _act(_proj(h, layer, "1", lora, adapter_ids).float(),
                    config.act).to(h.dtype)
        up = _proj(h, layer, "3", lora, adapter_ids)
        y = _proj(gate * up, layer, "2", lora, adapter_ids).to(x.dtype)
        if par is not None:
            y = par.psum(y)
        aux = 0.0
    if "post_mlp_norm" in layer:
        y = rms_norm(y, layer["post_mlp_norm"], config.rms_eps, config.norm_offset)
    return x + y, aux


def _embed(params, tokens, c: LlamaConfig, par: Optional["_Par"] = None):
    if par is None or par.n_tp == 1:
        tbl = params["embed"] if par is None else par.view(params["embed"], "vocab", None)
        x = tbl[tokens.long()].to(c.dtype)
    else:  # this rank's vocab rows; the other rows' peers add theirs
        tbl = par.view(params["embed"], "vocab", None)
        ids = tokens.long() - par.tp_index * tbl.shape[0]
        inside = (ids >= 0) & (ids < tbl.shape[0])
        x = torch.where(inside[..., None], tbl[ids.clamp(0, tbl.shape[0] - 1)],
                        tbl.new_zeros(())).to(c.dtype)
        x = par.psum(x)
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


class _Par:
    """The collectives of a sharded forward on `mesh` (parallel/
    collectives.py): `view` gives a leaf's local compute tensor, `enter`
    and `psum` open and close a tensor-parallel region, and the token and
    context axes sum each rank's part of the loss. `seq` are the live
    context axes, `ctx_index` of `n_ctx` this rank's sequence block.

    `decode=True` (models/decode.py: every rank holds the whole batch, no
    gradient flows): views are gathered through parallel/collectives.py
    (`gathered_view`), and MoE layers take `moe_mlp_decode`."""

    def __init__(self, mesh, rules: ShardingRules, config: LlamaConfig,
                 partial_axes: tuple = (), decode: bool = False):
        self.mesh, self.rules = mesh, rules
        self.decode = decode
        self.seq = live_axes(mesh, rules.axes("seq"))
        if len(self.seq) > 1:
            raise NotImplementedError(
                f"rules shard 'seq' over {self.seq}: context parallelism runs over "
                f"one mesh axis")
        self.ctx_index, self.n_ctx = seq_index(mesh, rules)
        # views' gradients are parts over these too: the stage axis of a
        # pipeline, and the context axis (each rank's own sequence block)
        self.partial_axes = tuple(partial_axes) + self.seq
        self.tp = live_axes(mesh, rules.axes("heads"))
        for dim in ("mlp", "vocab"):
            if live_axes(mesh, rules.axes(dim)) != self.tp:
                raise NotImplementedError(
                    f"rules shard {dim!r} over {rules.axes(dim)} but 'heads' over "
                    f"{rules.axes('heads')}: the port's tensor parallelism needs one axis set")
        self.n_tp = axes_size(mesh, self.tp)
        self.tp_index = axes_index(mesh, self.tp)
        self.check(config)
        self.tok_index, self.n_tok = token_index(mesh, rules)
        self._layouts = {}

    def check(self, config: LlamaConfig) -> None:
        """Raise unless the config's heads and widths split over the tensor axis."""
        nkv, nq = config.n_kv_heads, config.n_heads
        if nkv % self.n_tp or nq % self.n_tp:
            raise ValueError(
                f"tensor parallelism over {self.n_tp} ranks needs n_heads ({nq}) and "
                f"n_kv_heads ({nkv}) divisible by it")
        for name, n in (("d_ff", config.d_ff), ("vocab_size", config.vocab_size)):
            if n % self.n_tp:
                raise ValueError(f"{name} {n} not divisible by the tensor axis {self.n_tp}")
        n_e = axes_size(self.mesh, live_axes(self.mesh, self.rules.axes("expert")))
        if config.n_experts and config.n_experts % n_e:
            raise ValueError(f"{config.n_experts} experts not divisible by the expert "
                             f"axis {n_e}")

    def view(self, p, *dims):
        """The local tensor of leaf `p` laid out as the logical `dims`; an
        int8 leaf's scale {"s"} as parallel/mesh.py `scale_dims`."""
        if is_quantized(p):
            return {"q": self.view(p["q"], *dims), "s": self.view(p["s"], *scale_dims(dims))}
        if self.decode:
            return collectives.gathered_view(p, self.mesh, self.rules.spec(*dims))
        layout = self._layouts.get(dims)
        if layout is None:
            layout = self._layouts[dims] = view_placements(self.mesh, self.rules, dims,
                                                           self.partial_axes)
        return local_view(p, self.mesh, self.rules, *dims, layout=layout)

    def enter(self, x):
        return collectives.enter(x, self.mesh, self.tp)

    def psum(self, x):
        return collectives.psum(x, self.mesh, self.tp)

    def mean_over_tokens(self, x):
        """The global mean of a per-rank mean over equal token blocks: summed
        over the token and context axes, each rank's part 1 / blocks."""
        return collectives.psum(x / (self.n_tok * self.n_ctx), self.mesh,
                                token_axes(self.rules) + self.seq)


# each leaf's compute layout: the embed dim gathered (ZeRO-3), heads, mlp
# columns and experts kept local; the router is gathered whole
_LAYER_VIEW = {
    "attn_norm": (None,), "mlp_norm": (None,),
    "post_attn_norm": (None,), "post_mlp_norm": (None,),
    "wq": (None, "heads"), "wk": (None, "heads"), "wv": (None, "heads"),
    "wo": ("heads", None), "bq": ("heads",), "bk": ("heads",), "bv": ("heads",),
    "w1": (None, "mlp"), "w3": (None, "mlp"), "w2": ("mlp", None),
}
_MOE_VIEW = {"router": (None, None), "w1": ("expert", None, "mlp"),
             "w3": ("expert", None, "mlp"), "w2": ("expert", "mlp", None)}


def _local_layer(layer: Dict, par: Optional[_Par]) -> Dict:
    if par is None:
        return layer
    out = {}
    for name, p in layer.items():
        if name == "moe":
            out[name] = {n: par.view(w, *_MOE_VIEW[n]) for n, w in p.items()}
        else:
            out[name] = par.view(p, *_LAYER_VIEW[name])
    return out


def _local_head(params: Dict, par: Optional[_Par]) -> Dict:
    """final_norm and the [d, vocab-shard] head (separate or tied)."""
    if par is None:
        return params
    out = {"final_norm": par.view(params["final_norm"], None)}
    if "lm_head" in params:
        out["lm_head"] = par.view(params["lm_head"], None, "vocab")
    else:
        out["embed"] = par.view(params["embed"], "vocab", None)
    return out


def _backbone(params: Dict, tokens, config: LlamaConfig, par: Optional[_Par] = None):
    """(pre-final-norm activations [batch, seq, d], summed MoE aux loss:
    0.0 for a dense model). With config.remat and grad enabled, each
    layer's activations are recomputed in backward (a sharded layer
    gathers its leaves again there)."""
    b, t = tokens.shape
    # global positions: this rank's block of the sequence starts at i * t
    start = par.ctx_index * t if par is not None else 0
    positions = torch.arange(start, start + t, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, t)
    x = _embed(params, tokens, config, par)
    remat = config.remat and torch.is_grad_enabled()
    aux = 0.0
    for i, layer in enumerate(params["layers"]):
        def layer_fn(x, layer=layer, window=config.window_for(i)):
            local = _local_layer(layer, par)
            x = _attention_block(x, local, config, positions, window=window, par=par)
            return _mlp_block(x, local, config, par)

        x, a = _remat(layer_fn, config.remat_policy)(x) if remat else layer_fn(x)
        aux = aux + a
    return x, aux


def _par(mesh, rules, config) -> Optional[_Par]:
    return None if mesh is None else _Par(mesh, rules or ShardingRules(), config)


def forward_and_aux(params, tokens, config: LlamaConfig, mesh=None, rules=None):
    """(logits [batch, seq, vocab] f32, summed MoE aux loss as a 0-d f32
    tensor: 0 for a dense model). With a mesh: this rank's rows, and its
    shard of the vocabulary when the tensor axis shards it."""
    par = _par(mesh, rules, config)
    x, aux = _backbone(params, tokens, config, par)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _lm_head(x, _local_head(params, par), config, par), aux


def forward(params, tokens, config: LlamaConfig, mesh=None, rules=None):
    """Logits [batch, seq, vocab] (f32) for tokens [batch, seq]."""
    return forward_and_aux(params, tokens, config, mesh=mesh, rules=rules)[0]


def _head_matrix(params, config: LlamaConfig):
    """[d, vocab] LM head: separate weights or the tied embedding table."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T.to(config.dtype)
    return head


def _lm_head(x, params, config: LlamaConfig, par: Optional[_Par] = None):
    """Final norm + LM head -> f32 logits (final softcap when set)."""
    x = rms_norm(x, params["final_norm"], config.rms_eps, config.norm_offset)
    if par is not None:
        x = par.enter(x)
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


def sharded_target_logprobs(logits, targets, par: _Par):
    """log p(targets) at each position [..] from logits [.., vocab shard]
    whose vocabulary is sharded over the tensor axis: the max, the sum of
    exponentials and the target's logit (from the shard that holds it) are
    combined across the shards."""
    vl = logits.shape[-1]
    m = collectives.pmax(logits.amax(dim=-1), par.mesh, par.tp)
    se = par.psum(torch.exp(logits - m[..., None]).sum(dim=-1))
    ids = targets.long() - par.tp_index * vl
    inside = (ids >= 0) & (ids < vl)
    tl = torch.gather(logits, -1, ids.clamp(0, vl - 1)[..., None])[..., 0]
    tl = par.psum(torch.where(inside, tl, tl.new_zeros(())))
    return tl - (torch.log(se) + m)


def _sharded_ce(logits, targets, par: _Par):
    """_next_token_ce over logits whose vocabulary is sharded over the
    tensor axis."""
    return -sharded_target_logprobs(logits, targets, par).mean()


def loss_fn(params, tokens, config: LlamaConfig, mesh=None, rules=None):
    """Next-token cross entropy over tokens [b, t] (inputs [:, :-1],
    targets [:, 1:]) plus moe_aux_coef times the summed MoE aux loss. With
    config.ce_chunks > 1 the loss runs chunked (the full logits never
    exist), unless the tensor axis shards the vocabulary (a warning, then
    the full-logits path, as in the JAX package).

    With a mesh, `tokens` are this rank's rows, and with a context axis
    its columns of them (parallel/mesh.py `seq_block`: its positions and
    the next token): the loss is the global batch's mean over every
    position, the same on every rank, and each rank's gradients are its
    part of the sum (parallel/mesh.py `local_view` reduces them)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    par = _par(mesh, rules, config)
    x, aux = _backbone(params, inputs, config, par)
    head = _local_head(params, par)
    chunked = config.ce_chunks > 1
    if chunked and par is not None and par.n_tp > 1:
        _warn_ce_chunks_ignored(par.n_tp)
        chunked = False
    if chunked:
        ce = _next_token_ce_chunked(x, head, config, targets, config.ce_chunks)
    elif par is not None and par.n_tp > 1:
        ce = _sharded_ce(_lm_head(x, head, config, par), targets, par)
    else:
        ce = _next_token_ce(_lm_head(x, head, config, par), targets)
    if par is not None:  # each block's share of the global mean
        ce = par.mean_over_tokens(ce)
    return ce + config.moe_aux_coef * aux


_warned_ce_chunks = False


def _warn_ce_chunks_ignored(tensor_size: int) -> None:
    global _warned_ce_chunks
    if _warned_ce_chunks:
        return
    _warned_ce_chunks = True
    import warnings

    warnings.warn(
        f"ce_chunks ignored: the mesh's tensor axis ({tensor_size}) shards the "
        f"head's vocab dim, so the full-logits loss path applies",
        stacklevel=3,
    )


# ---------------------------------------------------------------------------
# the pipeline-parallel path (the "stage" mesh axis)
# ---------------------------------------------------------------------------


def param_specs_pp(config: LlamaConfig, rules: Optional[ShardingRules] = None) -> Dict:
    """Spec tree matching stack_params(): layer leaves gain a leading
    layer dim sharded over "stage"."""
    r = rules or ShardingRules()
    base = param_specs(config, r)
    base["layers"] = _stacked_specs(base["layers"][0], r.rules["layers"])
    return base


def _stacked_specs(layer: Dict, lead: tuple) -> Dict:
    """A layer's spec tree with `lead` before each spec (a spec is a
    tuple, so `tree_map` would walk into it)."""
    return {k: _stacked_specs(v, lead) if isinstance(v, dict) else P(*(lead + tuple(v)))
            for k, v in layer.items()}


def stack_params(params: Dict) -> Dict:
    """Per-layer list of dicts -> stacked leaves [n_layers, ...] for the
    pipelined forward (parallel/pipeline.py layout)."""
    out = dict(params)
    out["layers"] = pipeline.stack_layers(params["layers"])
    return out


def pipeline_layer_fn(config: LlamaConfig, t: int, rules: Optional[ShardingRules] = None):
    """The ONE per-layer body every pipelined path applies -- the GPipe
    oracle, the interleaved 1F1B schedule and the MPMD stage programs all
    run this closure, so schedule parity can never drift into layer-math
    drift. `layer_fn(act, layer) -> (act, aux)`: aux the layer's MoE
    load-balance loss, 0.0 for a dense layer; `t` is the sequence length.
    A MoE layer takes the local route (experts replicated per stage).
    `rules` is the reference's signature: tensor and context are 1 on a
    pipelined mesh, so the body shards nothing."""

    def layer_fn(a, layer):
        pos = torch.arange(t, dtype=torch.int32, device=a.device)[None].expand(a.shape[0], t)
        a = _attention_block(a, layer, config, pos, window=config.sliding_window)
        return _mlp_block(a, layer, config)

    return layer_fn


def _check_pipelined(config: LlamaConfig, mesh, n_microbatches: int, schedule: str,
                     interleave: int) -> None:
    if config.layer_windows is not None:
        # the pipeline runs ONE layer body over the stacked layers; a
        # per-layer window cannot vary inside it
        raise ValueError("pipelined path requires a uniform window "
                         "(layer_windows unsupported)")
    shape = mesh_shape(mesh)
    for ax in ("tensor", "context", "expert"):
        if shape.get(ax, 1) != 1:
            raise ValueError(f"pipelined mesh must have {ax}=1, got {shape[ax]}")
    # the schedule-name/interleave pairing rules live in the shared
    # validator; the shape rules re-check inside the schedules
    errs = validate_pipeline_shapes(shape.get("stage", 1), n_microbatches, interleave,
                                    schedule=schedule, path="forward_pipelined")
    if errs:
        raise ValueError("; ".join(errs))


def _pipelined_backbone(params, tokens, config: LlamaConfig, mesh, rules,
                        n_microbatches: int, schedule: str, interleave: int):
    """(pre-final-norm activations [b, t, d]: the model's on the last stage,
    a buffer no loss reads elsewhere; the aux total; the `_Par`; whether
    this rank is the last stage)."""
    _check_pipelined(config, mesh, n_microbatches, schedule, interleave)
    stage_axis = rules.axes("layers")[0]
    par = _Par(mesh, rules, config, partial_axes=(stage_axis,))
    layer_fn = pipeline_layer_fn(config, tokens.shape[1], rules)
    x = pipeline.microbatch(_embed(params, tokens, config, par), n_microbatches)
    y, aux = pipeline.pipeline_apply_1f1b(
        params["layers"], x, layer_fn, mesh=mesh,
        interleave=interleave if schedule == "1f1b" else 1, stage_axis=stage_axis,
        batch_axes=rules.axes("batch"), remat=config.remat)
    n_stages = axis_size(mesh, stage_axis)
    last = n_stages == 1 or mesh.get_local_rank(stage_axis) == n_stages - 1
    return pipeline.unmicrobatch(y), aux, par, last


def forward_pipelined_and_aux(
    params: Dict,  # stacked layout (stack_params)
    tokens,
    config: LlamaConfig,
    mesh,
    rules: Optional[ShardingRules] = None,
    n_microbatches: int = 4,
    schedule: str = "gpipe",
    interleave: int = 1,
):
    """Pipelined forward over the mesh's "stage" axis: (logits of this
    rank's rows, the same on every stage; the summed MoE aux loss, 0 when
    dense). `schedule` picks the loop: "gpipe" or "1f1b" with `interleave`
    virtual stages a rank (parallel/pipeline.py). `tokens` are this rank's
    rows (parallel/pipeline.py `local_rows` for the reference's split).
    The embedding runs on every stage and counts on stage 0 (a select
    drops it elsewhere); every stage runs the head on its own buffer and
    the last stage's logits are broadcast, so the head's gradient reaches
    the last stage only, and the endcaps' gradients are summed over the
    stage axis. `loss_fn_pp` runs the head on the last stage alone. Unlike
    the reference's pipelined path, the embedding is scaled by
    `embed_scale` here, as `loss_fn` scales it. Composes with data
    parallelism and MoE; tensor, context and expert must be size 1 on a
    pipelined mesh."""
    rules = rules or ShardingRules()
    y, aux, par, _ = _pipelined_backbone(params, tokens, config, mesh, rules,
                                         n_microbatches, schedule, interleave)
    logits = _lm_head(y, _local_head(params, par), config, par)
    stage_axis = rules.axes("layers")[0]
    return collectives.broadcast_from(logits, mesh, stage_axis,
                                      axis_size(mesh, stage_axis) - 1), aux


def forward_pipelined(params: Dict, tokens, config: LlamaConfig, mesh, rules=None,
                      n_microbatches: int = 4, schedule: str = "gpipe", interleave: int = 1):
    return forward_pipelined_and_aux(
        params, tokens, config, mesh, rules=rules, n_microbatches=n_microbatches,
        schedule=schedule, interleave=interleave)[0]


def loss_fn_pp(params, tokens, config: LlamaConfig, mesh, rules=None,
               n_microbatches: int = 4, schedule: str = "gpipe", interleave: int = 1):
    """`loss_fn` through the pipelined forward: the global batch's next-token
    cross entropy plus moe_aux_coef times the aux, the same on every rank;
    `tokens` are this rank's rows [b, t]. The head and the cross entropy
    count on the last stage, whose loss is broadcast over the stage axis;
    the other stages run them on one position of their own buffer, so
    every rank's graph holds the same views and collectives, and the
    broadcast passes them a zero cotangent."""
    rules = rules or ShardingRules()
    y, aux, par, last = _pipelined_backbone(params, tokens[:, :-1], config, mesh, rules,
                                            n_microbatches, schedule, interleave)
    n = y.shape[1] if last else 1
    logits = _lm_head(y[:, :n], _local_head(params, par), config, par)
    ce = _next_token_ce(logits, tokens[:, 1:n + 1])
    tok = token_axes(rules)
    ce = collectives.psum(ce / axes_size(mesh, live_axes(mesh, tok)), mesh, tok)
    stage_axis = rules.axes("layers")[0]
    ce = collectives.broadcast_from(ce, mesh, stage_axis, axis_size(mesh, stage_axis) - 1)
    return ce + config.moe_aux_coef * aux