"""Vision Transformer, the image-classification model family (the port of
kubedl_tpu/models/vit.py).

The parameter tree is the JAX package's: ``patch_embed`` [P*P*C, d] (the
patch embedding as one matmul over `patchify`'s rows), ``pos_embed``
[n_patches + 1, d], ``cls`` [d], ``head`` [d, classes], ``final_ln`` and
``layers`` (``ln1``, ``ln2``, ``wqkv`` [d, 3d], ``wo``, ``w1``, ``w2``).
The matrices are ``config.dtype``; the position table, the CLS token, the
head and the norms are f32. The residual stream is f32: each LayerNorm
computes in f32 and its output is cast to the model dtype, the products
``attn @ wo`` and ``h @ w2`` are cast back to f32, and the logits are f32.
The MLP's GELU is the tanh approximation (``jax.nn.gelu``'s default).

Attention is pre-LN and non-causal: ops/flash_attention.py
``flash_attention(causal=False)`` under ``config.use_flash``, so a CUDA
forward runs the hand-written forward kernel and its backward the dq and
dkv kernels; ``attention_reference`` otherwise. q, k and v go to the
kernels as strided views of the qkv product (no copy).

Sharded (`mesh`, `rules`): the leaves are DTensors laid out by
`param_specs`, and the images are this rank's rows of the global batch.
Each layer gathers its leaves' fsdp shards and computes on its local heads
and MLP columns; ``wqkv`` is gathered whole and each rank takes its heads'
q, k and v columns, and one sum over the tensor axis follows ``wo`` and
``w2``, as in models/llama.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from kubedl_tpu_torch.parallel import collectives
from kubedl_tpu_torch.parallel.mesh import (ShardingRules, live_axes, local_view,
                                            placements, token_axes, token_index)
from kubedl_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class ViTConfig:
    """Field for field the JAX package's ViTConfig (``dtype`` a torch
    dtype); the defaults are ViT-B/16."""

    image_size: int = 224
    patch_size: int = 16
    n_channels: int = 3
    n_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: Any = torch.bfloat16
    ln_eps: float = 1e-6
    use_flash: bool = True

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("n_classes", 10)
        kw.setdefault("d_model", 64)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("d_ff", 128)
        return cls(**kw)

    @classmethod
    def base(cls, **kw) -> "ViTConfig":
        return cls(**kw)  # ViT-B/16 defaults above


def init(config: ViTConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> Dict:
    """Fresh parameters on `device`: matrices truncated normal in [-2, 2]
    scaled by 1/sqrt(fan_in), the position table and CLS token zeros, the
    norms ones and zeros, as the JAX init (the draws differ: torch's and
    JAX's generators do). `generator` must live on `device`; None seeds
    one with 0."""
    c = config
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    patch_dim = c.patch_size * c.patch_size * c.n_channels
    d = c.d_model

    def dense(shape, fan_in, dtype=c.dtype):
        return llama._dense(shape, fan_in, dtype, generator, dev)

    def norm():
        return {"scale": torch.ones((d,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((d,), dtype=torch.float32, device=dev)}

    params: Dict = {
        "patch_embed": dense((patch_dim, d), patch_dim),
        "pos_embed": torch.zeros((c.n_patches + 1, d), dtype=torch.float32, device=dev),
        "cls": torch.zeros((d,), dtype=torch.float32, device=dev),
        "head": dense((d, c.n_classes), d, torch.float32),
        "final_ln": norm(),
        "layers": [],
    }
    for _ in range(c.n_layers):
        params["layers"].append({
            "ln1": norm(), "ln2": norm(),
            "wqkv": dense((d, 3 * d), d),
            "wo": dense((d, d), d),
            "w1": dense((d, c.d_ff), d),
            "w2": dense((c.d_ff, d), c.d_ff),
        })
    return params


def param_specs(config: ViTConfig, rules: Optional[ShardingRules] = None) -> Dict:
    """PartitionSpec tree matching init(), the JAX package's leaf for leaf:
    heads and MLP over "mlp" (tensor), rows over "embed" (fsdp)."""
    r = rules or ShardingRules()
    layer = {
        "ln1": {"scale": r.spec(None), "bias": r.spec(None)},
        "ln2": {"scale": r.spec(None), "bias": r.spec(None)},
        "wqkv": r.spec("embed", "mlp"),
        "wo": r.spec("mlp", "embed"),
        "w1": r.spec("embed", "mlp"),
        "w2": r.spec("mlp", "embed"),
    }
    return {
        "patch_embed": r.spec(None, "embed"),
        "pos_embed": r.spec(None, "embed"),
        "cls": r.spec(None),
        "head": r.spec("embed", None),
        "final_ln": {"scale": r.spec(None), "bias": r.spec(None)},
        "layers": [dict(layer) for _ in range(config.n_layers)],
    }


def _layer_norm(x, p, eps):
    """f32 LayerNorm over the last dim with the biased variance (jnp.var)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    centered = xf - mu
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, n_patches, patch*patch*C] by pure reshape: the
    patches row-major over the grid, each patch's pixels row-major with
    the channels innermost (the JAX layout ``patch_embed``'s rows follow)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


class _Par(llama._Par):
    """llama's sharded-forward plumbing with ViT's checks, and the fused
    qkv matrix's view: gathered whole, each rank's heads' columns taken,
    its gradient summed over the tensor axis as well as the token axes."""

    def check(self, config: ViTConfig) -> None:
        if self.n_ctx > 1:
            raise NotImplementedError(
                "a mesh context axis > 1 for ViT is not ported to kubedl_tpu_torch "
                "yet (ROADMAP.md)")
        for name, n in (("n_heads", config.n_heads), ("d_ff", config.d_ff)):
            if n % self.n_tp:
                raise ValueError(f"{name} {n} not divisible by the tensor axis {self.n_tp}")

    def qkv_view(self, p, config: ViTConfig):
        from torch.distributed.tensor import Partial, Replicate

        target = tuple(placements(self.mesh, self.rules.spec(None, None)))
        summed = set(self.tp) | set(live_axes(self.mesh, token_axes(self.rules)))
        grad = tuple(Partial() if name in summed and isinstance(t, Replicate) else t
                     for name, t in zip(self.mesh.mesh_dim_names, target))
        full = local_view(p, self.mesh, self.rules, layout=(target, grad))
        if self.n_tp == 1:
            return full
        d, w = config.d_model, config.d_model // self.n_tp
        r = self.tp_index
        return torch.cat([full[:, j * d + r * w:j * d + (r + 1) * w] for j in range(3)], dim=1)


_LAYER_VIEW = {"ln1": (None,), "ln2": (None,), "wo": ("mlp", None),
               "w1": (None, "mlp"), "w2": ("mlp", None)}


def _local_layer(layer: Dict, par: Optional[_Par], config: ViTConfig) -> Dict:
    if par is None:
        return layer
    out = {}
    for name, p in layer.items():
        if name == "wqkv":
            out[name] = par.qkv_view(p, config)
        elif isinstance(p, dict):
            out[name] = {k: par.view(v, *_LAYER_VIEW[name]) for k, v in p.items()}
        else:
            out[name] = par.view(p, *_LAYER_VIEW[name])
    return out


def _encoder_block(x, layer, config: ViTConfig, par: Optional[_Par] = None):
    c = config
    b, t, _ = x.shape
    h = _layer_norm(x, layer["ln1"], c.ln_eps).to(c.dtype)
    if par is not None:
        h = par.enter(h)
    qkv = h @ layer["wqkv"]  # [b, t, 3 * local heads * head_dim]
    q, k, v = (z.reshape(b, t, -1, c.head_dim).transpose(1, 2)
               for z in qkv.chunk(3, dim=-1))
    attend = flash_attention if c.use_flash else attention_reference
    attn = attend(q, k, v, causal=False)
    attn = attn.transpose(1, 2).reshape(b, t, -1).to(c.dtype)
    out = (attn @ layer["wo"]).float()
    x = x + (out if par is None else par.psum(out))

    h = _layer_norm(x, layer["ln2"], c.ln_eps).to(c.dtype)
    if par is not None:
        h = par.enter(h)
    h = F.gelu((h @ layer["w1"]).float(), approximate="tanh").to(c.dtype)
    out = (h @ layer["w2"]).float()
    return x + (out if par is None else par.psum(out))


def forward(params, images: torch.Tensor, config: ViTConfig, mesh=None,
            rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """[B, H, W, C] images (f32 in [0, 1)) -> [B, n_classes] f32 logits;
    with a mesh, this rank's rows."""
    c = config
    par = None if mesh is None else _Par(mesh, rules or ShardingRules(), c)

    def view(p, *dims):
        return p if par is None else par.view(p, *dims)

    x = (patchify(images, c.patch_size).to(c.dtype) @ view(params["patch_embed"], None, None))
    x = x.float()
    b = x.shape[0]
    cls = view(params["cls"], None).expand(b, 1, c.d_model)
    x = torch.cat([cls, x], dim=1) + view(params["pos_embed"], None, None)[None]
    for layer in params["layers"]:
        x = _encoder_block(x, _local_layer(layer, par, c), c, par)
    final = {k: view(v, None) for k, v in params["final_ln"].items()}
    x = _layer_norm(x, final, c.ln_eps)
    return x[:, 0] @ view(params["head"], None, None)  # CLS token -> classes


def loss_fn(params, batch, config: ViTConfig, mesh=None,
            rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """batch = (images [B, H, W, C], labels [B]); the mean cross entropy.
    With a mesh, `batch` is this rank's rows and the loss the global
    batch's, the same on every rank."""
    images, labels = batch
    logits = forward(params, images, config, mesh=mesh, rules=rules)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[:, None])[:, 0].mean()
    if mesh is None:
        return ce
    rules = rules or ShardingRules()
    _, n_tok = token_index(mesh, rules)  # each token block's share of the global mean
    return collectives.psum(ce / n_tok, mesh, token_axes(rules))


def param_count(params) -> int:
    return llama.param_count(params)
