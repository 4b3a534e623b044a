"""Weight-only int8 quantization for serving (kubedl_tpu/models/quant.py).

Decoding at a small batch reads every weight once a token, so its time is
about the weight bytes over the card's memory rate. Matrices stored as int8
with a per-output-channel bf16 scale halve those bytes; the products still
run in bf16. A quantized leaf is a dict {"q": int8, "s": bf16 scale}, so a
quantized tree has the plain tree's shape and every entry point takes
either. `quantize` and `quantize_stack` give the JAX functions' bits: the
scale is rounded to bf16 before the codes are computed, so the codes
compensate the scale's own rounding.

    qparams = quantize_params(params)   # llama tree -> int8 tree
    ServingEngine(qparams, config)      # same entry points

Dense matrices multiply as (x @ q) * s (`matmul`); MoE expert stacks go to
the grouped matmul kernels as int8 (models/moe.py). Training never sees a
quantized tree.

Under a mesh a tree is quantized whole and then sharded (`shard_tree` with
`llama.param_specs`): `q` takes the weight's spec and `s` the spec without
the contracted dim (parallel/mesh.py `scale_dims`), so a rank's scales
are the whole matrix's for its output columns. Quantizing each shard would
give a row-parallel weight (`wo`, `w2`) other scales, its amax running over
a part of the input dim. A rank applies `s` after its local contraction and
before the sum over the tensor axis: exact, `s` being constant per column.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

_QKEYS = frozenset({"q", "s"})


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and frozenset(leaf) == _QKEYS


def _quantize_cols(wf: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    """Symmetric int8 over `dim` (the input dim) of an f32 tensor."""
    amax = wf.abs().amax(dim=dim)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).to(torch.bfloat16)
    q = torch.round(wf / s.float().unsqueeze(dim)).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: w [in, out] -> q int8 [in, out],
    s bf16 [out] with s = max|w[:, c]| / 127 (1 for a zero column)."""
    if w.dim() != 2:
        raise ValueError(f"quantize expects a 2-D matrix, got shape {tuple(w.shape)}")
    return _quantize_cols(w.float(), 0)


def dequantize(leaf: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    return (leaf["q"].float() * leaf["s"].float()).to(dtype)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain or quantized [in, out] weight; the scale applies
    to the output columns after the contraction (exact: s is constant per
    column)."""
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w


# the 2-D matmul operands of a layer; norms, biases and the embedding table
# (a row gather) stay as they are, the LM head is quantized
_LAYER_MATS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def quantize_stack(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-expert per-output-channel int8 for [E, in, out] stacks:
    q int8 [E, in, out], s bf16 [E, out]."""
    if w.dim() != 3:
        raise ValueError(f"quantize_stack expects [E, in, out], got {tuple(w.shape)}")
    return _quantize_cols(w.float(), 1)


def quantize_layer(layer: Dict) -> Dict:
    """One decoder layer with int8 matrix leaves; MoE expert stacks
    quantize per expert, the router stays f32."""
    out = {}
    for name, leaf in layer.items():
        if name in _LAYER_MATS:
            out[name] = quantize(leaf)
        elif name == "moe":
            out[name] = {k: (quantize_stack(v) if k in ("w1", "w3", "w2") else v)
                         for k, v in leaf.items()}
        else:
            out[name] = leaf
    return out


def quantize_params(params: Dict) -> Dict:
    """Llama parameter tree -> the same tree with int8 matrix leaves. The
    embedding stays as it is (with tied embeddings the head reads embed.T,
    so only the layers shrink)."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": [quantize_layer(layer) for layer in params["layers"]]}
    if "lm_head" in params:
        out["lm_head"] = quantize(params["lm_head"])
    return out


def tree_bytes(params) -> int:
    """Stored bytes of every leaf of a (quantized or plain) tree, the
    never-quantized embedding and norms included."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    return params.numel() * params.element_size()
