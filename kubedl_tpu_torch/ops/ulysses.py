"""Ulysses sequence parallelism: an all-to-all swaps sequence for heads
(the port of kubedl_tpu/ops/ulysses.py).

The second long-context strategy beside ops/ring_attention.py. Where the
ring keeps the queries and rotates K/V around the context axis, Ulysses
swaps: the sequence-sharded [b, h, t/P, d] projections become
head-sharded [b, h/P, t, d] (one tiled all-to-all, q, k and v stacked
into one tensor), each rank runs ordinary attention over the whole
sequence for its head group (the flash kernels, K1 forward and K2/K3
backward on a CUDA tensor), and one all-to-all swaps the output back.
Each token's q, k, v and output cross the axis once, whatever the
sequence length; the parallelism is capped by the heads, and a rank holds
the full sequence's attention for its heads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from kubedl_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from kubedl_tpu_torch.parallel import collectives
from kubedl_tpu_torch.parallel.mesh import axis_size


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                      axis_name: str = "context", causal: bool = True,
                      sm_scale: Optional[float] = None,
                      use_flash: bool = False) -> torch.Tensor:
    """Sequence-parallel attention over this rank's sequence block of
    [batch, heads, t, head_dim] tensors (its tensor shard's heads); the
    result is its block of the output. The heads must divide by the
    context axis (ValueError otherwise, with the reference's message).
    K and V come with q's head count (the caller repeats GQA's KV heads).
    `use_flash` runs ops/flash_attention.py `flash_attention`, else
    `attention_reference`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ctx = axis_size(mesh, axis_name) if mesh is not None else 1
    local_heads = q.shape[1]
    if local_heads % ctx != 0:
        raise ValueError(
            f"ulysses needs heads-per-tensor-shard ({local_heads}) divisible "
            f"by the context axis ({ctx}); use ring attention instead")
    # [3, b, h, t/P, d] -> [3, b, h/P, t, d]: split heads, gather the sequence
    qkv = collectives.all_to_all_tiled(torch.stack([q, k, v]), mesh, axis_name,
                                       split_dim=2, concat_dim=3)
    attend = flash_attention if use_flash else attention_reference
    o = attend(qkv[0], qkv[1], qkv[2], causal=causal, sm_scale=sm_scale)
    return collectives.all_to_all_tiled(o, mesh, axis_name, split_dim=2, concat_dim=1)
