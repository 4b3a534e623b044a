"""Ring attention: context-parallel attention over the mesh "context" axis
(the port of kubedl_tpu/ops/ring_attention.py).

The sequence is cut into blocks over the axis, rank i holding positions
i*t .. (i+1)*t - 1 of q, k and v. Each rank keeps its queries; K and V
travel around the ring, one hop a step (stacked into one tensor, so every
rank posts the same send and receive in the same order, forward and
backward: parallel/collectives.py `ppermute`), and the partial attentions
against each arriving chunk merge through their log-sum-exp, so the
softmax is exact whatever the order.

Causal masking is by global position: a chunk wholly in the past is
attended in full, the rank's own chunk takes the triangular mask, and a
chunk wholly in the future is skipped (the reference merges it with
weight 0, which changes nothing). Each chunk step runs under
non-reentrant torch.utils.checkpoint, as the reference's jax.checkpoint,
so the backward recomputes a chunk's [t, t] scores instead of keeping one
for every chunk. A skipped chunk's hop still gets a (zero) gradient, so
the reverse hops of the backward pair up on every rank.

The chunk attention is plain torch, as the reference's is plain jnp: two
products on f32 copies of the operands (the reference accumulates in f32)
and an online softmax; the probabilities are rounded to v's dtype before
the second product, as the reference rounds them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from kubedl_tpu_torch.parallel import collectives
from kubedl_tpu_torch.parallel.mesh import axis_size

NEG_INF = -1e30
FULL, DIAGONAL, SKIP = 0, 1, 2  # the causal modes of a chunk


def _chunk_attention(q, k, v, sm_scale: float, causal_mode: int, q_offset: int,
                     k_offset: int):
    """Partial attention of the local queries against one K/V chunk:
    (out [b, h, tq, d] f32, lse [b, h, tq] f32). causal_mode: FULL (the
    chunk wholly in the past) or DIAGONAL (triangular mask by global
    position); the ring skips a chunk wholly in the future."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal_mode == DIAGONAL:
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = m.clamp_min(NEG_INF / 2)  # fully masked rows: keep exp() finite
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, NEG_INF))
    out = torch.where(l[..., None] > 0, out / l[..., None].clamp_min(1e-30),
                      torch.zeros_like(out))
    return out, lse


def _merge(o1, lse1, o2, lse2):
    """Merge two partial attentions through their log-sum-exp."""
    m = torch.maximum(lse1, lse2).clamp_min(NEG_INF / 2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    tot = (w1 + w2).clamp_min(1e-30)
    out = (o1 * w1[..., None] + o2 * w2[..., None]) / tot[..., None]
    return out, m + torch.log(tot)


class _Keep(torch.autograd.Function):
    """Identity on x that gives y a zero gradient: a hop whose chunk the
    rank skips still runs its backward, so every rank posts the reverse
    hop (a collective) the same number of times, in the same order."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.like = (y.shape, y.dtype, y.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.like
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _mode(kv_idx: int, my_idx: int, causal: bool) -> int:
    if not causal or kv_idx < my_idx:
        return FULL
    return DIAGONAL if kv_idx == my_idx else SKIP


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   axis_name: str = "context", causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Context-parallel attention over this rank's sequence block of
    [batch, heads, t, head_dim] tensors (the heads and rows of the rank's
    tensor and batch shards); the result is its block of the output, in
    q's dtype. K and V come with q's head count: the caller repeats GQA's
    KV heads (models/llama.py does), as in the reference. Without a mesh or
    with the axis of size 1 this is plain attention of the block."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    n = axis_size(mesh, axis_name) if mesh is not None else 1
    my_idx = mesh.get_local_rank(axis_name) if n > 1 else 0
    b, h, tq, d = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    remat = torch.is_grad_enabled()
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        kv_idx = (my_idx - step) % n
        mode = _mode(kv_idx, my_idx, causal)
        if mode != SKIP:
            args = (q, kv[0], kv[1], sm_scale, mode, my_idx * tq, kv_idx * tq)
            o_c, lse_c = (checkpoint(_chunk_attention, *args, use_reentrant=False)
                          if remat else _chunk_attention(*args))
            o, lse = _merge(o, lse, o_c, lse_c)
        elif step == n - 1:  # the last hop feeds no chunk: keep it in the graph
            o = _Keep.apply(o, kv)
        if step < n - 1:  # the last chunk needs no further hop
            kv = collectives.ppermute(kv, mesh, axis_name, perm)
    return o.to(q.dtype)
