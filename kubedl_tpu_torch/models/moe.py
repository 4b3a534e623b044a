"""Mixture-of-Experts FFN on one device (kubedl_tpu/models/moe.py).

Top-k softmax routing and Mixtral's SwiGLU experts, in the JAX module's two
single-device forms:

  * dropless (the default): the routed (token, choice) entries are sorted by
    expert into row-tile-padded runs (`_dispatch_plan`, `_permute`) and the
    expert FFN runs through the grouped matrix products of ops/gmm.py —
    `gmm_swiglu` for silu(x @ w1) * (x @ w3), then `gmm` (or `gmm_scaled`
    for int8 stacks) through w2 — so a CUDA tensor runs the hand-written
    kernels and nothing is dropped;
  * the capacity path (`dropless=False`): per-expert slots up to a capacity,
    plain einsums, tokens past capacity dropped (Switch semantics).

Both return the GShard load-balance aux loss E * sum(me * ce). Routing is
index arithmetic (stable argsort, cumulative sums, searchsorted) that stays
on the device: nothing on the dropless path reads a value back to the host,
so a decode tick never waits on it. int8 expert stacks ({"q", "s"},
models/quant.py) go to the kernels as int8.

Not ported yet: the expert-parallel routes (`mesh`, `rules`, `a2a_chunks`,
`moe_param_specs`, `_dropless_shard_fn`, `_dropless_mlp_sharded`), which wait
for the sharded slice (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kubedl_tpu_torch.ops.gmm import TILE_M, gmm, gmm_scaled, gmm_swiglu
from kubedl_tpu_torch.utils.device import resolve_device


def moe_init(d_model: int, d_ff: int, n_experts: int, dtype=torch.bfloat16,
             generator: Optional[torch.Generator] = None, device="cuda") -> Dict:
    """One MoE FFN layer: router [d, E] in f32 (tiny, and gating is
    precision-sensitive), w1 and w3 [E, d, ff], w2 [E, ff, d], truncated
    normal in [-2, 2] over sqrt(fan_in), each drawn in f32 on `device`."""
    dev = resolve_device(device)

    def dense(shape, fan_in, dt):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (w * (1.0 / math.sqrt(fan_in))).to(dt)

    return {
        "router": dense((d_model, n_experts), d_model, torch.float32),
        "w1": dense((n_experts, d_model, d_ff), d_model, dtype),
        "w3": dense((n_experts, d_model, d_ff), d_model, dtype),
        "w2": dense((n_experts, d_ff, d_model), d_ff, dtype),
    }


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    return max(1, int(np.ceil(top_k * n_tokens / n_experts * capacity_factor)))


def _counts(ids, e: int):
    """[e] int64 number of entries per id in [0, e); ids == e are dropped.
    A compare-and-sum, so no atomics and no host sync."""
    return (ids.long()[:, None] == torch.arange(e, device=ids.device)).sum(dim=0)


def _exclusive_cumsum(x):
    return torch.cumsum(x, dim=0) - x


def _top_k_gating(gate_logits, top_k: int, capacity: int, need_slots: bool = True):
    """Routing as indices: (experts [k, S] i32, slots [k, S] i32, weights
    [k, S] f32, keeps [k, S] bool, (me, ce)).

    One top-k over the router probabilities picks all k choices (choice-
    major: row 0 is every token's first choice); the slot is the entry's
    position in one stable sort of the k*S entries by expert, so all first
    choices claim slots before any second choice. The weights are
    renormalised over the kept choices. `need_slots=False` skips the sort
    for the dropless route: slots zero, keeps all true. (torch.topk does not
    promise lax.top_k's lower-index-first order on exact ties; router
    probabilities from real-valued logits do not tie.)"""
    s, e = gate_logits.shape
    dev = gate_logits.device
    probs = torch.softmax(gate_logits, dim=-1)
    topv, topi = torch.topk(probs, top_k, dim=-1)  # [S, k], descending
    experts = topi.T.to(torch.int32)
    gates = topv.T.float()
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, experts[0].long(), torch.full((s,), 1.0 / s, dtype=torch.float32, device=dev))
    if not need_slots:
        weights = gates / gates.sum(dim=0, keepdim=True).clamp_min(1e-9)
        return (experts, torch.zeros((top_k, s), dtype=torch.int32, device=dev),
                weights, torch.ones((top_k, s), dtype=torch.bool, device=dev), (me, ce))
    ks = top_k * s
    ef = experts.reshape(ks).long()
    order = torch.argsort(ef, stable=True)
    sorted_ef = ef[order]
    starts = _exclusive_cumsum(_counts(ef, e))
    pos = torch.arange(ks, device=dev) - starts[sorted_ef]
    slots = torch.empty(ks, dtype=torch.long, device=dev)
    slots[order] = pos
    slots = slots.reshape(top_k, s).to(torch.int32)
    keeps = slots < capacity
    weights = gates * keeps
    weights = weights / weights.sum(dim=0, keepdim=True).clamp_min(1e-9)
    return experts, slots, weights, keeps, (me, ce)


def _top_k_gating_reference(gate_logits, top_k: int, capacity: int):
    """The iterative argmax / one-hot / cumsum gating, k [S, E] mask planes
    a call: the parity reference for `_top_k_gating`."""
    s, e = gate_logits.shape
    probs = torch.softmax(gate_logits, dim=-1)
    remaining = probs
    masks, gates, experts = [], [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        onehot = F.one_hot(idx, e).float()
        experts.append(idx.to(torch.int32))
        masks.append(onehot)
        gates.append((probs * onehot).sum(dim=-1))
        remaining = remaining * (1.0 - onehot)
    me = probs.mean(dim=0)
    ce = masks[0].mean(dim=0)
    slots, keeps = [], []
    pos_offset = torch.zeros(e, dtype=torch.float32, device=probs.device)
    for m in masks:
        pos_in_expert = torch.cumsum(m, dim=0) - m + pos_offset  # [S, E]
        pos_offset = pos_offset + m.sum(dim=0)
        slot = (pos_in_expert * m).sum(dim=-1)
        slots.append(slot.to(torch.int32))
        keeps.append(slot < capacity)
    weights = torch.stack(gates) * torch.stack(keeps)
    weights = weights / weights.sum(dim=0, keepdim=True).clamp_min(1e-9)
    return (torch.stack(experts), torch.stack(slots), weights, torch.stack(keeps),
            (me, ce))


# ---------------------------------------------------------------------------
# dropless dispatch stages: plan -> permute -> ffn -> gather
# ---------------------------------------------------------------------------


def _row_tile(m: int, e: int) -> int:
    """Row tile of the padded layout: the gmm kernels read one [K, N]
    weight block per row tile, so wider tiles cut weight traffic; the price
    is up to e * tile padding rows, capped at ~1/8 of the real rows."""
    for tm in (512, 256):
        if e * tm * 8 <= m:
            return tm
    return TILE_M


def _dispatch_plan(eid, e: int):
    """Lay out M routed entries as per-expert row-tile-padded runs:
    (order [M], dest [M], pos_of_entry [M], tile_expert [m_pad // tile] i32,
    m_pad). `order` is the stable expert sort of the entries, `dest` the
    padded row of the p-th sorted entry (sentinel entries, eid == e, point
    at row m_pad), `pos_of_entry` the padded row of each original entry;
    tiles past the real rows clamp to the last expert and hold zero rows.
    m_pad = round_up(M, tile) + e * tile is fixed by the shapes alone."""
    m = eid.shape[0]
    dev = eid.device
    tile = _row_tile(m, e)
    eid = eid.long()
    order = torch.argsort(eid, stable=True)
    sorted_eid = eid[order]
    group_sizes = _counts(eid, e)
    pad_sizes = (group_sizes + tile - 1) // tile * tile
    cum_pad = torch.cumsum(pad_sizes, dim=0)
    pad_offsets = cum_pad - pad_sizes
    grp_offsets = _exclusive_cumsum(group_sizes)
    real_eid = sorted_eid.clamp(0, e - 1)
    pos_in_group = torch.arange(m, device=dev) - grp_offsets[real_eid]
    m_pad = (m + tile - 1) // tile * tile + e * tile
    dest = torch.where(sorted_eid < e, pad_offsets[real_eid] + pos_in_group,
                       torch.full_like(sorted_eid, m_pad))
    tile_starts = torch.arange(m_pad // tile, device=dev) * tile
    tile_expert = torch.searchsorted(cum_pad, tile_starts, right=True).clamp(
        0, e - 1).to(torch.int32)
    pos_of_entry = torch.empty(m, dtype=torch.long, device=dev)
    pos_of_entry[order] = dest
    return order, dest, pos_of_entry, tile_expert, m_pad


def _permute(src, src_rows, order, dest, m_pad: int):
    """Gather the routed rows into the padded expert-sorted layout. The
    buffer has one extra row that takes the sentinel entries' writes and is
    cut off, as the JAX scatter's mode="drop" discards them."""
    x = src.new_zeros((m_pad + 1, src.shape[1]))
    x = x.index_put((dest,), src[src_rows[order]])
    return x[:m_pad]


def _ffn_rows(x, tile_expert, params: Dict, fused: bool = True,
              row_tile: Optional[int] = None):
    """The expert SwiGLU FFN on the padded layout [m_pad, d]. fused=True:
    `gmm_swiglu` then `gmm`/`gmm_scaled`, one [m_pad, ff] intermediate;
    fused=False: the three-product reference path. int8 stacks keep their
    per-expert [E, out] scales in the kernels' epilogues."""
    if row_tile is None:
        # x and tile_expert come from the same _dispatch_plan
        row_tile = x.shape[0] // tile_expert.shape[0]
    w1, w3, w2 = params["w1"], params["w3"], params["w2"]
    if isinstance(w1, dict):
        q1, q3, q2 = w1["q"], w3["q"], w2["q"]
        s1, s3, s2 = w1["s"].float(), w3["s"].float(), w2["s"].float()
        if fused:
            h = gmm_swiglu(x, q1, q3, tile_expert, s1, s3, row_tile=row_tile)
        else:
            gate = F.silu(gmm_scaled(x, q1, tile_expert, s1, row_tile=row_tile)
                          .float()).to(x.dtype)
            up = gmm_scaled(x, q3, tile_expert, s3, row_tile=row_tile)
            h = gate * up
        return gmm_scaled(h, q2, tile_expert, s2, row_tile=row_tile)
    if fused:
        ones = torch.ones((w1.shape[0], w1.shape[-1]), dtype=torch.float32,
                          device=x.device)
        h = gmm_swiglu(x, w1, w3, tile_expert, ones, ones, row_tile=row_tile)
    else:
        gate = F.silu(gmm(x, w1, tile_expert, row_tile=row_tile).float()).to(x.dtype)
        up = gmm(x, w3, tile_expert, row_tile=row_tile)
        h = gate * up
    return gmm(h, w2, tile_expert, row_tile=row_tile)


def _gmm_ffn(src, src_rows, eid, params: Dict, e: int, fused: bool = True):
    """Route M rows through their experts' FFN: [M, d] outputs aligned to
    the input entries; sentinel entries (eid == e) come back as zeros."""
    d = src.shape[1]
    order, dest, pos_of_entry, tile_expert, m_pad = _dispatch_plan(eid, e)
    x = _permute(src, src_rows, order, dest, m_pad)
    rows = _ffn_rows(x, tile_expert, params, fused=fused)
    # entry p's output is padded row dest[p]; the sentinel row m_pad is zero
    rows = torch.cat([rows, rows.new_zeros((1, d))], dim=0)
    return rows[pos_of_entry]


def _combine(rows, weights, out_dtype):
    """Weighted sum of each token's k expert outputs (entry f = choice*S +
    token), in out_dtype."""
    k, s = weights.shape
    y = torch.zeros((s, rows.shape[1]), dtype=out_dtype, device=rows.device)
    for kk in range(k):
        y = y + weights[kk][:, None].to(out_dtype) * rows[kk * s:(kk + 1) * s]
    return y


def _dropless_mlp(hf, params: Dict, experts, weights, e: int, fused: bool = True):
    """Single-device dropless dispatch over hf [S, d]: the work scales with
    the routed rows (k*S + E*tile), and nothing is dropped."""
    s = hf.shape[0]
    k = experts.shape[0]
    ef = experts.reshape(k * s)
    src_rows = torch.arange(s, dtype=torch.long, device=hf.device).repeat(k)
    rows = _gmm_ffn(hf, src_rows, ef, params, e, fused=fused)
    return _combine(rows, weights, hf.dtype)


def _emm(x, w, eq: str):
    """Batched expert einsum; int8 stacks apply their [E, out] scale after
    the contraction (exact: the scale is constant per output column)."""
    if isinstance(w, dict):
        return torch.einsum(eq, x, w["q"].to(x.dtype)) * w["s"].to(x.dtype)[:, None, :]
    return torch.einsum(eq, x, w)


def moe_mlp(h, params: Dict, *, top_k: int = 2, capacity_factor: float = 1.25,
            dropless: Optional[bool] = None,
            fused: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output [b, t, d], aux load-balance loss) for normed hidden states h.

    dropless=None means True (there is no mesh in the port yet): the grouped
    product route, every token kept. dropless=False takes the capacity path,
    where capacity_factor bounds each expert's slots. fused=None means True:
    the fused SwiGLU kernel; False the three-product reference path."""
    b, t, d = h.shape
    s = b * t
    w1 = params["w1"]
    e = (w1["q"] if isinstance(w1, dict) else w1).shape[0]
    c = expert_capacity(s, e, top_k, capacity_factor)
    if dropless is None:
        dropless = True
    if fused is None:
        fused = True
    hf = h.reshape(s, d)
    gate_logits = hf.float() @ params["router"]
    if dropless:
        experts, _, gates, _, (me, ce) = _top_k_gating(
            gate_logits, top_k, s + 1, need_slots=False)
        y = _dropless_mlp(hf, params, experts, gates, e, fused=fused)
        return y.reshape(b, t, d), e * (me * ce).sum()
    experts, slots, weights, keeps, (me, ce) = _top_k_gating(gate_logits, top_k, c)
    aux = e * (me * ce).sum()
    # tokens -> expert slots by index: dropped tokens and unfilled slots
    # point at the zero row s; the extra slot e*c takes the dropped writes
    flat = torch.where(keeps, experts.long() * c + slots.long(),
                       torch.full_like(experts, e * c, dtype=torch.long))
    token_of_slot = torch.full((e * c + 1,), s, dtype=torch.long, device=h.device)
    arange_s = torch.arange(s, dtype=torch.long, device=h.device)
    for k in range(flat.shape[0]):
        token_of_slot[flat[k]] = arange_s
    hf_pad = torch.cat([hf, hf.new_zeros((1, d))], dim=0)
    expert_in = hf_pad[token_of_slot[:e * c]].reshape(e, c, d)
    gate = F.silu(_emm(expert_in, params["w1"], "ecd,edf->ecf").float()).to(h.dtype)
    up = _emm(expert_in, params["w3"], "ecd,edf->ecf")
    out = _emm(gate * up, params["w2"], "ecf,efd->ecd")
    # expert slots -> tokens: k weighted gathers
    out_pad = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))], dim=0)
    y = torch.zeros((s, d), dtype=h.dtype, device=h.device)
    for k in range(flat.shape[0]):
        y = y + weights[k][:, None].to(h.dtype) * out_pad[flat[k]]
    return y.reshape(b, t, d), aux
