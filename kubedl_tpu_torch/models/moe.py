"""Mixture-of-Experts FFN (kubedl_tpu/models/moe.py), on one device and
expert-parallel over a DeviceMesh.

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

Under a mesh of more than one device (`mesh`, `rules`; the layer gets its
rank's rows and the local views of its leaves, laid out by
`moe_param_specs`) the two routes are the JAX module's sharded ones:

  * dropless (`_dropless_mlp_sharded`, `_dropless_shard_fn`): each rank
    routes its own rows, packs them by destination expert shard into
    `quota`-row slots (entries past a shard's quota drop, as in the JAX
    module), one `all_to_all_single` over the expert axis lands them on the
    shard that owns their expert, the local `_gmm_ffn` runs K5 and K6 (K7
    and K6 in the backward) on its experts, and the reverse all-to-all
    brings the outputs home; `a2a_chunks` splits the quota into chunks;
  * the capacity path: the rows of every token block are gathered, so the
    slots are the global ones of the one-device path, each expert shard
    computes its experts' slots and the outputs are gathered over the
    expert axis for the combine.

Both sum their partial FFN outputs over the tensor axis when it shards
the experts' `mlp` columns, and average the load-balance statistics over
the token blocks. With a context axis the layer first gathers its rows'
whole sequence (routing, slots and quotas are those of the JAX module's
rows, which XLA gathers over context too), runs the route on it and keeps
its own block of the output; the context peers' aux losses are one value,
each peer's part of it 1 / the peers.

Decode and serving under a mesh take neither sharded route (`moe_mlp_decode`):
every rank holds the whole batch, routes it as one device does and computes
its own experts' and `mlp` columns' part, one sum over the expert and tensor
axes after.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kubedl_tpu_torch.ops.gmm import TILE_M, gmm, gmm_scaled, gmm_swiglu
from kubedl_tpu_torch.parallel import collectives
from kubedl_tpu_torch.parallel.mesh import (ShardingRules, axes_index, axes_size,
                                            axis_size, live_axes, token_axes, token_index)
from kubedl_tpu_torch.utils.device import resolve_device


def moe_param_specs(rules: Optional[ShardingRules] = None) -> Dict:
    """PartitionSpec tree matching moe_init() for one MoE FFN layer."""
    r = rules or ShardingRules()
    return {
        "router": r.spec("embed", "expert"),
        "w1": r.spec("expert", "embed", "mlp"),
        "w3": r.spec("expert", "embed", "mlp"),
        "w2": r.spec("expert", "mlp", "embed"),
    }


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


def _expert_axis(mesh, rules: ShardingRules) -> str:
    axes = rules.axes("expert")
    if len(axes) != 1:
        raise ValueError(f"expert parallelism needs exactly one expert mesh axis, "
                         f"got {axes}")
    return axes[0]


def _mlp_axes(mesh, rules: ShardingRules, tok) -> Tuple[str, ...]:
    """The live axes that shard the experts' mlp columns; the tokens must
    be replicated over them (their psum completes the FFN)."""
    mlp = live_axes(mesh, rules.axes("mlp"))
    if set(mlp) & set(tok):
        raise ValueError(f"mlp axes {mlp} overlap token axes {tuple(tok)}; "
                         f"expert x tensor parallelism needs disjoint mesh axes")
    return mlp


def _dropless_shard_fn(hf_loc, params: Dict, *, top_k: int, e: int, e_loc: int,
                       n_e: int, quota: int, mesh, expert_axis: str, token_axes,
                       tensor_axes=(), fused: bool = True, a2a_chunks: int = 1,
                       stats: Optional[Dict] = None):
    """One rank's body of the expert-parallel dropless route (the JAX
    module's shard_map body, with explicit collectives): (y [S_loc, d],
    aux). Rows are sharded over `token_axes` (the batch axes, then the
    expert axis), expert blocks over `expert_axis`.

    This rank's k*S_loc (token, choice) entries are sorted by expert, so
    the runs bound for one expert shard are contiguous, and each run is
    packed into that shard's `quota`-row slot of an [n_e, quota, d] buffer;
    entries past the quota drop (their weight renormalized over the kept
    choices). One all_to_all over the expert axis lands every entry on the
    shard that owns its expert, the local `_gmm_ffn` computes the received
    rows, and the reverse all_to_all returns the outputs for the weighted
    combine. `a2a_chunks > 1` splits the quota into chunks of whole row
    tiles, each sent, computed and returned in turn: the same rows, slots
    and weights. `stats`, when given, receives the routing and dispatch
    integers (experts, kept, slot_of_entry)."""
    s_loc, d = hf_loc.shape
    k = top_k
    ks = k * s_loc
    dev = hf_loc.device
    gate_logits = hf_loc.float() @ params["router"]
    experts, _, gates, _, (me, ce) = _top_k_gating(gate_logits, k, s_loc + 1,
                                                   need_slots=False)
    # load-balance loss over the global means: the token blocks partition
    # the tokens into equal parts
    n_tok = axes_size(mesh, token_axes)
    me = collectives.psum(me, mesh, token_axes) / n_tok
    ce = collectives.psum(ce, mesh, token_axes) / n_tok
    aux = e * (me * ce).sum()

    ef = experts.reshape(ks).long()  # flat entry f = choice*S_loc + token
    src_rows = torch.arange(s_loc, dtype=torch.long, device=dev).repeat(k)
    order = torch.argsort(ef, stable=True)  # by expert, so by shard too
    sorted_ef = ef[order]
    sorted_dest = sorted_ef // e_loc
    shard_offsets = _exclusive_cumsum(_counts(ef // e_loc, n_e))
    pos = torch.arange(ks, device=dev) - shard_offsets[sorted_dest]
    kept_sorted = pos < quota  # entries past the shard quota drop
    slot = torch.where(kept_sorted, sorted_dest * quota + pos,
                       torch.full_like(pos, n_e * quota))
    # one extra row takes the dropped entries' writes and is cut off
    send_x = hf_loc.new_zeros((n_e * quota + 1, d)).index_put(
        (slot,), hf_loc[src_rows[order]])[:-1]
    send_eid = torch.full((n_e * quota + 1,), e, dtype=torch.int32, device=dev).index_put(
        (slot,), sorted_ef.to(torch.int32))[:-1]

    ei = mesh.get_local_rank(expert_axis) if n_e > 1 else 0
    send_xs = send_x.reshape(n_e, quota, d)
    send_es = send_eid.reshape(n_e, quota)
    # chunk count: a divisor of the quota's row tiles, so every chunk keeps
    # whole TILE_M runs
    q_tiles = max(quota // TILE_M, 1)
    nc = next(c for c in range(min(max(a2a_chunks, 1), q_tiles), 0, -1) if q_tiles % c == 0)
    qc = quota // nc
    backs = []
    for ci in range(nc):
        rx = collectives.all_to_all(send_xs[:, ci * qc:(ci + 1) * qc].contiguous(),
                                    mesh, expert_axis)
        with torch.no_grad():
            re = collectives.all_to_all(send_es[:, ci * qc:(ci + 1) * qc].contiguous(),
                                        mesh, expert_axis)
        flat_eid = re.reshape(n_e * qc).long()
        local_eid = torch.where(flat_eid < e, flat_eid - ei * e_loc,
                                torch.full_like(flat_eid, e_loc))
        rows = collectives.enter(rx.reshape(n_e * qc, d), mesh, tensor_axes)
        y_rows = _gmm_ffn(rows, torch.arange(n_e * qc, dtype=torch.long, device=dev),
                          local_eid, params, e_loc, fused=fused)
        # tensor-parallel experts: each shard's output is a partial sum over
        # its mlp columns, and the tokens are replicated over the tensor axes
        y_rows = collectives.psum(y_rows, mesh, tensor_axes)
        backs.append(collectives.all_to_all(y_rows.reshape(n_e, qc, d), mesh, expert_axis))
    back = backs[0] if nc == 1 else torch.cat(backs, dim=1)

    # combine at home: entry f's reply sits at slot_of_entry[f]; dropped
    # entries point at the appended zero row
    slot_of_entry = torch.empty(ks, dtype=torch.long, device=dev)
    slot_of_entry[order] = slot
    kept = torch.empty(ks, dtype=torch.bool, device=dev)
    kept[order] = kept_sorted
    kept = kept.reshape(k, s_loc)
    weights = gates * kept
    weights = weights / weights.sum(dim=0, keepdim=True).clamp_min(1e-9)
    back_flat = torch.cat([back.reshape(n_e * quota, d), back.new_zeros((1, d))], dim=0)
    y = torch.zeros((s_loc, d), dtype=hf_loc.dtype, device=dev)
    for kk in range(k):
        rows_k = back_flat[slot_of_entry[kk * s_loc:(kk + 1) * s_loc]]
        y = y + weights[kk][:, None].to(hf_loc.dtype) * rows_k
    if stats is not None:
        stats.update(experts=experts, kept=kept, slot_of_entry=slot_of_entry)
    return y, aux


def _dropless_mlp_sharded(hf, params: Dict, *, top_k: int, quota_factor: float, mesh,
                          rules: ShardingRules, e: int, fused: bool = True,
                          a2a_chunks: int = 1, stats: Optional[Dict] = None):
    """Expert-parallel dropless MoE over `mesh`: hf [S_loc, d] is this
    rank's block of the token rows (sharded over the batch axes x the
    expert axis), `params` its local views (the router whole, its e/n_e
    experts, its mlp columns). Two all_to_alls over the expert axis; the
    rows a rank computes scale with the quota (~ routed rows / n_e x
    quota_factor), not with a per-expert capacity."""
    expert_axis = _expert_axis(mesh, rules)
    tok = live_axes(mesh, token_axes(rules))
    n_e = axis_size(mesh, expert_axis)
    if e % n_e:
        raise ValueError(f"{e} experts not divisible by expert axis {expert_axis}={n_e}")
    e_loc = e // n_e
    w1 = params["w1"]
    if (w1["q"] if isinstance(w1, dict) else w1).shape[0] != e_loc:
        raise ValueError(f"params hold {(w1['q'] if isinstance(w1, dict) else w1).shape[0]} "
                         f"experts, the expert shard {e_loc}")
    ks_loc = top_k * hf.shape[0]
    quota = int(math.ceil(ks_loc * quota_factor / n_e / TILE_M)) * TILE_M
    return _dropless_shard_fn(
        hf, params, top_k=top_k, e=e, e_loc=e_loc, n_e=n_e, quota=quota, mesh=mesh,
        expert_axis=expert_axis, token_axes=tok, tensor_axes=_mlp_axes(mesh, rules, tok),
        fused=fused, a2a_chunks=a2a_chunks, stats=stats)


def _capacity_mlp_sharded(hf, params: Dict, *, top_k: int, capacity_factor: float, mesh,
                          rules: ShardingRules, e: int):
    """The capacity path over `mesh`: (y [S_loc, d] for this rank's rows,
    aux). The token blocks are gathered in their global order, so routing,
    slots and drops are the one-device path's over the global batch; each
    expert shard computes its experts' slots (partial sums over the mlp
    columns, summed over the tensor axis) and the slot outputs are gathered
    over the expert axis for the weighted combine of this rank's rows."""
    expert_axis = _expert_axis(mesh, rules)
    tok = live_axes(mesh, token_axes(rules))
    mlp = _mlp_axes(mesh, rules, tok)
    tok_index, n_tok = token_index(mesh, rules)
    s_loc, d = hf.shape
    s = s_loc * n_tok
    c = expert_capacity(s, e, top_k, capacity_factor)
    router = params["router"]
    hf_all = collectives.all_gather(hf, mesh, tok)
    experts, slots, weights, keeps, _ = _top_k_gating(hf_all.float() @ router, top_k, c)
    # the load-balance statistics of this rank's rows, averaged over the
    # token blocks (the global means)
    lo = tok_index * s_loc
    me = torch.softmax(hf.float() @ router, dim=-1).mean(dim=0)
    me = collectives.psum(me, mesh, tok) / n_tok
    ce = _counts(experts[0, lo:lo + s_loc], e).float() / s_loc
    ce = collectives.psum(ce, mesh, tok) / n_tok
    aux = e * (me * ce).sum()

    w1 = params["w1"]
    e_loc = (w1["q"] if isinstance(w1, dict) else w1).shape[0]
    xi = mesh.get_local_rank(expert_axis) if axis_size(mesh, expert_axis) > 1 else 0
    flat = torch.where(keeps, experts.long() * c + slots.long(),
                       torch.full_like(experts, e * c, dtype=torch.long))
    token_of_slot = torch.full((e * c + 1,), s, dtype=torch.long, device=hf.device)
    arange_s = torch.arange(s, dtype=torch.long, device=hf.device)
    for k in range(flat.shape[0]):
        token_of_slot[flat[k]] = arange_s
    hf_pad = torch.cat([hf_all, hf_all.new_zeros((1, d))], dim=0)
    expert_in = hf_pad[token_of_slot[xi * e_loc * c:(xi + 1) * e_loc * c]]
    expert_in = collectives.enter(expert_in.reshape(e_loc, c, d), mesh, mlp)
    gate = F.silu(_emm(expert_in, params["w1"], "ecd,edf->ecf").float()).to(hf.dtype)
    up = _emm(expert_in, params["w3"], "ecd,edf->ecf")
    out = collectives.psum(_emm(gate * up, params["w2"], "ecf,efd->ecd"), mesh, mlp)
    out = collectives.all_gather(out, mesh, live_axes(mesh, (expert_axis,)))
    out_pad = torch.cat([out.reshape(e * c, d), out.new_zeros((1, d))], dim=0)
    y = torch.zeros((s_loc, d), dtype=hf.dtype, device=hf.device)
    for k in range(flat.shape[0]):
        y = y + weights[k, lo:lo + s_loc][:, None].to(hf.dtype) * out_pad[flat[k, lo:lo + s_loc]]
    return y, aux


def _without(rules: ShardingRules, dim: str) -> ShardingRules:
    """The rules with logical dim `dim` mapped to no mesh axis."""
    return ShardingRules({**rules.rules, dim: ()})


def _emm(x, w, eq: str):
    """Batched expert einsum; int8 stacks apply their [E, out] scale after
    the contraction (exact: the scale is constant per output column)."""
    if isinstance(w, dict):
        return torch.einsum(eq, x, w["q"].to(x.dtype)) * w["s"].to(x.dtype)[:, None, :]
    return torch.einsum(eq, x, w)


def _slot_ffn(hf, params: Dict, experts, slots, keeps, c: int, first: int = 0):
    """The capacity route's expert FFN on one device's stacks: (out_pad
    [e_loc * c + 1, d], its last row zero; flat [k, S], each entry's row in
    it). The stacks hold experts [first, first + e_loc); entries dropped
    past capacity or routed to other experts point at the zero row."""
    e_loc = (params["w1"]["q"] if isinstance(params["w1"], dict) else params["w1"]).shape[0]
    s, d = hf.shape
    flat = torch.where(keeps, (experts.long() - first) * c + slots.long(),
                       torch.full_like(experts, -1, dtype=torch.long))
    flat = torch.where((flat >= 0) & (flat < e_loc * c), flat,
                       torch.full_like(flat, e_loc * c))
    # slots -> tokens by index: unfilled slots point at the zero row s; the
    # extra slot e_loc * c takes the other entries' writes
    token_of_slot = torch.full((e_loc * c + 1,), s, dtype=torch.long, device=hf.device)
    arange_s = torch.arange(s, dtype=torch.long, device=hf.device)
    for k in range(flat.shape[0]):
        token_of_slot[flat[k]] = arange_s
    hf_pad = torch.cat([hf, hf.new_zeros((1, d))], dim=0)
    expert_in = hf_pad[token_of_slot[:e_loc * c]].reshape(e_loc, c, d)
    gate = F.silu(_emm(expert_in, params["w1"], "ecd,edf->ecf").float()).to(hf.dtype)
    up = _emm(expert_in, params["w3"], "ecd,edf->ecf")
    out = _emm(gate * up, params["w2"], "ecf,efd->ecd")
    return torch.cat([out.reshape(e_loc * c, d), out.new_zeros((1, d))], dim=0), flat


def moe_mlp_decode(h, params: Dict, *, top_k: int = 2, capacity_factor: float = 1.25,
                   mesh=None, rules: Optional[ShardingRules] = None,
                   dropless: Optional[bool] = None,
                   fused: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of a decode or serving forward under a mesh: (output
    [b, t, d], aux). Every rank holds the whole batch (decode replicates it
    over the token axes) and routes it with the whole router, so the
    routing and dispatch integers are one device's on every rank; each rank
    computes its own experts' (the live expert axes) and its own mlp columns'
    (the live tensor axes) part, the k choices combined in f32, and one sum
    over those axes completes it. This is the route of the JAX package's
    decode, which runs the one-device MoE on the sharded tree: `dropless`
    None or True takes the grouped products (`_gmm_ffn`: K5, then K6 on bf16
    stacks or K8 on int8 ones), entries of another rank's experts being
    `_dispatch_plan`'s sentinel; False the capacity slots of the whole batch.
    With no live expert or tensor axis this is `moe_mlp` on one device."""
    rules = rules or ShardingRules()
    ex = live_axes(mesh, rules.axes("expert")) if mesh is not None else ()
    cols = live_axes(mesh, rules.axes("mlp")) if mesh is not None else ()
    if set(ex) & set(cols):
        raise ValueError(f"expert axes {ex} and mlp axes {cols} overlap")
    if not ex and not cols:
        return moe_mlp(h, params, top_k=top_k, capacity_factor=capacity_factor,
                       dropless=dropless, fused=fused)
    b, t, d = h.shape
    s = b * t
    e = params["router"].shape[-1]
    e_loc = e // axes_size(mesh, ex)
    first = axes_index(mesh, ex) * e_loc  # this rank's first expert
    hf = h.reshape(s, d)
    gate_logits = hf.float() @ params["router"]
    if dropless is None or dropless:
        experts, _, weights, _, (me, ce) = _top_k_gating(gate_logits, top_k, s + 1,
                                                         need_slots=False)
        local = experts.reshape(top_k * s).long() - first
        eid = torch.where((local >= 0) & (local < e_loc), local,
                          torch.full_like(local, e_loc))  # the sentinel
        src_rows = torch.arange(s, dtype=torch.long, device=h.device).repeat(top_k)
        rows = _gmm_ffn(hf, src_rows, eid, params, e_loc,
                        fused=True if fused is None else fused)
    else:
        c = expert_capacity(s, e, top_k, capacity_factor)
        experts, slots, weights, keeps, (me, ce) = _top_k_gating(gate_logits, top_k, c)
        out_pad, flat = _slot_ffn(hf, params, experts, slots, keeps, c, first)
        rows = out_pad[flat.reshape(-1)]
    y = collectives.psum(_combine(rows, weights, torch.float32), mesh, ex + cols)
    return y.to(h.dtype).reshape(b, t, d), e * (me * ce).sum()


def moe_mlp(h, params: Dict, *, top_k: int = 2, capacity_factor: float = 1.25,
            mesh=None, rules: Optional[ShardingRules] = None,
            dropless: Optional[bool] = None, fused: Optional[bool] = None,
            a2a_chunks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output [b, t, d], aux load-balance loss) for normed hidden states h.

    dropless=None (auto): the grouped product route, every token kept,
    when there is no mesh or a one-device one; under a mesh of more than
    one device the capacity path, as in the JAX module. dropless=True
    forces the grouped products: `_dropless_mlp` off-mesh, the expert-
    parallel `_dropless_mlp_sharded` on a mesh, where capacity_factor bounds
    the per-shard all-to-all quota instead of per-expert slots. fused=None
    means True: the fused SwiGLU kernel; False the three-product reference
    path. a2a_chunks splits the sharded dropless route's all-to-all quota.

    On a mesh, h holds this rank's rows (and, with a context axis, its
    block of their positions) and `params` the local views of the layer's
    leaves (the router whole, the rank's experts and mlp columns)."""
    seq = live_axes(mesh, (rules or ShardingRules()).axes("seq")) if mesh is not None else ()
    if seq:
        # the rows' whole sequence (the gradient reduce-scatters back); every
        # context peer routes it alike and keeps its own block
        n_ctx = axes_size(mesh, seq)
        full = collectives.all_gather(h.transpose(0, 1), mesh, seq).transpose(0, 1)
        y, aux = moe_mlp(full, params, top_k=top_k, capacity_factor=capacity_factor,
                         mesh=mesh, rules=_without(rules or ShardingRules(), "seq"),
                         dropless=dropless, fused=fused, a2a_chunks=a2a_chunks)
        t = h.shape[1]
        i = axes_index(mesh, seq)
        return y[:, i * t:(i + 1) * t], collectives.psum(aux / n_ctx, mesh, seq)
    b, t, d = h.shape
    s = b * t
    e = params["router"].shape[-1]
    if dropless is None:
        dropless = mesh is None or mesh.size() <= 1
    if fused is None:
        fused = True
    hf = h.reshape(s, d)
    if mesh is not None and mesh.size() > 1:
        rules = rules or ShardingRules()
        if dropless:
            y, aux = _dropless_mlp_sharded(
                hf, params, top_k=top_k, quota_factor=capacity_factor, mesh=mesh,
                rules=rules, e=e, fused=fused, a2a_chunks=a2a_chunks)
        else:
            y, aux = _capacity_mlp_sharded(hf, params, top_k=top_k,
                                           capacity_factor=capacity_factor,
                                           mesh=mesh, rules=rules, e=e)
        return y.reshape(b, t, d), aux
    c = expert_capacity(s, e, top_k, capacity_factor)
    gate_logits = hf.float() @ params["router"]
    if dropless:
        experts, _, gates, _, (me, ce) = _top_k_gating(
            gate_logits, top_k, s + 1, need_slots=False)
        y = _dropless_mlp(hf, params, experts, gates, e, fused=fused)
        return y.reshape(b, t, d), e * (me * ce).sum()
    experts, slots, weights, keeps, (me, ce) = _top_k_gating(gate_logits, top_k, c)
    # expert slots -> tokens: k weighted gathers
    out_pad, flat = _slot_ffn(hf, params, experts, slots, keeps, c)
    y = _combine(out_pad[flat.reshape(-1)], weights, h.dtype)
    return y.reshape(b, t, d), e * (me * ce).sum()
