"""Sharded embedding tables and pooled lookups, the XDL workload's sparse
features (the port of kubedl_tpu/models/embedding.py).

A table ``[V, d]`` is row-block-sharded over one mesh axis (``tensor`` by
default): shard s owns the contiguous rows ``[s*V/n, (s+1)*V/n)``. The ids
``[B, L]`` (``-1`` pads a bag) are this rank's rows of the batch, which
shards over the batch axes and repeats along the table axis. A lookup is a
masked local gather of the rows the shard owns and one sum over the table
axis (parallel/collectives.py `psum`, whose gradient is the identity), so
the backward scatter-adds into the owning shard only; the table's local
view sums that gradient over the batch axes, as the reference's
``shard_map`` does.

Without a mesh (one shard) the lookup is a plain gather: the padded ids
gather row 0 and the mask zeroes them. Bag pooling: ``sum``, ``mean``
(over the weights of the real ids) or None (unpooled), with optional
per-id weights.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from kubedl_tpu_torch.parallel import collectives
from kubedl_tpu_torch.parallel.mesh import (BATCH_AXES, PartitionSpec, axis_size, live_axes,
                                            local_view, placements)
from kubedl_tpu_torch.utils.device import resolve_device

# The mesh axis carrying table rows: the model-parallel axis, which a
# SparseCore-style deployment gives the whole gang ({"tensor": N}).
TABLE_AXIS = "tensor"


@dataclass(frozen=True)
class FeatureSpec:
    """One sparse feature group (an XDL "feature column")."""

    name: str
    vocab_size: int
    dim: int
    multi_hot: int = 1  # ids per example (bag length, padded with -1)
    combiner: str = "sum"  # "sum" | "mean"


def round_up(v: int, n: int) -> int:
    return -(-v // n) * n


def table_spec(axis: str = TABLE_AXIS) -> PartitionSpec:
    """PartitionSpec of one embedding table: rows over `axis`."""
    return PartitionSpec(axis, None)


def table_specs(features: Tuple[FeatureSpec, ...], axis: str = TABLE_AXIS
                ) -> Dict[str, PartitionSpec]:
    return {f.name: table_spec(axis) for f in features}


def init_table(vocab_size: int, dim: int, n_shards: int = 1, dtype=torch.float32,
               scale: Optional[float] = None, generator: Optional[torch.Generator] = None,
               device="cuda") -> torch.Tensor:
    """[round_up(vocab, n_shards), dim] table, truncated normal in [-2, 2]
    times `scale` (1/sqrt(dim) by default); padding rows train as dead
    rows. The draws are torch's (the JAX package's are JAX's)."""
    dev = resolve_device(device)
    rows = round_up(vocab_size, max(n_shards, 1))
    scale = scale if scale is not None else 1.0 / math.sqrt(dim)
    w = torch.empty((rows, dim), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


def init_tables(features: Tuple[FeatureSpec, ...], n_shards: int = 1, dtype=torch.float32,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> Dict[str, torch.Tensor]:
    return {f.name: init_table(f.vocab_size, f.dim, n_shards, dtype, generator=generator,
                               device=device)
            for f in features}


def _pool(emb, ids, weights, combiner):
    mask = (ids >= 0).to(torch.float32)
    wm = (weights * mask)[..., None].to(emb.dtype)
    if combiner is None:
        return emb * wm
    pooled = torch.sum(emb * wm, dim=-2)
    if combiner == "mean":
        denom = torch.sum(wm, dim=-2)
        pooled = pooled / torch.clamp(denom, min=1e-9)
    return pooled


def _local_table(table, mesh, axis: str, batch_axes: Sequence[str]) -> torch.Tensor:
    """This shard's rows as a plain tensor; its gradient is summed over the
    live batch axes and lands on the table's own placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(table, DTensor):
        return table
    target = tuple(placements(mesh, table_spec(axis)))
    summed = set(live_axes(mesh, batch_axes))
    grad = tuple(Partial() if name in summed and isinstance(t, Replicate) else t
                 for name, t in zip(mesh.mesh_dim_names, target))
    return local_view(table, mesh, None, layout=(target, grad))


def sparse_lookup(table: torch.Tensor, ids: torch.Tensor, mesh=None, *,
                  axis: str = TABLE_AXIS, weights: Optional[torch.Tensor] = None,
                  combiner: Optional[str] = "sum",
                  batch_axes: Sequence[str] = BATCH_AXES) -> torch.Tensor:
    """Pooled [B, d] (or [B, L, d] with combiner=None) embeddings of ids
    [B, L] (int, -1 = padding; this rank's rows on a mesh). `table` is the
    whole table (mesh None), or a DTensor sharded by `table_spec(axis)` on
    `mesh`: one masked local gather a shard and one sum over `axis`; the
    gradient scatter-adds into the owning shard only."""
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    n_shards = 1 if mesh is None else axis_size(mesh, axis)
    if table.shape[0] % n_shards:
        raise ValueError(
            f"table rows {table.shape[0]} not divisible by mesh axis "
            f"{axis!r}={n_shards}; pad with round_up()")
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    ids = ids.long()
    if mesh is None:
        tab = table
        d = tab.shape[1]
        emb = tab[ids.clamp(min=0).reshape(-1)].reshape(*ids.shape, d)
        return _pool(emb, ids, weights, combiner)
    tab = _local_table(table, mesh, axis, batch_axes)
    rows, d = tab.shape
    shard = mesh.get_local_rank(axis) if n_shards > 1 else 0
    local = ids - shard * rows
    owned = (ids >= 0) & (local >= 0) & (local < rows)
    safe = torch.where(owned, local, torch.zeros_like(local))
    emb = tab[safe.reshape(-1)].reshape(*ids.shape, d)
    emb = torch.where(owned[..., None], emb, emb.new_zeros(()))
    emb = collectives.psum(emb, mesh, (axis,))
    return _pool(emb, ids, weights, combiner)


def lookup_features(tables: Dict[str, torch.Tensor], batch_ids: Dict[str, torch.Tensor],
                    features: Tuple[FeatureSpec, ...], mesh=None, *,
                    axis: str = TABLE_AXIS,
                    batch_axes: Sequence[str] = BATCH_AXES) -> torch.Tensor:
    """The pooled embeddings of every feature group side by side:
    [B, sum(dims)]."""
    return torch.cat([sparse_lookup(tables[f.name], batch_ids[f.name], mesh, axis=axis,
                                    combiner=f.combiner, batch_axes=batch_axes)
                      for f in features], dim=-1)
