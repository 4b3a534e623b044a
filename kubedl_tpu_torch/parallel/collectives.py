"""Collectives over named mesh axes that autograd differentiates (the
psum / all_gather / all_to_all of the JAX package's shard_map bodies).

Two conventions meet in the sharded model, one per kind of axis:

* token axes (data, fsdp, expert): ranks hold different rows, and each
  rank's gradient is its part of the sum; `all_gather` gives back a
  reduce-scatter and `all_to_all` the reverse all-to-all;
* the tensor axis: peers hold the same rows and the same full values,
  each with the full cotangent. `enter` (identity, then an all-reduce of
  the gradient) starts a region where each peer computes a part, and
  `psum` (an all-reduce, then the gradient as it is) ends it.

`psum` also turns per-rank parts of a value that every rank then uses
alike (the loss, the routers' mean probabilities) into that value. Every
function is the identity when no axis of `axes` has more than one rank.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from kubedl_tpu_torch.parallel.mesh import live_axes


def _groups(mesh, axes: Sequence[str]):
    return [mesh.get_group(a) for a in live_axes(mesh, axes)]


def _all_reduce(x, groups, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    for g in groups:
        dist.all_reduce(x, op=op, group=g)
    return x


def _gather(x, g):
    n = dist.get_world_size(g)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=g)
    return out


def _reduce_scatter(x, g):
    n = dist.get_world_size(g)
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=g)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for g in reversed(groups):  # innermost axis first
            x = _gather(x, g)
        return x

    @staticmethod
    def backward(ctx, g):
        for grp in ctx.groups:  # outermost first: the reverse of forward
            g = _reduce_scatter(g, grp)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def psum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Sum over `axes`; the gradient passes through unchanged."""
    groups = _groups(mesh, axes) if mesh is not None else []
    return _Psum.apply(x, groups) if groups else x


def enter(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Identity; the gradient is summed over `axes`."""
    groups = _groups(mesh, axes) if mesh is not None else []
    return _Enter.apply(x, groups) if groups else x


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Concatenate every rank's x along dim 0 over `axes` (the first axis
    outermost); the gradient is reduce-scattered back."""
    groups = _groups(mesh, axes) if mesh is not None else []
    return _AllGather.apply(x, groups) if groups else x


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x [n, ...] over the n ranks of `axis`: block i goes to rank i, and
    block i of the result came from rank i."""
    groups = _groups(mesh, (axis,)) if mesh is not None else []
    return _AllToAll.apply(x, groups[0]) if groups else x


def pmax(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Elementwise max over `axes`, outside autograd."""
    groups = _groups(mesh, axes) if mesh is not None else []
    return _all_reduce(x.detach(), groups, dist.ReduceOp.MAX) if groups else x.detach()
