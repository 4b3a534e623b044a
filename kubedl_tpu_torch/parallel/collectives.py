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

The pipeline's stage axis (parallel/pipeline.py) moves activations one hop
with `ppermute`, whose gradient takes the reverse permutation, and hands
the last stage's loss to every stage with `broadcast_from`, whose gradient
goes back to the source once, not summed over the peers. The context axis
rotates K/V around its ring with `ppermute` (ops/ring_attention.py) and
swaps sequence for heads with `all_to_all_tiled` (ops/ulysses.py).

A group whose backend is gloo carries host tensors: every collective here
stages a CUDA tensor through the host on such a group (several processes
sharing one card can only form a gloo group), and counts the bytes it
copies each way in `staged_bytes`. NCCL groups take the tensor as it is.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from kubedl_tpu_torch.parallel.mesh import axis_size, live_axes


# bytes copied between a card and the host for collectives on gloo groups
# (device to host plus host to device), since the process started or the
# caller last set it to 0
staged_bytes = 0


def _groups(mesh, axes: Sequence[str]):
    return [mesh.get_group(a) for a in live_axes(mesh, axes)]


def _staged(x: torch.Tensor, group) -> bool:
    """Whether x must cross the host for `group`: a CUDA tensor on a gloo
    group (decided by the group's backend, never by a failed call)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    global staged_bytes
    staged_bytes += x.numel() * x.element_size()
    return x.contiguous().cpu()


def _to_device(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    global staged_bytes
    staged_bytes += x.numel() * x.element_size()
    return x.to(like.device)


def _all_reduce(x, groups, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    for g in groups:
        if _staged(x, g):
            h = _to_host(x)
            dist.all_reduce(h, op=op, group=g)
            x.copy_(_to_device(h, x))
        else:
            dist.all_reduce(x, op=op, group=g)
    return x


def _gather(x, g):
    n = dist.get_world_size(g)
    staged = _staged(x, g)
    src = _to_host(x) if staged else x.contiguous()
    out = src.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=g)
    return _to_device(out, x) if staged else out


def _reduce_scatter(x, g):
    n = dist.get_world_size(g)
    staged = _staged(x, g)
    src = _to_host(x) if staged else x.contiguous()
    out = src.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=g)
    return _to_device(out, x) if staged else out


def _all_to_all(x, g):
    """Block i of x [n, ...] to rank i of `g`; block i of the result from rank i."""
    if _staged(x, g):
        h = _to_host(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=g)
        return _to_device(out, x)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g)
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
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _swap(x, group, split_dim: int, concat_dim: int):
    """JAX's tiled all_to_all: x's `split_dim` cut into n blocks, block j
    sent to rank j, the n received blocks joined along `concat_dim` in
    rank order."""
    n = dist.get_world_size(group)
    blocks = x.unflatten(split_dim, (n, x.shape[split_dim] // n)).movedim(split_dim, 0)
    got = _all_to_all(blocks.contiguous(), group)  # got[i]: rank i's block
    return got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAllTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = group, split_dim, concat_dim
        return _swap(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _swap(g, group, concat_dim, split_dim), None, None, None


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


def all_to_all_tiled(x: torch.Tensor, mesh, axis: str, split_dim: int,
                     concat_dim: int) -> torch.Tensor:
    """JAX's ``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``
    over the n ranks of `axis`: x's `split_dim` is cut into n blocks, block
    j goes to rank j, and the blocks a rank receives are joined along
    `concat_dim` in rank order (so [b, h, t/n, d] with split 1, concat 2
    becomes [b, h/n, t, d]). The gradient is the swap the other way."""
    groups = _groups(mesh, (axis,)) if mesh is not None else []
    if not groups:
        return x
    if x.shape[split_dim] % dist.get_world_size(groups[0]):
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over "
                         f"{axis}={dist.get_world_size(groups[0])}")
    return _AllToAllTiled.apply(x, groups[0], split_dim, concat_dim)


def pmax(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Elementwise max over `axes`, outside autograd."""
    groups = _groups(mesh, axes) if mesh is not None else []
    return _all_reduce(x.detach(), groups, dist.ReduceOp.MAX) if groups else x.detach()


def _peer(group, index: int) -> int:
    """The global rank of coordinate `index` of a mesh axis's group."""
    return dist.get_global_rank(group, index)


def _permute(x, group, perm):
    """Send x to each destination of this rank's (src, dst) pairs and take
    the value from its source; zeros where no pair names this rank as the
    destination (JAX's ppermute). Sends and receives are posted together
    (`batch_isend_irecv`), so a ring never deadlocks."""
    me = dist.get_rank(group)
    staged = _staged(x, group)
    out = torch.zeros(x.shape, dtype=x.dtype, device="cpu" if staged else x.device)
    send, got, ops = None, False, []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            if send is None:
                send = _to_host(x) if staged else x.contiguous()
            ops.append(dist.P2POp(dist.isend, send, _peer(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _peer(group, src), group))
            got = True
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if not staged:
        return out
    return _to_device(out, x) if got else out.to(x.device)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.keep = dist.get_rank(group) == src
        if _staged(x, group):
            h = _to_host(x)
            dist.broadcast(h, src=_peer(group, src), group=group)
            return _to_device(h, x)
        out = x.contiguous().clone()
        dist.broadcast(out, src=_peer(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """JAX's ``lax.ppermute`` over `axis`: `perm` lists (source, destination)
    coordinates; a rank that no pair sends to gets zeros. The gradient is
    the reverse permutation."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x if any(s == d for s, d in perm) else torch.zeros_like(x)
    return _Ppermute.apply(x, mesh.get_group(axis), [tuple(p) for p in perm])


def broadcast_from(x: torch.Tensor, mesh, axis: str, index: int) -> torch.Tensor:
    """Every rank of `axis` gets the value of the rank at coordinate `index`.
    The peers then use it alike, each with the full cotangent: the
    gradient goes to the source as it is (not summed over the peers), and
    the other ranks' x gets zeros."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return x
    return _Broadcast.apply(x, mesh.get_group(axis), index)
