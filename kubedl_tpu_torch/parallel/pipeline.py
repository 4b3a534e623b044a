"""Pipeline parallelism over the mesh's "stage" axis: the GPipe schedule
and the interleaved circular 1F1B schedule (the port of
kubedl_tpu/parallel/pipeline.py).

The layers are stacked on a leading dim (`stack_layers`) and sharded over
the stage axis, so each stage holds ``n_layers / n_stages`` of them. Every
rank of the mesh runs the same loop, as the reference's one `shard_map`
program does: at step i stage 0 takes microbatch i, each stage applies its
own layers to the activation it holds, and the activations move one hop to
the next stage with `ppermute` (parallel/collectives.py), a ring whose
gradient is the reverse ring. Autograd through the loop is the pipelined
backward pass.

Where the reference selects with ``jnp.where`` on the stage index, the
port does the same with ``torch.where`` on a 0-d mask, so every rank
keeps every activation it receives in its graph: each rank's backward
then runs the same collectives in the same order (a ppermute whose output
a rank dropped would leave its peers waiting), and a value a select drops
passes zeros back. The last stage banks the finished
microbatches and returns them; the other stages return their own buffer,
which no loss reads (the reference returns ``out[-1]`` and lets XLA move
it to the ranks that run the head).

Parameters: a stacked leaf is a DTensor laid out by
models/llama.py `param_specs_pp` (sharded over "stage" on dim 0), whose
gradient lands reduced on its own placements, or a plain tensor holding
every layer, of which the rank uses its own; then its gradient is this
rank's part (its layers, its rows), as elsewhere in the port.
Activations: ``x_microbatches`` [n_micro, micro_rows, ...] holds this
rank's rows of each microbatch; `local_rows` says which rows of a global
batch those are for the reference's split, so a gang holds exactly the
reference's microbatches (the MoE aux of a microbatch depends on the rows
in it).

Composes with data parallelism (rows over data and fsdp; fsdp shards of a
leaf gathered) and with MoE layers (experts replicated per stage, the
local route, the aux counted in each stage's valid window). Tensor,
context and expert axes above 1 are refused by the model's pipelined path.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from kubedl_tpu_torch.api.validation import validate_pipeline_shapes
from kubedl_tpu_torch.parallel import collectives
from kubedl_tpu_torch.parallel.mesh import BATCH_AXES, axes_size, axis_size, live_axes


def schedule_steps(n_micro: int, n_stages: int, interleave: int = 1) -> int:
    """Sequential sub-steps one schedule round takes. GPipe (interleave=1)
    runs M + S - 1 full-stage steps; the interleaved circular schedule
    runs M*v + S - 1 steps of 1/v the per-step work."""
    return n_micro * interleave + n_stages - 1


def bubble_fraction(n_micro: int, n_stages: int, interleave: int = 1) -> float:
    """Fill/drain bubble fraction of the schedule: (S-1)/(M*v + S-1). Each
    rank does M*v useful chunk-steps out of M*v + S - 1; interleaving keeps
    the S-1 idle chunk-steps but makes each 1/v the work."""
    return (n_stages - 1) / schedule_steps(n_micro, n_stages, interleave)


def interleaved_layer_order(n_layers: int, n_stages: int, interleave: int) -> np.ndarray:
    """Layer permutation for the interleaved schedule: rank s holds the
    chunks {r*S + s : r < v} (each L/(S*v) layers); the order lists each
    rank's layers contiguously, in local chunk order."""
    chunk_len = n_layers // (n_stages * interleave)
    order = []
    for s in range(n_stages):
        for r in range(interleave):
            c = r * n_stages + s
            order.extend(range(c * chunk_len, (c + 1) * chunk_len))
    return np.asarray(order, dtype=np.int32)


def _tree_map(fn, *trees):
    """fn over the leaves of nested dict/list trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def stack_layers(layers: Sequence[Any]) -> Any:
    """[{leaf...}] * L  ->  {leaf: [L, ...]} -- the stacked layout."""
    return _tree_map(lambda *xs: torch.stack(xs), *layers)


def unstack_layers(stacked: Any, n_layers: int) -> list:
    return [_tree_map(lambda x: x[i], stacked) for i in range(n_layers)]


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [n_micro, B/n_micro, ...]: microbatch i is rows
    [i*B/n_micro, (i+1)*B/n_micro)."""
    if x.shape[0] % n_microbatches:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {n_microbatches} microbatches")
    return x.reshape((n_microbatches, x.shape[0] // n_microbatches) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """[n_micro, mb, ...] -> [n_micro*mb, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def local_rows(n_rows: int, n_microbatches: int, block: int, n_blocks: int) -> np.ndarray:
    """The rows of a global [n_rows, ...] batch that token block `block` of
    `n_blocks` holds in the reference's pipelined split: `microbatch` cuts
    the global batch into M microbatches and the batch axes cut each
    microbatch into n_blocks row blocks. `microbatch` of these rows on the
    rank gives its part of each of the reference's microbatches."""
    if n_rows % (n_microbatches * n_blocks):
        raise ValueError(f"batch {n_rows} not divisible by {n_microbatches} microbatches "
                         f"x {n_blocks} row blocks")
    mb = n_rows // n_microbatches
    per = mb // n_blocks
    return np.concatenate([np.arange(i * mb + block * per, i * mb + (block + 1) * per)
                           for i in range(n_microbatches)])


def _stage_view(p, mesh, stage_axis: str, batch_axes, rows: np.ndarray, gather: bool):
    """This rank's layers `rows` of one stacked leaf. A DTensor keeps its
    stage shard (gather=False: `rows` are that shard) or is gathered whole
    (gather=True, the interleaved order crosses shards); its gradient is
    Partial over the live batch axes (and over the stage axis when
    gathered), so it lands reduced on the leaf's placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(p, DTensor):
        return p[torch.as_tensor(rows, dtype=torch.long, device=p.device)]
    names = list(p.device_mesh.mesh_dim_names)
    batch = set(live_axes(mesh, batch_axes))
    keep = not gather and axis_size(mesh, stage_axis) > 1
    target, grad = [], []
    for n in names:
        if n == stage_axis and keep:
            target.append(Shard(0))
            grad.append(Shard(0))
        else:
            target.append(Replicate())
            partial = n in batch or (n == stage_axis and axis_size(mesh, n) > 1)
            grad.append(Partial() if partial else Replicate())
    local = p.redistribute(mesh, target).to_local(grad_placements=grad)
    if not gather:
        return local
    return local[torch.as_tensor(rows, dtype=torch.long, device=local.device)]


def _runner(layer_fn: Callable, remat: bool):
    """Applies a list of layers: (act, [layer...]) -> (act, summed aux)."""
    per_layer = (functools.partial(checkpoint, layer_fn, use_reentrant=False)
                 if remat else layer_fn)

    def run(act, layers):
        aux = 0.0
        for layer in layers:
            act, da = per_layer(act, layer)
            aux = aux + da
        return act, aux
    return run


def _aux_total(aux_acc, n_micro, mesh, stage_axis, batch_axes, device):
    """Every stage's own layers' aux, summed over the stage axis, over M,
    then averaged over the batch axes: a value every rank holds alike."""
    if not torch.is_tensor(aux_acc):
        aux_acc = torch.zeros((), dtype=torch.float32, device=device)
    total = collectives.psum(aux_acc, mesh, (stage_axis,)) / n_micro
    n_b = axes_size(mesh, live_axes(mesh, batch_axes))
    return collectives.psum(total / n_b, mesh, batch_axes) if n_b > 1 else total


def _mask(flag: bool, device) -> torch.Tensor:
    return torch.tensor(flag, device=device)


def pipeline_apply(
    stacked_params: Any,
    x_microbatches: torch.Tensor,  # [n_micro, micro_rows, ...feature dims]
    layer_fn: Callable,
    *,
    mesh,
    stage_axis: str = "stage",
    batch_axes: Tuple[str, ...] = BATCH_AXES,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every microbatch through all pipeline stages (GPipe): the
    interleaved schedule with one chunk a rank, which is GPipe step for
    step. Returns `pipeline_apply_1f1b`'s pair."""
    return pipeline_apply_1f1b(stacked_params, x_microbatches, layer_fn, mesh=mesh,
                               interleave=1, stage_axis=stage_axis,
                               batch_axes=batch_axes, remat=remat)


def pipeline_apply_1f1b(
    stacked_params: Any,
    x_microbatches: torch.Tensor,  # [n_micro, micro_rows, ...feature dims]
    layer_fn: Callable,
    *,
    mesh,
    interleave: int = 1,
    stage_axis: str = "stage",
    batch_axes: Tuple[str, ...] = BATCH_AXES,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interleaved circular 1F1B schedule (virtual pipeline stages).
    Returns (activations shaped like `x_microbatches`: the finished
    microbatches on the last stage, this rank's own buffer elsewhere; the
    aux total, a 0-d f32 tensor every rank holds alike).

    `layer_fn(act, layer) -> (act, aux)` applies ONE layer, shape-
    preserving, with a per-layer aux scalar (the MoE load-balance loss, 0.0
    for a dense layer). The aux counts only in each stage's valid window
    (the fill/drain steps feed garbage), summed over the stage axis, over
    M, and averaged over the batch axes -- the reference's microbatch-mean
    approximation of the full-batch aux.

    Each rank holds `interleave` NON-
    contiguous layer chunks and every microbatch circulates the ring v
    times: rank s, repeat r applies global chunk r*S + s at work index
    u = r*M + i, step t = u + s. An activation leaving the last rank at
    repeat r < v-1 wraps to rank 0, which holds it in a wrap buffer until
    step (r+1)*M + i (so M >= S, the fill rule GPipe has). The loop runs
    M*v + S - 1 sub-steps of 1/v the work, so the bubble fraction drops
    from (S-1)/(M+S-1) to (S-1)/(M*v+S-1).

    A DTensor stack is gathered whole on every rank (rank s's chunks lie
    in other ranks' shards of the natural layer order); its gradient is
    reduce-scattered back. interleave=1 is GPipe (`pipeline_apply`)."""
    n_stages = axis_size(mesh, stage_axis)
    n_micro = x_microbatches.shape[0]
    n_layers = _first_leaf(stacked_params).shape[0]
    errs = validate_pipeline_shapes(n_stages, n_micro, interleave, n_layers=n_layers,
                                    path="pipeline_apply_1f1b")
    if errs:
        raise ValueError("; ".join(errs))
    v = interleave
    chunk_len = n_layers // (n_stages * v)
    stage = mesh.get_local_rank(stage_axis) if n_stages > 1 else 0
    order = interleaved_layer_order(n_layers, n_stages, v)
    mine = order[stage * v * chunk_len:(stage + 1) * v * chunk_len]
    local = _tree_map(lambda p: _stage_view(p, mesh, stage_axis, batch_axes, mine,
                                            gather=v > 1), stacked_params)
    layers = unstack_layers(local, v * chunk_len)
    chunks = [layers[r * chunk_len:(r + 1) * chunk_len] for r in range(v)]
    run = _runner(layer_fn, remat)
    dev = x_microbatches.device
    first = _mask(stage == 0, dev)
    ring = [(j, (j + 1) % n_stages) for j in range(n_stages)]
    n_work = n_micro * v
    n_steps = n_work + n_stages - 1

    act = torch.zeros_like(x_microbatches[0])
    outs = [torch.zeros_like(act) for _ in range(n_micro)]
    wrap = [None] * n_micro
    aux_acc = 0.0
    for t in range(n_steps):
        u = t - stage  # this rank's work index at step t
        valid = 0 <= u < n_work
        r, mb = divmod(min(max(u, 0), n_work - 1), n_micro)
        # rank 0 banks the wrapped activation that just arrived: rank S-1
        # sent it at step t-1, work index t-S; a repeat below v-1
        # recirculates (the final repeat banks into the outputs instead)
        us = t - n_stages
        if stage == 0 and 0 <= us < n_work and us // n_micro < v - 1:
            wrap[us % n_micro] = act
        # rank 0's input: the fresh microbatch on repeat 0, the wrap buffer
        # afterwards (stored before it is read: M == S needs that); the
        # select keeps the dropped activation in the graph, so its ppermute
        # still takes part in the backward's ring
        fresh = wrap[mb] if stage == 0 and r > 0 else x_microbatches[mb]
        act = torch.where(first, fresh, act)
        act, aux = run(act, chunks[r])
        if valid:
            aux_acc = aux_acc + aux
        # the last rank's final repeat banks microbatch mb
        bank = stage == n_stages - 1 and valid and r == v - 1
        outs[mb] = torch.where(_mask(bank, dev), act, outs[mb])
        if t < n_steps - 1:  # one hop; S-1 -> 0 carries the wrap
            act = collectives.ppermute(act, mesh, stage_axis, ring)
    return torch.stack(outs), _aux_total(aux_acc, n_micro, mesh, stage_axis, batch_axes, dev)
