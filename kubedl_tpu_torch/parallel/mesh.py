"""Device mesh and sharding rules on torch.distributed (the port of
kubedl_tpu/parallel/mesh.py).

A JAXJob's spec.mesh names axes; the operator injects them as KUBEDL_MESH
(and the cross-slice part as KUBEDL_DCN_MESH), and the program lays its
processes out as a `torch.distributed.device_mesh.DeviceMesh` with the six
named dims of AXIS_ORDER. The port runs one device per process, so a mesh
holds one rank per device and its size must equal the gang's
(KUBEDL_NUM_PROCESSES): `mesh_from_env` checks that before the rendezvous,
with the JAX package's `build_mesh` messages.

`ShardingRules` maps a tensor's logical dims ("embed", "heads", "mlp",
"vocab", "expert", ...) to mesh axes as the JAX package's rules do, and
`spec` returns the same PartitionSpec tuple. `placements` turns a spec into
DTensor placements; `shard_tree` makes a parameter tree of DTensors, the
form `torch.distributed.checkpoint` reads. The model computes on plain
local tensors: `local_view` gathers a leaf's fsdp shards (ZeRO-3), keeps
its tensor and expert shards, and tells autograd that the local gradient
is a partial sum over the token axes, so the gradient lands reduced on the
leaf's own placements.

Tokens: the rows of the global batch are sharded over the token axes, the
batch axes (data, fsdp) and then the expert axis, data outermost; the
tensor, stage and context peers of a rank hold the same rows
(`token_axes`, `token_index`).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_ORDER = ("data", "fsdp", "stage", "tensor", "context", "expert")

# Batch shards over data+fsdp (fsdp also shards params, ZeRO-3 style).
BATCH_AXES = ("data", "fsdp")

ENV_MESH = "KUBEDL_MESH"
ENV_DCN_MESH = "KUBEDL_DCN_MESH"


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), a mesh axis name, or a tuple of
    names (sharded over their product, the first outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# the env contract
# ---------------------------------------------------------------------------


def _parse_axes(value: str) -> Dict[str, int]:
    axes = {name: 1 for name in AXIS_ORDER}
    for part in value.split(","):
        if not part.strip():
            continue
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in axes:
            raise ValueError(f"unknown mesh axis {name!r} (known: {AXIS_ORDER})")
        axes[name] = int(size)
    return axes


def parse_mesh_env(value: Optional[str] = None) -> Dict[str, int]:
    """Parse "data=2,fsdp=4,..." (KUBEDL_MESH). Unset or empty means pure
    data parallelism over every device (data=-1)."""
    value = value if value is not None else os.environ.get(ENV_MESH, "")
    if not value:
        axes = {name: 1 for name in AXIS_ORDER}
        axes["data"] = -1
        return axes
    return _parse_axes(value)


def parse_dcn_mesh_env(value: Optional[str] = None) -> Optional[Dict[str, int]]:
    """Parse KUBEDL_DCN_MESH ("data=2"). None when unset or empty (one
    slice); cross-slice axes have no -1 default."""
    value = value if value is not None else os.environ.get(ENV_DCN_MESH, "")
    if not value:
        return None
    axes = _parse_axes(value)
    for name, size in axes.items():
        if size < 1:
            raise ValueError(f"DCN axis {name!r} must be >=1, got {size}")
    return axes


def resolve_axes(axes: Dict[str, int], n: int) -> Dict[str, int]:
    """Axis sizes over `n` devices: at most one -1 absorbs the rest, and
    the sizes must multiply to n (the JAX package's build_mesh checks)."""
    axes = dict(axes)
    for name in AXIS_ORDER:
        axes.setdefault(name, 1)
    wild = [k for k, v in axes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"only one mesh axis may be -1, got {wild}")
    fixed = math.prod(v for v in axes.values() if v != -1)
    if wild:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
        axes[wild[0]] = n // fixed
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(
            f"mesh axes {axes} multiply to {total}, but {n} devices are visible")
    return {name: axes[name] for name in AXIS_ORDER}


def resolve_hybrid_axes(ici: Dict[str, int], dcn: Dict[str, int], n: int
                        ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(ici, dcn) sizes over `n` devices; a -1 ICI axis is resolved against
    the devices of one slice (n over the product of the DCN axes)."""
    ici = {k: int(ici.get(k, 1)) for k in AXIS_ORDER}
    dcn = {k: int(dcn.get(k, 1)) for k in AXIS_ORDER}
    if any(v == -1 for v in ici.values()):
        per_slice, rem = divmod(n, math.prod(dcn.values()))
        if rem:
            raise ValueError(f"{n} devices not divisible by DCN axes {dcn}")
        wild = [k for k, v in ici.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"only one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in ici.values() if v != -1)
        if per_slice % fixed:
            raise ValueError(f"{per_slice} per-slice devices not divisible by {fixed}")
        ici[wild[0]] = per_slice // fixed
    total = math.prod(a * b for a, b in zip(ici.values(), dcn.values()))
    if total != n:
        raise ValueError(f"hybrid mesh {ici}x{dcn} needs {total} devices, have {n}")
    return ici, dcn


def mesh_from_env(n: int) -> Dict[str, int]:
    """The per-axis sizes (ICI x DCN) that KUBEDL_MESH and KUBEDL_DCN_MESH
    ask for over `n` devices, one per process of the gang. Raises
    ValueError, with the JAX package's message, when they do not fit."""
    dcn = parse_dcn_mesh_env()
    if dcn is None:
        return resolve_axes(parse_mesh_env(), n)
    ici, dcn = resolve_hybrid_axes(parse_mesh_env(), dcn, n)
    return {k: ici[k] * dcn[k] for k in AXIS_ORDER}


# ---------------------------------------------------------------------------
# DeviceMesh
# ---------------------------------------------------------------------------


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"


def _world(world: Optional[int]) -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a DeviceMesh needs a torch.distributed process group: "
                           "call train/coordinator.py initialize() first")
    return dist.get_world_size() if world is None else world


def _device_mesh(ranks: np.ndarray, device_type: Optional[str]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(device_type), torch.from_numpy(ranks.astype(np.int64)),
                      mesh_dim_names=AXIS_ORDER)


def build_mesh(axes: Optional[Dict[str, int]] = None, world: Optional[int] = None,
               device_type: Optional[str] = None):
    """DeviceMesh over the group's ranks (one device each) with the six
    named dims; rank r sits at the row-major coordinate r of the axis sizes
    (a -1 axis absorbs the rest)."""
    n = _world(world)
    axes = resolve_axes(axes or parse_mesh_env(), n)
    return _device_mesh(np.arange(n).reshape([axes[a] for a in AXIS_ORDER]), device_type)


def build_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int],
                      world: Optional[int] = None, device_type: Optional[str] = None):
    """Multislice mesh: each axis is its DCN part times its ICI part, the
    DCN part outermost. Ranks of one slice are contiguous (slice-major), so
    a collective over an ICI part stays inside a slice and the DCN groups
    span slices (nodes)."""
    n = _world(world)
    ici, dcn = resolve_hybrid_axes(ici_axes, dcn_axes, n)
    k = len(AXIS_ORDER)
    ranks = np.arange(n).reshape([dcn[a] for a in AXIS_ORDER] + [ici[a] for a in AXIS_ORDER])
    ranks = ranks.transpose([i for pair in zip(range(k), range(k, 2 * k)) for i in pair])
    return _device_mesh(ranks.reshape([dcn[a] * ici[a] for a in AXIS_ORDER]), device_type)


def build_mesh_from_env(world: Optional[int] = None, device_type: Optional[str] = None):
    """The one mesh entry point of a program: the flat mesh of KUBEDL_MESH,
    or the hybrid ICI x DCN mesh when KUBEDL_DCN_MESH is set."""
    dcn = parse_dcn_mesh_env()
    if dcn is None:
        return build_mesh(parse_mesh_env(), world, device_type)
    return build_hybrid_mesh(parse_mesh_env(), dcn, world, device_type)


def mesh_shape(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def live_axes(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    """The axes of `axes` whose size is above 1."""
    return tuple(a for a in axes if axis_size(mesh, a) > 1)


def axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(axis_size(mesh, a) for a in axes)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's row-major coordinate over `axes` (the first outermost)."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingRules:
    """Logical-dimension -> mesh-axes mapping for model tensors.

    Dimensions used by models/: "batch", "seq", "embed" (d_model), "heads",
    "kv_heads", "head_dim", "mlp" (ffn hidden), "vocab", "layers", "expert".
    """

    rules: Dict[str, Tuple[str, ...]] = field(
        default_factory=lambda: {
            "batch": BATCH_AXES,
            "seq": ("context",),
            "embed": ("fsdp",),
            "heads": ("tensor",),
            "kv_heads": ("tensor",),
            "head_dim": (),
            "mlp": ("tensor",),
            "vocab": ("tensor",),
            "layers": ("stage",),
            "expert": ("expert",),
        }
    )

    def spec(self, *dims: Optional[str]) -> PartitionSpec:
        """PartitionSpec for a tensor whose dimensions have logical names."""
        parts = []
        for d in dims:
            axes = self.rules.get(d, ()) if d is not None else ()
            if not axes:
                parts.append(None)
            elif len(axes) == 1:
                parts.append(axes[0])
            else:
                parts.append(tuple(axes))
        return P(*parts)

    def axes(self, dim: str) -> Tuple[str, ...]:
        return tuple(self.rules.get(dim, ()))


def token_axes(rules: ShardingRules) -> Tuple[str, ...]:
    """The axes the rows of the batch are sharded over: the batch axes,
    then the expert axes (each rank of an expert group owns its rows)."""
    batch = rules.axes("batch")
    return batch + tuple(a for a in rules.axes("expert") if a not in batch)


def token_index(mesh, rules: ShardingRules) -> Tuple[int, int]:
    """(this rank's block of the global batch, the number of blocks)."""
    axes = live_axes(mesh, token_axes(rules))
    return axes_index(mesh, axes), axes_size(mesh, axes)


def placements(mesh, spec: Sequence) -> list:
    """DTensor placements (one per mesh dim) of a PartitionSpec. A tensor
    dim over several axes takes them in mesh-dim order, which must be the
    spec's order (DTensor shards the first outermost, as JAX does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes if axis_size(mesh, a) > 1]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: axes of one dim must follow "
                             f"the mesh order {AXIS_ORDER}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {tuple(spec)} uses mesh axis {names[i]!r} twice")
            out[i] = Shard(d)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, tree, specs):
    if _is_spec(specs):
        return fn(tree, specs)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise ValueError(f"tree keys {sorted(tree)} differ from the specs' {sorted(specs)}")
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(specs, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError("tree and specs differ in length")
        return [_map_specs(fn, t, s) for t, s in zip(tree, specs)]
    raise TypeError(f"not a spec tree node: {specs!r}")


def shard_tensor(x: torch.Tensor, mesh, spec):
    """DTensor of `x`, the full tensor that every rank holds alike; each
    rank keeps its own shard (no communication). A DTensor passes through."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    if isinstance(x, DTensor):
        return x
    pl = placements(mesh, spec)
    if all(isinstance(p, Replicate) for p in pl):
        return DTensor.from_local(x, mesh, pl, run_check=False)
    return distribute_tensor(x.detach(), mesh, pl, src_data_rank=None)


def shard_tree(tree, mesh, spec_tree):
    """shard_tensor on every leaf of a tree with a matching spec tree."""
    return _map_specs(lambda x, s: shard_tensor(x, mesh, s), tree, spec_tree)


def view_placements(mesh, rules: ShardingRules, dims) -> Tuple[tuple, tuple]:
    """(placements of the logical `dims`, those of the view's gradient):
    Partial on every live token axis the view is not sharded on."""
    from torch.distributed.tensor import Partial, Replicate

    target = tuple(placements(mesh, rules.spec(*dims)))
    tok = set(live_axes(mesh, token_axes(rules)))
    grad = tuple(Partial() if name in tok and isinstance(t, Replicate) else t
                 for name, t in zip(mesh.mesh_dim_names, target))
    return target, grad


def local_view(p, mesh, rules: ShardingRules, *dims: Optional[str],
               layout: Optional[Tuple[tuple, tuple]] = None) -> torch.Tensor:
    """The local tensor a layer computes on: `p` laid out as the logical
    `dims` say (a dim named None is gathered), as a plain tensor.
    Autograd sees its gradient as a partial sum over every token axis the
    view is not sharded on, so `p`'s gradient comes back summed over them
    on its own placements (all-reduce, or reduce-scatter over fsdp).
    `layout` is `view_placements` of the same dims, when the caller keeps
    it. A plain tensor passes through."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p
    target, grad = layout or view_placements(mesh, rules, dims)
    if tuple(p.placements) == target == grad:
        return p.to_local()
    # redistribute even to the same placements: its backward turns the
    # partial gradient into the leaf's placements
    return p.redistribute(mesh, target).to_local(grad_placements=grad)
