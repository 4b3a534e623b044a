"""Reshard planner -- Tenplex-style tensor-collection slicing between meshes
(the port's own copy of kubedl_tpu/parallel/reshard.py).

Elastic resize and dead-slice shrink change the device mesh under a live
training state. Instead of the checkpoint round trip, the state can be
resharded: every parameter / optimizer-slot leaf is a tensor collection cut
into per-device chunks by its PartitionSpec, and the old and new chunkings
overlap in computable hyperrectangle intersections. This module computes
those intersections and emits a minimal pod-to-pod transfer plan:

  * blocks already resident on their destination pod are "local";
  * replicated blocks are fetched from exactly ONE source (lowest surviving
    pod id), never broadcast;
  * a block no surviving pod holds raises PlanError -- the caller falls back
    closed to checkpoint restore (train/reshard_runtime.py ladder).

The planner is pure numpy, byte for byte the reference's, so both packages
agree on one plan and `ReshardPlan.digest()` is the same string for the
same leaves and topologies. In the port a process holds one device, so a
pod of the plan is a process, numbered by its flat index in the mesh.

`leaves_from_state(state, spec_tree)` replaces the reference's
NamedSharding walk: it reads each leaf of a parallel/train_step.py
TrainState (params, the optimizer's per-parameter slots and counters, the
step) with the PartitionSpec of the spec tree the state was sharded with --
never one recovered from DTensor placements, which drop every mesh axis of
size 1 (parallel/mesh.py `placements`) and so would lose an axis a grow
makes live. Paths read like the reference's key strings
(``.params['layers'][0]['wq']``, ``.opt_state['mu']['embed']``,
``.opt_state['count']``, ``.step``).
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from kubedl_tpu_torch.parallel.mesh import AXIS_ORDER, P, PartitionSpec

# A hyperrectangle in GLOBAL leaf coordinates: ((start, stop), ...) per dim.
Rect = Tuple[Tuple[int, int], ...]


class PlanError(ValueError):
    """The (old, new) pair cannot be live-resharded (non-divisible shapes,
    or a needed block lives only on dead pods). Callers fall back closed."""


@dataclass(frozen=True)
class Transfer:
    """One block move: `rect` (global coords) from pod `src` to pod `dst`."""

    path: str
    src: int
    dst: int
    rect: Rect
    nbytes: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in self.rect)


@dataclass
class ReshardPlan:
    old_axes: Dict[str, int]
    new_axes: Dict[str, int]
    old_pods: int
    new_pods: int
    # blocks that must cross pods (the DCN traffic)
    transfers: List[Transfer] = field(default_factory=list)
    # blocks whose chosen source pod IS the destination pod (no movement
    # for an in-memory reshard; the staged-restart lane persists them too,
    # since nothing survives a process exit)
    locals_: List[Transfer] = field(default_factory=list)

    @property
    def moved_bytes(self) -> int:
        return sum(t.nbytes for t in self.transfers)

    @property
    def local_bytes(self) -> int:
        return sum(t.nbytes for t in self.locals_)

    @property
    def total_bytes(self) -> int:
        return self.moved_bytes + self.local_bytes

    def for_source(self, pod: int) -> List[Transfer]:
        """Every block pod `pod` must ship (staged lane: including blocks
        it keeps for itself — a restarted process has no live memory)."""
        return [t for t in self.transfers if t.src == pod] + [
            t for t in self.locals_ if t.src == pod
        ]

    def for_dest(self, pod: int) -> List[Transfer]:
        return [t for t in self.transfers if t.dst == pod] + [
            t for t in self.locals_ if t.dst == pod
        ]

    def digest(self) -> str:
        """Topology+plan fingerprint. Pods compute the plan independently
        from their own view of (old, new); equal digests prove they will
        stage/expect the same blocks — a mismatch aborts the reshard."""
        canon = {
            "old_axes": {k: self.old_axes.get(k, 1) for k in AXIS_ORDER},
            "new_axes": {k: self.new_axes.get(k, 1) for k in AXIS_ORDER},
            "old_pods": self.old_pods,
            "new_pods": self.new_pods,
            "moves": sorted(
                (t.path, t.src, t.dst, t.rect, t.nbytes)
                for t in self.transfers + self.locals_
            ),
        }
        blob = json.dumps(canon, sort_keys=True, default=list)
        return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# mesh / spec geometry
# ---------------------------------------------------------------------------


def mesh_device_count(axes: Dict[str, int]) -> int:
    return math.prod(int(axes.get(name, 1)) for name in AXIS_ORDER)


def normalize_spec(spec, ndim: int) -> List[Tuple[str, ...]]:
    """PartitionSpec -> per-dim tuple of mesh axis names (padded to ndim)."""
    entries: List[Tuple[str, ...]] = []
    for part in tuple(spec or ()):
        if part is None:
            entries.append(())
        elif isinstance(part, str):
            entries.append((part,))
        else:
            entries.append(tuple(part))
    while len(entries) < ndim:
        entries.append(())
    return entries[:ndim]


def _chunk_counts(
    shape: Sequence[int], dims: List[Tuple[str, ...]], axes: Dict[str, int]
) -> List[int]:
    counts = []
    for size, names in zip(shape, dims):
        n = math.prod(int(axes.get(a, 1)) for a in names)
        if n > 1 and size % n:
            raise PlanError(
                f"dim of size {size} not divisible by {n} shards "
                f"(axes {names}, mesh {dict(axes)})"
            )
        counts.append(n)
    return counts


def _device_chunk_vecs(
    shape: Sequence[int], dims: List[Tuple[str, ...]], axes: Dict[str, int]
) -> List[Tuple[int, ...]]:
    """Per mesh device (flat AXIS_ORDER index): its chunk-index vector for
    a leaf — which chunk of each dim the device owns. Devices differing
    only on unsharded axes share a vector (replication)."""
    sizes = [int(axes.get(name, 1)) for name in AXIS_ORDER]
    pos = {name: i for i, name in enumerate(AXIS_ORDER)}
    vecs = []
    for flat in range(math.prod(sizes)):
        coords = np.unravel_index(flat, sizes)
        vec = []
        for names in dims:
            idx = 0
            for a in names:
                idx = idx * sizes[pos[a]] + int(coords[pos[a]])
            vec.append(idx)
        vecs.append(tuple(vec))
    return vecs


def pod_of_device(flat: int, n_devices: int, n_pods: int) -> int:
    """Mesh devices partition into pods by contiguous flat index —
    jax.devices() orders by process, and build_mesh reshapes that order."""
    if n_devices % n_pods:
        raise PlanError(f"{n_devices} devices not divisible by {n_pods} pods")
    return flat // (n_devices // n_pods)


def _owner_map(
    shape: Sequence[int],
    dims: List[Tuple[str, ...]],
    axes: Dict[str, int],
    n_pods: int,
) -> Dict[Tuple[int, ...], List[int]]:
    """chunk vector -> sorted pod ids holding (a replica of) that chunk."""
    n_dev = mesh_device_count(axes)
    owners: Dict[Tuple[int, ...], set] = {}
    for flat, vec in enumerate(_device_chunk_vecs(shape, dims, axes)):
        owners.setdefault(vec, set()).add(pod_of_device(flat, n_dev, n_pods))
    return {vec: sorted(pods) for vec, pods in owners.items()}


def _dim_intervals(size: int, n_old: int, n_new: int):
    """Elementary intervals of one dim under both chunkings: each interval
    lies inside exactly one old chunk and one new chunk. Yields
    (start, stop, old_chunk_idx, new_chunk_idx)."""
    old_len, new_len = size // n_old, size // n_new
    cuts = sorted({0, size}
                  | {i * old_len for i in range(n_old)}
                  | {i * new_len for i in range(n_new)})
    for a, b in zip(cuts, cuts[1:]):
        yield a, b, a // old_len, a // new_len


def chunk_rect(
    shape: Sequence[int], counts: Sequence[int], vec: Sequence[int]
) -> Rect:
    """Global hyperrect of one chunk vector."""
    out = []
    for size, n, idx in zip(shape, counts, vec):
        ln = size // n
        out.append((idx * ln, (idx + 1) * ln))
    return tuple(out)


# ---------------------------------------------------------------------------
# per-leaf planning
# ---------------------------------------------------------------------------


def plan_leaf(
    path: str,
    shape: Sequence[int],
    itemsize: int,
    spec,
    old_axes: Dict[str, int],
    new_axes: Dict[str, int],
    old_pods: int = 1,
    new_pods: int = 1,
    survivors: Optional[Iterable[int]] = None,
) -> Tuple[List[Transfer], List[Transfer]]:
    """(cross-pod transfers, local blocks) for one leaf.

    `survivors` restricts eligible SOURCE pods (dead-slice shrink: the dead
    pod's blocks must come from replicas elsewhere); None = all old pods.
    Every destination pod receives each block it needs exactly once.
    """
    shape = tuple(int(s) for s in shape)
    ndim = len(shape)
    old_dims = normalize_spec(spec, ndim)
    new_dims = old_dims  # the SPEC is mesh-shape-agnostic; only sizes change
    old_counts = _chunk_counts(shape, old_dims, old_axes)
    new_counts = _chunk_counts(shape, new_dims, new_axes)
    src_owners = _owner_map(shape, old_dims, old_axes, old_pods)
    dst_owners = _owner_map(shape, new_dims, new_axes, new_pods)
    alive = set(range(old_pods)) if survivors is None else set(survivors)

    # elementary interval lists per dim
    per_dim = [
        list(_dim_intervals(s, no, nn))
        for s, no, nn in zip(shape, old_counts, new_counts)
    ]
    # scalars (0-dim leaves: optimizer step counts) still reshard: one
    # empty-rect block, old vec == new vec == ()
    if ndim == 0:
        per_dim = []

    transfers: List[Transfer] = []
    locals_: List[Transfer] = []

    def emit(rect: Rect, old_vec, new_vec) -> None:
        nbytes = itemsize * math.prod(b - a for a, b in rect)
        srcs = [p for p in src_owners.get(tuple(old_vec), []) if p in alive]
        if not srcs:
            raise PlanError(
                f"{path}: block {rect} has no surviving source pod "
                f"(owners {src_owners.get(tuple(old_vec))}, alive {sorted(alive)})"
            )
        for dst in dst_owners.get(tuple(new_vec), []):
            src = dst if dst in srcs else srcs[0]
            t = Transfer(path=path, src=src, dst=dst, rect=rect, nbytes=nbytes)
            (locals_ if src == dst else transfers).append(t)

    if ndim == 0:
        emit((), (), ())
        return transfers, locals_

    def rec(d: int, rect: List[Tuple[int, int]], ov: List[int], nv: List[int]):
        if d == ndim:
            emit(tuple(rect), tuple(ov), tuple(nv))
            return
        for a, b, oi, ni in per_dim[d]:
            rec(d + 1, rect + [(a, b)], ov + [oi], nv + [ni])

    rec(0, [], [], [])
    return transfers, locals_


def plan_reshard(
    leaves: Dict[str, Tuple[Tuple[int, ...], int, object]],
    old_axes: Dict[str, int],
    new_axes: Dict[str, int],
    old_pods: int = 1,
    new_pods: int = 1,
    survivors: Optional[Iterable[int]] = None,
) -> ReshardPlan:
    """Plan a whole state: `leaves` maps path -> (shape, itemsize, spec).

    Optimizer slots reshard WITH their params by construction: a slot leaf
    carries its param's shape and PartitionSpec, so its blocks are cut and
    routed identically (pinned by tests/test_reshard.py).
    """
    plan = ReshardPlan(
        old_axes=dict(old_axes), new_axes=dict(new_axes),
        old_pods=old_pods, new_pods=new_pods,
    )
    for path in sorted(leaves):
        shape, itemsize, spec = leaves[path]
        t, l = plan_leaf(
            path, shape, itemsize, spec, old_axes, new_axes,
            old_pods=old_pods, new_pods=new_pods, survivors=survivors,
        )
        plan.transfers.extend(t)
        plan.locals_.extend(l)
    return plan


# ---------------------------------------------------------------------------
# the port's TrainState as planner leaves
# ---------------------------------------------------------------------------

COUNTER_ITEMSIZE = 4  # counters reshard as int32 scalars, as the reference's


@dataclass
class StateLeaf:
    """One leaf of a TrainState: a tensor (a DTensor on a mesh) or an int
    counter, its spec, and `put(value)`, which replaces it in the state."""

    path: str
    value: Any
    spec: PartitionSpec
    put: Callable[[Any], None]


def _keystr(keys) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _tree_paths(tree, keys=()):
    """(keys, leaf) in models/llama.py `tree_leaves` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, keys + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, keys + (i,))
    else:
        yield keys, tree


def _spec_at(spec_tree, keys) -> PartitionSpec:
    node = spec_tree
    for k in keys:
        if isinstance(node, PartitionSpec):
            break
        try:
            node = node[k]
        except (KeyError, IndexError, TypeError) as e:
            raise PlanError(f"spec tree has no entry {_keystr(keys)}") from e
    if not isinstance(node, PartitionSpec):
        raise PlanError(f"spec tree entry {_keystr(keys)} is not a PartitionSpec")
    return node


def _setter(parent, key) -> Callable[[Any], None]:
    def put(value):
        parent[key] = value
    return put


def _leaf_putter(tree, keys) -> Callable[[Any], None]:
    node = tree
    for k in keys[:-1]:
        node = node[k]
    return _setter(node, keys[-1])


def state_leaves(state, spec_tree=None) -> List[StateLeaf]:
    """Every leaf of `state` (parallel/train_step.py TrainState): the
    parameters with their specs from `spec_tree` (P() for each without
    one), each per-parameter optimizer slot (a list of tensors laid out as
    the parameters: AdamW's mu and nu, MultiSteps' accumulators) with its
    parameter's spec, each int counter of the optimizer state, and the
    step. Raises PlanError on anything else."""
    import torch

    params = state.params
    pkeys, pspecs, pshapes = [], [], []
    out: List[StateLeaf] = []
    for keys, leaf in _tree_paths(params):
        spec = P() if spec_tree is None else _spec_at(spec_tree, keys)
        pkeys.append(keys)
        pspecs.append(spec)
        pshapes.append(tuple(leaf.shape))
        out.append(StateLeaf(".params" + _keystr(keys), leaf, spec, _leaf_putter(params, keys)))

    def is_slots(node) -> bool:
        return (isinstance(node, list) and len(node) == len(pkeys) and len(node) > 0
                and all(isinstance(t, torch.Tensor) and tuple(t.shape) == s
                        for t, s in zip(node, pshapes)))

    def walk(node, keys):
        if is_slots(node):
            for i, t in enumerate(node):
                out.append(StateLeaf(".opt_state" + _keystr(keys) + _keystr(pkeys[i]), t,
                                     pspecs[i], _setter(node, i)))
            return
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, list) else None)
        if items is None:
            raise PlanError(f"optimizer state {_keystr(keys)} is a "
                            f"{type(node).__name__}, not a dict or list")
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v, keys + (k,))
            elif isinstance(v, int) and not isinstance(v, bool):
                out.append(StateLeaf(".opt_state" + _keystr(keys + (k,)), v, P(),
                                     _setter(node, k)))
            else:
                raise PlanError(f"optimizer state leaf {_keystr(keys + (k,))} is a "
                                f"{type(v).__name__}: layout unknown, cannot plan a reshard")

    walk(state.opt_state, ())

    def put_step(value):
        state.step = value
    out.append(StateLeaf(".step", int(state.step), P(), put_step))
    return out


def _gang_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def leaves_from_state(state, spec_tree=None) -> Dict[str, Tuple[Tuple[int, ...], int, object]]:
    """(shape, itemsize, PartitionSpec) per leaf of a live TrainState
    (params, optimizer state, step -- everything reshards together). A
    DTensor leaf must be laid out as its spec says; a plain tensor is the
    whole leaf, allowed only on a process outside a gang of several (one
    device: every spec holds the whole leaf there). Anything else raises
    PlanError: the layout is unknown and the caller falls back."""
    from torch.distributed.tensor import DTensor

    from kubedl_tpu_torch.parallel.mesh import placements

    out = {}
    for leaf in state_leaves(state, spec_tree):
        v = leaf.value
        if isinstance(v, int):
            out[leaf.path] = ((), COUNTER_ITEMSIZE, leaf.spec)
            continue
        if isinstance(v, DTensor):
            want = tuple(placements(v.device_mesh, leaf.spec))
            if tuple(v.placements) != want:
                raise PlanError(f"leaf {leaf.path} has placements {tuple(v.placements)}, "
                                f"not those of its spec {tuple(leaf.spec)} ({want})")
        elif _gang_size() > 1:
            raise PlanError(f"leaf {leaf.path} is a plain {type(v).__name__} in a gang of "
                            f"{_gang_size()} -- layout unknown, cannot plan a reshard")
        out[leaf.path] = (tuple(v.shape), v.element_size(), leaf.spec)
    return out


def coverage(region: Rect, rects: Iterable[Rect]) -> Tuple[int, int]:
    """(elements of `region` no rect covers, elements covered more than
    once), from the rects' corners alone: `assemble`'s check without
    decoding a byte. Every rect must lie inside `region`."""
    rects = list(rects)
    if not region:
        return int(not rects), int(len(rects) > 1)
    cuts = [sorted({a, b} | {x for r in rects for x in r[d]})
            for d, (a, b) in enumerate(region)]
    count = np.zeros([len(c) - 1 for c in cuts], np.int64)
    for r in rects:
        count[tuple(slice(c.index(a), c.index(b)) for c, (a, b) in zip(cuts, r))] += 1
    vol = np.ones(count.shape, np.int64)
    for d, c in enumerate(cuts):
        w = np.diff(np.asarray(c, np.int64))
        vol = vol * w.reshape([-1 if i == d else 1 for i in range(len(cuts))])
    return int(vol[count == 0].sum()), int(vol[count > 1].sum())


# ---------------------------------------------------------------------------
# numpy reference executor (property tests + the staged-restart lane)
# ---------------------------------------------------------------------------


def extract_block(arr: np.ndarray, rect: Rect) -> np.ndarray:
    return arr[tuple(slice(a, b) for a, b in rect)]


def pod_region(
    shape: Sequence[int], spec, axes: Dict[str, int], n_pods: int, pod: int
) -> List[Rect]:
    """Deduped chunk hyperrects pod `pod` owns for a leaf under a mesh."""
    shape = tuple(int(s) for s in shape)
    dims = normalize_spec(spec, len(shape))
    counts = _chunk_counts(shape, dims, axes)
    n_dev = mesh_device_count(axes)
    rects = []
    seen = set()
    for flat, vec in enumerate(_device_chunk_vecs(shape, dims, axes)):
        if pod_of_device(flat, n_dev, n_pods) != pod or vec in seen:
            continue
        seen.add(vec)
        rects.append(chunk_rect(shape, counts, vec))
    return rects


def assemble(
    shape: Sequence[int],
    dtype,
    pieces: Iterable[Tuple[Rect, np.ndarray]],
    region: Optional[Rect] = None,
) -> np.ndarray:
    """Build `region` (default: the whole leaf) from blocks, verifying
    exactly-once coverage — partial or overlapping delivery raises
    PlanError instead of returning silently corrupt state."""
    shape = tuple(int(s) for s in shape)
    if region is None:
        region = tuple((0, s) for s in shape)
    off = [a for a, _ in region]
    rshape = tuple(b - a for a, b in region)
    out = np.zeros(rshape, dtype=dtype)
    count = np.zeros(rshape, dtype=np.int16)
    for rect, block in pieces:
        sl = tuple(
            slice(a - o, b - o) for (a, b), o in zip(rect, off)
        )
        if block.shape != tuple(b - a for a, b in rect):
            raise PlanError(f"block shape {block.shape} != rect {rect}")
        out[sl] = block
        count[sl] += 1
    if (count != 1).any():
        under = int((count == 0).sum())
        over = int((count > 1).sum())
        raise PlanError(
            f"coverage violation assembling {region}: {under} elements "
            f"missing, {over} delivered more than once"
        )
    return out
