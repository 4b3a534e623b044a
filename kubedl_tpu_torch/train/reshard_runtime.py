"""Live-reshard runtime -- the trainer side of the resize protocol (the port
of kubedl_tpu/train/reshard_runtime.py).

The scheduler posts a RESIZE control message into the pod's control dir
(KUBEDL_CONTROL_DIR) or over the socket plane (transport/control.py); the
trainer polls it at step boundaries and runs the reshard ladder:

  1. in-process live reshard (`live_resize`): quiesce at the step
     boundary, refit the mesh's batch axes, resume at step N+1. A process
     holds one device and torch.distributed pins the world size, so this
     lane answers a resize that keeps the chip count, whose refit is the
     same mesh: nothing moves. (`reshard_state` moves a state onto another
     mesh over the same group, byte-preserving, for callers that build
     one.)
  2. staged restart, for a resize that changes the chip count: every pod
     (a process, numbered by its flat index in the mesh) quiesces and
     writes the shard blocks the new topology needs (parallel/reshard.py
     plan, old pods the old world, new pods the new chip count) into the
     shared staging dir, plus a digest marker; worker 0 publishes the
     manifest only after every pod's marker landed with a MATCHING plan
     digest; the pods exit retryable and the restart, with
     KUBEDL_NUM_PROCESSES equal to the new chip count, reassembles from
     the staging (`restore_staged`, `state_from_staging`) instead of a
     checkpoint. A pod without the shared volume can pull a peer's
     published staging over the socket plane (transport/blocks.py
     `fetch_staging`, sha-checked, the same validation).
  3. checkpoint restore -- the CLOSED fallback. Any failure, timeout, or
     digest mismatch in (1) or (2) abandons the reshard: the trainer never
     commits a partially-assembled state (`state_from_staging` checks
     exactly-once coverage of every leaf before it writes a byte), never
     saves a checkpoint from one, and exits retryable so the restart
     restores the last durable save.

Replies (ok | staged | fallback | failed) are written next to the message,
in the reference's schema. Staged blocks are npz members of raw bytes named
``json.dumps([path, rect, dtype])``, byte for byte the reference's, so a
staging written by either package restores in the other.
"""
from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import time
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_shape, shard_tensor
from kubedl_tpu_torch.parallel.reshard import (
    PlanError,
    ReshardPlan,
    Transfer,
    _chunk_counts,
    _device_chunk_vecs,
    assemble,
    chunk_rect,
    coverage,
    leaves_from_state,
    normalize_spec,
    plan_reshard,
    state_leaves,
)
# the wire contract lives with the rendezvous scheme (train/coordinator.py)
from kubedl_tpu_torch.train.coordinator import (  # noqa: F401
    ENV_CONTROL_DIR,
    ENV_LIVE_RESHARD,
    ENV_RESHARD_DIR,
)

log = logging.getLogger("kubedl_tpu_torch.reshard")

# test seams: stall inside the reshard critical section so a chaos kill
# provably lands MID-reshard, or force a failure after quiesce to exercise
# the closed fallback deterministically
ENV_TEST_DELAY = "KUBEDL_RESHARD_TEST_DELAY_S"
ENV_TEST_FAIL = "KUBEDL_RESHARD_TEST_FAIL"
# test seam: the trainer prints the whole state's sha256 (`state_digest`)
# after a staged restore and before staging, for bit-for-bit checks
ENV_TEST_DIGEST = "KUBEDL_RESHARD_TEST_DIGEST"

_BATCH_AXES = ("data", "fsdp")

# numpy holds bf16 blocks as int16 words: the same bytes, no ml_dtypes
_STORAGE = {"bfloat16": np.dtype(np.int16)}


class ReshardError(RuntimeError):
    """Live reshard impossible/failed -- fall back closed to checkpoint."""


# ---------------------------------------------------------------------------
# control channel -- dir backend (local executor) or socket backend (kube
# mode, transport/control.py), selected by control_from_env()
# ---------------------------------------------------------------------------


class ReshardControl:
    """Polls KUBEDL_CONTROL_DIR for operator control messages and writes
    replies next to them. Messages are msg-*.json (write-once by the
    scheduler); replies are atomic tmp+rename so a half-written reply is
    never parsed."""

    def __init__(self, control_dir: str) -> None:
        self.dir = control_dir
        self._seen: set = set()

    @classmethod
    def from_env(cls) -> Optional["ReshardControl"]:
        d = os.environ.get(ENV_CONTROL_DIR, "")
        return cls(d) if d else None

    def poll(self) -> Optional[dict]:
        """Earliest unprocessed control message, or None. A message whose
        reply file already exists is SKIPPED: _seen is in-memory, so an
        in-place restart would otherwise replay every already-answered
        RESIZE in the dir (and re-exit, for the staged lane) forever."""
        try:
            entries = set(os.listdir(self.dir))
        except OSError:
            return None
        names = sorted(
            n for n in entries
            if n.startswith("msg-") and n.endswith(".json")
        )
        for name in names:
            if name in self._seen:
                continue
            self._seen.add(name)
            try:
                with open(os.path.join(self.dir, name)) as f:
                    msg = json.load(f)
            except (OSError, ValueError):
                continue  # half-written / corrupt: skip, never crash a step
            if not isinstance(msg, dict):
                continue
            msg.setdefault("reply", name.replace("msg-", "reply-", 1))
            if msg["reply"] in entries:
                continue  # answered by a previous incarnation
            return msg
        return None

    def reply(self, msg: dict, **payload) -> None:
        name = msg.get("reply") or "reply.json"
        tmp = os.path.join(self.dir, f".{name}.tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, os.path.join(self.dir, name))
        except OSError:
            log.warning("could not write reshard reply %s", name)


def control_from_env():
    """The pod's control endpoint: a ``KUBEDL_CONTROL_DIR`` means the local
    executor writes msg files there, and the dir backend wins even when the
    socket plane is also configured. Without one, ``KUBEDL_TRANSPORT=socket``
    listens on the authenticated plane and the scheduler dials the pod
    (transport/control.py). Both expose poll()/reply() with the same reply
    schema. None when neither is configured (resizes then take the
    checkpoint path)."""
    ctl = ReshardControl.from_env()
    if ctl is not None:
        return ctl
    if os.environ.get("KUBEDL_TRANSPORT", "") == "socket":
        from kubedl_tpu_torch.transport import SocketReshardControl, plane_from_env

        plane = plane_from_env(service="reshard-control", latch=False)
        if plane is not None:
            return SocketReshardControl(plane)
    return None


# ---------------------------------------------------------------------------
# mesh refit + in-process live lane
# ---------------------------------------------------------------------------


def refit_axes(axes: Dict[str, int], new_total: int) -> Dict[str, int]:
    """New mesh axes for `new_total` devices: model-sharding axes (tensor /
    context / expert / stage) are preserved exactly -- they are fit- and
    correctness-critical -- and the change is absorbed by the batch axes,
    data first, then fsdp. The grow/shrink factor must be integral so the
    global batch stays shardable; anything else raises ReshardError (the
    caller falls back closed)."""
    full = {k: int(axes.get(k, 1)) for k in AXIS_ORDER}
    fixed = math.prod(v for k, v in full.items() if k not in _BATCH_AXES)
    if new_total % fixed:
        raise ReshardError(
            f"{new_total} devices not divisible by the model axes "
            f"({fixed}: { {k: v for k, v in full.items() if k not in _BATCH_AXES and v > 1} })"
        )
    budget = new_total // fixed
    old_budget = full["data"] * full["fsdp"]
    if budget >= old_budget:
        if budget % old_budget:
            raise ReshardError(
                f"grow factor {budget}/{old_budget} is not integral")
        full["data"] *= budget // old_budget
    else:
        if old_budget % budget:
            raise ReshardError(
                f"shrink factor {old_budget}/{budget} is not integral")
        factor = old_budget // budget
        d_part = math.gcd(full["data"], factor)
        f_part = factor // d_part
        if full["fsdp"] % f_part:
            raise ReshardError(
                f"cannot shrink batch axes data={full['data']} "
                f"fsdp={full['fsdp']} by {factor}")
        full["data"] //= d_part
        full["fsdp"] //= f_part
    return full


def mesh_axes(mesh) -> Dict[str, int]:
    """Every axis of AXIS_ORDER with its size; all 1 without a mesh."""
    shape = mesh_shape(mesh) if mesh is not None else {}
    return {k: int(shape.get(k, 1)) for k in AXIS_ORDER}


def mesh_pod(mesh) -> int:
    """This process's pod in a plan: its flat index in the mesh (0 without
    one). A process holds one device, so a pod of the plan is a process."""
    if mesh is None:
        return 0
    return int(np.ravel_multi_index(tuple(mesh.get_coordinate()), tuple(mesh.mesh.shape)))


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def reshard_state(state, new_mesh, spec_tree=None):
    """Move a live sharded TrainState onto `new_mesh` (a DeviceMesh over the
    same group), keeping each leaf's PartitionSpec -- byte-preserving. Every
    leaf is moved before any is replaced, so a failure leaves the old state
    whole (the card holds both meanwhile). Collective: every rank of the
    gang calls it. The trainer does not: its in-process lane keeps its
    mesh."""
    from torch.distributed.tensor import DTensor

    puts = []
    for leaf in state_leaves(state, spec_tree):
        v = leaf.value
        if isinstance(v, int):
            continue
        if new_mesh is None:
            if isinstance(v, DTensor):
                raise ReshardError(f"state leaf {leaf.path} is a DTensor: a mesh-less "
                                   f"target cannot hold it")
            continue
        full = v.full_tensor() if isinstance(v, DTensor) else v
        moved = shard_tensor(full.detach(), new_mesh, leaf.spec)
        if leaf.path.startswith(".params") and moved.is_floating_point():
            moved.requires_grad_(True)
        puts.append((leaf.put, moved))
    for put, value in puts:
        put(value)
    return state


def _test_hooks() -> None:
    """Chaos-test seams, active only when the envs are set."""
    delay = float(os.environ.get(ENV_TEST_DELAY, "0") or 0)
    if delay > 0:
        time.sleep(delay)
    if os.environ.get(ENV_TEST_FAIL):
        raise ReshardError("KUBEDL_RESHARD_TEST_FAIL injected failure")


def live_resize(state, mesh, new_chips: int, spec_tree=None):
    """In-process lane: returns (mesh, state, plan). A process holds one
    device and torch.distributed pins the world size, so this lane answers
    only a resize that keeps the chip count: `refit_axes` gives the same
    axes, the plan moves nothing, and the state and the mesh stay as they
    are. The caller already quiesced at the step boundary. Raises
    ReshardError on another chip count, a plan error or the test seams --
    the state untouched, so the caller may still checkpoint it before
    falling back."""
    world = _world()
    if new_chips != world:
        raise ReshardError(
            f"resize wants {new_chips} devices, the gang holds {world} (one device a "
            f"process): a changed chip count restarts through the staging")
    try:
        axes = mesh_axes(mesh)
        plan = plan_reshard(leaves_from_state(state, spec_tree), axes,
                            refit_axes(axes, new_chips))
    except PlanError as e:
        raise ReshardError(str(e)) from e
    _test_hooks()
    return mesh, state, plan


# ---------------------------------------------------------------------------
# staged-restart lane
# ---------------------------------------------------------------------------


def _block_key(path: str, rect, dtype) -> str:
    # dtype rides in the key because blocks are staged as raw uint8
    # buffers: npz round-trips bf16 (and friends) as |V2 void otherwise
    return json.dumps([path, [list(r) for r in rect], _dtype_name(dtype)])


def _parse_key(key: str) -> Tuple[str, tuple, str]:
    path, rect, dtype = json.loads(key)
    return path, tuple(tuple(r) for r in rect), dtype


def _dtype_name(dtype) -> str:
    """The reference's dtype string: numpy's name, torch's without "torch."."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str) and dtype in _STORAGE:
        return dtype
    return str(np.dtype(dtype))


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a block of dtype `name` is held in on the host."""
    return _STORAGE.get(name) or np.dtype(name)


def _host_bytes(block) -> Tuple[np.ndarray, str]:
    """(the block's C-order bytes as uint8, its dtype name)."""
    if isinstance(block, torch.Tensor):
        t = block.detach().to("cpu").contiguous()
        return t.reshape(-1).view(torch.uint8).numpy(), _dtype_name(t.dtype)
    block = np.asarray(block)
    return np.frombuffer(block.tobytes(), np.uint8), _dtype_name(block.dtype)


def _local_rect(leaf) -> tuple:
    """The global rect of this process's part of a leaf: its DTensor shard
    (the chunk its mesh coordinate owns under the leaf's spec), or the
    whole leaf."""
    from torch.distributed.tensor import DTensor

    v = leaf.value
    if isinstance(v, int) or v.dim() == 0:
        return ()
    shape = tuple(v.shape)
    if not isinstance(v, DTensor):
        return tuple((0, s) for s in shape)
    axes = mesh_axes(v.device_mesh)
    dims = normalize_spec(leaf.spec, len(shape))
    counts = _chunk_counts(shape, dims, axes)
    vec = _device_chunk_vecs(shape, dims, axes)[mesh_pod(v.device_mesh)]
    rect = chunk_rect(shape, counts, vec)
    local = tuple(v.to_local().shape)
    if local != tuple(b - a for a, b in rect):
        raise ReshardError(f"leaf {leaf.path}: local shard {local} is not the chunk {rect} "
                           f"its spec {tuple(leaf.spec)} gives")
    return rect


def _local_value(leaf):
    """This process's part of a leaf as a tensor (a counter as int32)."""
    from torch.distributed.tensor import DTensor

    v = leaf.value
    if isinstance(v, int):
        return torch.tensor(v, dtype=torch.int32)
    return v.to_local() if isinstance(v, DTensor) else v


def addressable_blocks(state, spec_tree=None) -> Dict[Tuple[str, tuple], torch.Tensor]:
    """(path, global rect) -> host copy of every block this process holds:
    its shard of each leaf (its mesh coordinate under the leaf's spec) --
    the source store the staging lane serves from."""
    out: Dict[Tuple[str, tuple], torch.Tensor] = {}
    for leaf in state_leaves(state, spec_tree):
        out[(leaf.path, _local_rect(leaf))] = _local_value(leaf).detach().to("cpu")
    return out


def provider_from_blocks(blocks):
    """provide(Transfer) -> block, served from resident chunks."""

    def provide(t: Transfer):
        for (path, rect), data in blocks.items():
            if path != t.path or len(rect) != len(t.rect):
                continue
            if all(a >= ra and b <= rb
                   for (a, b), (ra, rb) in zip(t.rect, rect)):
                inner = tuple(
                    slice(a - ra, b - ra)
                    for (a, b), (ra, _) in zip(t.rect, rect))
                return data[inner] if t.rect else data
        raise ReshardError(f"this pod does not hold {t.path} {t.rect}")

    return provide


def stage_shards(
    reshard_dir: str,
    plan: ReshardPlan,
    pod: int,
    provide: Callable[[Transfer], object],
    step: int,
) -> None:
    """Write every block this pod sources (cross-pod AND kept-local -- a
    restarted process has no live memory) as src-<pod>.npz, then the
    digest marker. Marker last: its presence promises the npz is complete.
    `provide` returns a numpy array or a tensor."""
    os.makedirs(reshard_dir, exist_ok=True)
    entries, seen = {}, set()
    nbytes = 0
    for t in plan.for_source(pod):
        nbytes += t.nbytes
        if (t.path, t.rect) in seen:
            continue  # one member serves every destination of a block
        seen.add((t.path, t.rect))
        raw, dtype = _host_bytes(provide(t))
        entries[_block_key(t.path, t.rect, dtype)] = raw
    npz = os.path.join(reshard_dir, f"src-{pod}.npz")
    tmp = npz + ".tmp"
    _write_npz(tmp, entries)
    os.replace(tmp, npz)
    marker = os.path.join(reshard_dir, f"src-{pod}.json")
    tmp = marker + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"digest": plan.digest(), "step": step,
                   "blocks": len(entries), "bytes": nbytes}, f)
    os.replace(tmp, marker)


def _write_npz(path: str, entries: Dict[str, np.ndarray]) -> None:
    """np.savez's file of 1-d uint8 arrays -- the same zip members, each
    an npy 1.0 header and the raw bytes -- with each member's bytes written
    in one call from the array's own buffer, not in 16 MiB copies."""
    import zipfile

    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, raw in entries.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, np.lib.format.header_data_from_array_1_0(raw))
                fid.write(memoryview(np.ascontiguousarray(raw)).cast("B"))


def _read_npz_member(zf, member: str, dtype: np.dtype) -> np.ndarray:
    """One npz member (a 1-d uint8 npy array) as a flat array of `dtype`,
    read in one call (the zip's CRC is checked at its end)."""
    with zf.open(member + ".npy") as f:
        raw = f.read()
    if raw[:6] != b"\x93NUMPY":
        raise ReshardError(f"staged member {member!r} is not an npy array")
    width = 2 if raw[6] == 1 else 4
    size = int.from_bytes(raw[8:8 + width], "little")
    header = raw[8 + width:8 + width + size].decode("latin1")
    if "'|u1'" not in header or "'fortran_order': False" not in header:
        raise ReshardError(f"staged member {member!r} is not a flat uint8 array: {header}")
    return np.frombuffer(raw, np.uint8, offset=8 + width + size).view(dtype)


def write_manifest(
    reshard_dir: str,
    plan: ReshardPlan,
    step: int,
    n_pods: int,
    timeout: float = 30.0,
) -> bool:
    """Worker 0 publishes manifest.json only after EVERY pod's marker
    landed with the same plan digest -- the commit point of the staged
    lane. Timeout or any digest mismatch aborts (no manifest => every
    restarting pod falls back closed to checkpoint restore)."""
    digest = plan.digest()
    deadline = time.monotonic() + timeout
    while True:
        # a marker with a foreign digest/step counts as NOT YET staged: it
        # may be a stale leftover the peer is about to overwrite. A genuine
        # disagreement persists until the deadline and aborts then.
        pending = []
        for pod in range(n_pods):
            marker = os.path.join(reshard_dir, f"src-{pod}.json")
            try:
                with open(marker) as f:
                    info = json.load(f)
            except (OSError, ValueError):
                pending.append(pod)
                continue
            if info.get("digest") != digest or info.get("step") != step:
                pending.append(pod)
        if not pending:
            break
        if time.monotonic() >= deadline:
            log.error("staged reshard aborted: pods %s never staged a "
                      "matching plan within %.1fs", pending, timeout)
            return False
        time.sleep(0.05)
    manifest = {
        "step": step,
        "digest": digest,
        "old_axes": {k: plan.old_axes.get(k, 1) for k in AXIS_ORDER},
        "new_axes": {k: plan.new_axes.get(k, 1) for k in AXIS_ORDER},
        "old_pods": plan.old_pods,
        "new_pods": plan.new_pods,
    }
    tmp = os.path.join(reshard_dir, ".manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(reshard_dir, "manifest.json"))
    return True


class StagedBlocks:
    """Lazy view over the staged npz files: the index (key -> source file
    member) is built eagerly for validation, but block BYTES decode only
    on access -- a pod must not materialize every peer's full state to
    assemble its own shards. `load` gives a numpy array in the block's
    storage dtype (bf16 as int16 words)."""

    def __init__(self) -> None:
        self._index: Dict[Tuple[str, tuple], Tuple[str, str, str]] = {}
        self._npz: Dict[str, object] = {}  # path -> its open ZipFile

    def add(self, block_key: Tuple[str, tuple], npz: str, member: str,
            dtype: str) -> None:
        self._index.setdefault(block_key, (npz, member, dtype))

    def keys(self):
        return self._index.keys()

    def load(self, block_key: Tuple[str, tuple]) -> np.ndarray:
        npz, member, dtype = self._index[block_key]
        _, rect = block_key
        shape = tuple(b - a for a, b in rect)
        if npz not in self._npz:
            import zipfile

            self._npz[npz] = zipfile.ZipFile(npz)
        block = _read_npz_member(self._npz[npz], member, storage_dtype(dtype))
        if block.size != math.prod(shape):
            raise ReshardError(f"staged block {block_key} holds {block.size} elements")
        return block.reshape(shape)

    def close(self) -> None:
        for zf in self._npz.values():
            zf.close()
        self._npz.clear()

    def items(self):
        """Eager iteration (tests / small states)."""
        for k in self._index:
            yield k, self.load(k)


def staging_exists(reshard_dir: str) -> bool:
    """A PUBLISHED staging (manifest present). Only a committed-but-invalid
    staging may be cleared -- clearing on a merely-missing manifest would
    delete PEERS' in-flight src files mid-stage."""
    return os.path.exists(os.path.join(reshard_dir, "manifest.json"))


def restore_staged(
    reshard_dir: str,
    pod: int,
    n_pods: int,
    expect_axes: Optional[Dict[str, int]] = None,
) -> Optional[Tuple[int, Dict[str, int], StagedBlocks]]:
    """Validate the staging and return (step, new_axes, blocks) or None.

    Fails CLOSED: missing/invalid manifest, a marker digest that does not
    match, a missing source file, or a topology other than expected all
    return None -- the caller then restores from the checkpoint. The caller
    assembles through `state_from_staging`, which enforces exactly-once
    coverage, so a stale or partial staging can never become training
    state."""
    try:
        with open(os.path.join(reshard_dir, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    digest = manifest.get("digest")
    new_axes = manifest.get("new_axes") or {}
    if expect_axes is not None:
        want = {k: int(expect_axes.get(k, 1)) for k in AXIS_ORDER}
        if {k: int(new_axes.get(k, 1)) for k in AXIS_ORDER} != want:
            log.warning("staging topology %s != expected %s; falling back",
                        new_axes, want)
            return None
    if int(manifest.get("new_pods", -1)) != n_pods:
        return None
    blocks = StagedBlocks()
    for src in range(int(manifest.get("old_pods", n_pods))):
        marker = os.path.join(reshard_dir, f"src-{src}.json")
        npz = os.path.join(reshard_dir, f"src-{src}.npz")
        try:
            with open(marker) as f:
                info = json.load(f)
            if info.get("digest") != digest:
                log.warning("src-%d digest mismatch; falling back", src)
                return None
            with np.load(npz) as data:
                names = list(data.files)  # index only; no byte decode
            for key in names:
                path, rect, dtype = _parse_key(key)
                blocks.add((path, rect), npz, key, dtype)
        except (OSError, ValueError, KeyError):
            log.warning("staging src-%d unreadable; falling back", src)
            return None
    return int(manifest["step"]), {
        k: int(new_axes.get(k, 1)) for k in AXIS_ORDER}, blocks


def _inside(r, rect) -> bool:
    return len(r) == len(rect) and all(
        a >= ra and b <= rb for (a, b), (ra, rb) in zip(r, rect))


def state_from_staging(blocks, state_template, spec_tree=None, stats=None):
    """Rebuild a TrainState from staged blocks: `state_template` (an
    init_state run on the NEW mesh) supplies structure, shapes, dtypes and
    each leaf's placement; its values are overwritten in place, leaf by
    leaf, with this process's part assembled from the blocks -- the card
    never holds two states. Every leaf's exactly-once coverage is checked
    from the blocks' rects before the first byte is written, so a gap or an
    overlap raises PlanError with the template untouched (a leaf the staging
    holds no block of is a gap of all its elements, where the reference
    raises "staging holds no blocks"); the caller falls back closed to
    checkpoint. `stats`, a dict, gets the blocks and bytes read."""
    all_keys = list(blocks.keys())
    load = blocks.load if hasattr(blocks, "load") else (lambda k: blocks[k])
    by_path: Dict[str, list] = {}
    for p, r in all_keys:
        by_path.setdefault(p, []).append(r)

    work = []
    for leaf in state_leaves(state_template, spec_tree):
        rect = _local_rect(leaf)
        mine = [r for r in by_path.get(leaf.path, ()) if _inside(r, rect)]
        under, over = coverage(rect, mine)
        if under or over:
            raise PlanError(
                f"coverage violation assembling {leaf.path} {rect}: {under} elements "
                f"missing, {over} delivered more than once")
        work.append((leaf, rect, mine))

    # every leaf's part is covered exactly once: each block goes straight
    # into its place in the local tensor, one host-to-device copy a block
    for leaf, rect, mine in work:
        local = _local_value(leaf)
        name = _dtype_name(local.dtype)
        store = storage_dtype(name)
        for r in mine:
            block = np.asarray(load((leaf.path, r)))
            if stats is not None:
                stats["blocks"] = stats.get("blocks", 0) + 1
                stats["bytes"] = stats.get("bytes", 0) + block.nbytes
            if block.dtype != store:
                raise ReshardError(f"leaf {leaf.path}: staged block {r} is {block.dtype}, "
                                   f"the state holds {name}")
            if isinstance(leaf.value, int):
                leaf.put(int(block))
                continue
            at = tuple(slice(a - o, b - o) for (a, b), (o, _) in zip(r, rect))
            with torch.no_grad(), warnings.catch_warnings():
                # the block is read only here: torch warns of the read-only buffer
                warnings.simplefilter("ignore", UserWarning)
                local[at].copy_(torch.from_numpy(np.ascontiguousarray(block)).view(local.dtype))
    return state_template


def clear_staging(reshard_dir: str) -> None:
    """Remove a consumed or invalid staging so it can never be replayed."""
    try:
        for name in os.listdir(reshard_dir):
            if name == "manifest.json" or name.startswith("src-"):
                try:
                    os.remove(os.path.join(reshard_dir, name))
                except OSError:
                    pass
    except OSError:
        pass


# ---------------------------------------------------------------------------
# the state's fingerprint (bit-for-bit checks across a reshard)
# ---------------------------------------------------------------------------


def state_digest(state, spec_tree=None, group=None) -> Optional[Dict[str, str]]:
    """sha256 of every leaf's global array, gathered leaf by leaf on the
    host (over `group`, a gloo group: each part that no lower rank holds
    goes to rank 0), plus "*": the sha256 of the sorted (path, digest)
    pairs. Rank 0 gets the dict, the other ranks None. Collective in a
    gang."""
    import torch.distributed as dist

    gang = dist.is_initialized() and dist.get_world_size(group) > 1
    rank = dist.get_rank(group) if gang else 0
    n = dist.get_world_size(group) if gang else 1
    from concurrent.futures import ThreadPoolExecutor

    leaves = sorted(state_leaves(state, spec_tree), key=lambda x: x.path)
    mine = [_local_rect(leaf) for leaf in leaves]
    rects = [mine]
    if gang:
        rects = [None] * n
        dist.all_gather_object(rects, mine, group=group)
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))  # sha256 frees the GIL
    out = {}
    for i, leaf in enumerate(leaves):
        raw, dtype = _host_bytes(_local_value(leaf))
        if gang:
            held = {tuple(rects[0][i]): raw}
            for r in range(1, n):
                rect = tuple(rects[r][i])
                if any(tuple(rects[q][i]) == rect for q in range(r)):
                    continue  # a replica of a part a lower rank sends
                peer = dist.get_global_rank(group, r) if group is not None else r
                root = dist.get_global_rank(group, 0) if group is not None else 0
                if rank == r:
                    dist.send(torch.from_numpy(raw.copy()), root, group=group)
                elif rank == 0:
                    buf = torch.empty(raw.size, dtype=torch.uint8)
                    dist.recv(buf, peer, group=group)
                    held[rect] = buf.numpy()
            if rank != 0:
                continue
            store = storage_dtype(dtype)
            shape = () if isinstance(leaf.value, int) else tuple(leaf.value.shape)
            if len(held) > 1:
                full = assemble(shape, store, [(r, b.view(store).reshape([y - x for x, y in r]))
                                               for r, b in held.items()])
                raw = full.reshape(-1).view(np.uint8)
        out[leaf.path] = pool.submit(lambda b: hashlib.sha256(b).hexdigest(), raw)
    pool.shutdown(wait=True)
    if rank != 0:
        return None
    out = {k: f.result() for k, f in out.items()}
    out["*"] = hashlib.sha256(json.dumps(sorted(out.items())).encode()).hexdigest()
    return out


# ---------------------------------------------------------------------------
# the granted slice (the chip count of kubedl_tpu/executor/tpu_topology.py
# `parse_slice_type`)
# ---------------------------------------------------------------------------

_SLICE_GENERATIONS = ("v4", "v5p", "v5e", "v6e")


def slice_chips(name: str) -> int:
    """Chips of a TPU slice type ("v5e-8" -> 8; v4/v5p names count
    TensorCores, two a chip: "v5p-32" -> 16). Raises ValueError."""
    import re

    m = re.fullmatch(r"(v\d+[ep]?)-(\d+)", name.strip())
    if not m:
        raise ValueError(f"unrecognized TPU slice type: {name!r}")
    gen, chips = m.group(1), int(m.group(2))
    if gen not in _SLICE_GENERATIONS:
        raise ValueError(f"unknown TPU generation {gen!r} in {name!r}")
    return max(chips // 2, 1) if gen in ("v4", "v5p") else chips
