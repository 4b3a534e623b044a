"""Checkpoints of the whole TrainState (the port's counterpart of the
Orbax CheckpointManager calls in kubedl_tpu/train/trainer.py:411-470).

Step N lives in ``<directory>/<N>/state.pt`` -- digit-named step
directories, the layout Orbax makes and the operator's tests read. A save
writes into a hidden temporary directory and renames it into place
(``os.replace``), so a SIGTERM in the middle of a save never leaves a
partial newest step; ``max_to_keep`` prunes the oldest steps after each
save. A restore reads the file into host memory (memory-mapped) and copies
it leaf by leaf into the live state's tensors, so the device never holds
two copies of the state.

Saves are asynchronous, as Orbax's are. `save` returns once the state is
snapshotted to host memory: a CUDA leaf is copied into a page-locked host
buffer (one a dtype, allocated at the first save and reused while the
state's layout stays) and the copy is waited for, a CPU leaf is cloned, so
a train step that changes a leaf in place afterwards never reaches the
file. A writer thread then writes the snapshot, fsyncs, renames it into
place and prunes. The thread is not a daemon: a process that ends while a
save is in flight still completes it. At most one save is in flight; a
save first waits for the one before it. `wait_until_finished` waits for
the write (a final save is `save` and then `wait_until_finished`), and an
error on the writer is raised on the caller's thread by the next `save`
or `wait_until_finished`. `latest_step` and `all_steps` list published
steps only, so they lag a write in flight, as Orbax's do.

A sharded state (DTensor leaves, parallel/train_step.py on a mesh) is
saved by `torch.distributed.checkpoint.async_save` into the same
digit-named step directory: its staging to CPU memory is the snapshot,
and every rank writes its own shards of a hidden temporary directory on
DCP's thread. The write's collectives run over a gloo group of the
manager's own, made by every rank together when the manager is made, so
no collective of the default group runs off the main thread. Rank 0
renames the directory into place and prunes once its own write completed:
DCP's coordinator writes ``.metadata`` only after it gathered every rank's
write results, and every rank's write completes only after that. Every
rank of the gang calls save and restore together. A restore reads the
step's own layout into the live state's, so a step saved by one process
restores into a gang's shards and a gang's sharded step into one process
(a live reshard's fallback after the gang's size changed).
"""
from __future__ import annotations

import math
import mmap
import os
import shutil
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
SHARDED_FILE = ".metadata"  # torch.distributed.checkpoint's index of a step


def _sharded(state) -> bool:
    from torch.distributed.tensor import DTensor

    from kubedl_tpu_torch.models.llama import tree_leaves

    return any(isinstance(p, DTensor) for p in tree_leaves(state.params))


def _barrier():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _assign(live: Any, saved: Any, path: str = "state") -> Any:
    """Copy `saved` into `live` tensor by tensor (same structure, shapes
    and dtypes); returns the value that replaces `live`."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != live.shape \
                or saved.dtype != live.dtype:
            raise ValueError(f"checkpoint leaf {path}: {getattr(saved, 'shape', saved)} "
                             f"{getattr(saved, 'dtype', '')} does not match "
                             f"{tuple(live.shape)} {live.dtype}")
        from torch.distributed.tensor import DTensor, distribute_tensor

        with torch.no_grad():
            if isinstance(live, DTensor):  # this rank's part of the whole leaf
                part = distribute_tensor(saved.to(live.device), live.device_mesh,
                                         live.placements, src_data_rank=None)
                live.to_local().copy_(part.to_local())
            else:
                live.copy_(saved)
        return live
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"checkpoint {path}: keys differ from the live state")
        for k in live:
            live[k] = _assign(live[k], saved[k], f"{path}.{k}")
        return live
    if isinstance(live, list):
        if not isinstance(saved, list) or len(saved) != len(live):
            raise ValueError(f"checkpoint {path}: length differs from the live state")
        return [_assign(a, b, f"{path}[{i}]") for i, (a, b) in enumerate(zip(live, saved))]
    return saved


def _dcp_view(tree):
    """`tree` as torch.distributed.checkpoint reads it back: lists as dicts
    keyed by position (the same flattened keys) and empty containers left
    out, since DCP's save writes no key for them and its load asks for one
    (the clip stage's empty state in optim.chain). Tensors are the tree's
    own, which the load fills in place."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return tree
    view = {}
    for k, v in tree.items():
        v = _dcp_view(v)
        if not (isinstance(v, dict) and not v):
            view[k] = v
    return view


def _from_view(tree, view):
    """`tree` with the non-tensor leaves that a load wrote into its
    `_dcp_view` (containers updated in place, as a load into the tree
    itself would)."""
    if isinstance(tree, dict):
        for k in tree:
            if k in view:
                tree[k] = _from_view(tree[k], view[k])
        return tree
    if isinstance(tree, (list, tuple)):
        items = [_from_view(v, view[str(i)]) if str(i) in view else v
                 for i, v in enumerate(tree)]
        if isinstance(tree, list):
            tree[:] = items
            return tree
        return type(tree)(items)
    return tree if isinstance(tree, torch.Tensor) else view


def all_steps(directory: str) -> List[int]:
    """The complete steps under `directory`, oldest first ([] if none)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit() and any(
        os.path.isfile(os.path.join(directory, n, f)) for f in (STATE_FILE, SHARDED_FILE)))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under `directory`, or None; creates nothing."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _unregister(ptrs: List[int]) -> None:
    for ptr in ptrs:
        torch.cuda.cudart().cudaHostUnregister(ptr)


class _Pinned:
    """Page-locked host buffers for the CUDA leaves of one state layout
    (a list of (shape, dtype)): one buffer a dtype, each leaf a view of
    it. Each buffer is an anonymous mapping of its own, page-locked whole
    with cudaHostRegister at its exact size, where the caching host
    allocator would round a buffer up to a power of two."""

    def __init__(self, layout):
        self.layout = layout
        offsets, total = [], {}
        for shape, dtype in layout:
            offsets.append(total.get(dtype, 0))
            total[dtype] = offsets[-1] + math.prod(shape)
        flat, ptrs = {}, []
        for dtype, n in total.items():
            nbytes = max(n * dtype.itemsize, dtype.itemsize)
            buf = torch.frombuffer(mmap.mmap(-1, nbytes), dtype=torch.uint8)
            err = int(torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), nbytes, 0))
            if err:
                _unregister(ptrs)
                raise RuntimeError(f"checkpoint snapshot: cudaHostRegister of "
                                   f"{nbytes / 1e9:.2f} GB of host memory failed "
                                   f"(cudaError {err})")
            ptrs.append(buf.data_ptr())
            flat[dtype] = buf.view(dtype)
        self._unregister = weakref.finalize(self, _unregister, ptrs)
        self.views = [flat[dtype][off:off + math.prod(shape)].view(shape)
                      for (shape, dtype), off in zip(layout, offsets)]


def _tensors(tree) -> List[torch.Tensor]:
    from kubedl_tpu_torch.models.llama import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _rebuild(tree, take):
    """`tree` with every tensor leaf replaced by take(leaf), in order."""
    if isinstance(tree, torch.Tensor):
        return take(tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, take) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, take) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, tracer=None):
        """`tracer` (obs/trace.py), if given, gets a ``ckpt.write`` span
        for each write: the writer's seconds, the step and its bytes. In a
        process group every rank makes its manager together (the sharded
        writes' gloo group is made here)."""
        import torch.distributed as dist

        self.directory = directory
        self.max_to_keep = max_to_keep
        self.tracer = tracer
        os.makedirs(directory, exist_ok=True)
        self._group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self._pinned: Optional[_Pinned] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def save(self, step: int, state) -> None:
        """Start saving the state as step `step`; returns once the state is
        snapshotted to host memory, while a writer thread writes it. Waits
        for the previous save first (and raises its error, if it failed)."""
        self.wait_until_finished()
        if _sharded(state):
            return self._save_sharded(step, state)
        payload = {"params": state.params, "opt_state": state.opt_state,
                   "step": int(state.step)}
        payload = self._snapshot(payload)
        nbytes = sum(t.nbytes for t in _tensors(payload))
        self._start(self._write, step, payload, nbytes)

    def wait_until_finished(self) -> None:
        """Wait for the save in flight, if any; raise its writer's error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _snapshot(self, payload: Dict) -> Dict:
        """The payload with every leaf copied off the live state: CUDA
        leaves into the pinned buffers (waited for), CPU leaves cloned."""
        cuda = [t for t in _tensors(payload) if t.is_cuda]
        layout = [(tuple(t.shape), t.dtype) for t in cuda]
        if cuda and (self._pinned is None or self._pinned.layout != layout):
            self._pinned = None  # the old buffers go before the new ones are made
            self._pinned = _Pinned(layout)
        views = iter(self._pinned.views if cuda else ())

        def take(t):
            if t.is_cuda:
                return next(views).copy_(t.detach(), non_blocking=True)
            return t.detach().clone()

        with torch.no_grad():
            out = _rebuild(payload, take)
        if cuda:
            torch.cuda.synchronize()
        return out

    def _start(self, fn, *args) -> None:
        def run():
            try:
                fn(*args)
            except BaseException as e:  # noqa: BLE001 -- raised on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=run, name="checkpoint-writer", daemon=False)
        self._thread.start()

    def _record(self, step: int, seconds: float, nbytes: int, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.record("ckpt.write", duration_s=seconds, step=step, bytes=nbytes,
                               **attrs)

    def _write(self, step: int, payload: Dict, nbytes: int) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        # a file object, not a path: torch.save's own file writer is the
        # slower of the two (train/checkpoint_probe.py, PERF.md §6)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            t_sync = time.perf_counter()
            os.fsync(f.fileno())
        self._publish(tmp, step)
        self._record(step, time.perf_counter() - t0, nbytes,
                     fsync_s=round(time.perf_counter() - t_sync, 6))

    def _publish(self, tmp: str, step: int) -> None:
        """Rename a finished temporary directory into step `step`; prune."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):  # a step saved again: swap the old one out
            old = os.path.join(self.directory, f".old-{step}-{os.getpid()}")
            os.replace(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, final)
        for s in self.all_steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)

    def _save_sharded(self, step: int, state) -> None:
        import torch.distributed.checkpoint as dcp
        from torch.distributed.tensor import DTensor

        if self._group is None:
            raise RuntimeError("a sharded state's checkpoint manager must be made after "
                               "the process group (train/coordinator.py initialize)")
        tmp = os.path.join(self.directory, f".tmp-{step}")
        if _rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier()
        payload = {"params": state.params, "opt_state": state.opt_state,
                   "step": int(state.step)}
        nbytes = sum((t.to_local() if isinstance(t, DTensor) else t).nbytes
                     for t in _tensors(payload))
        written = dcp.async_save(payload, checkpoint_id=tmp, process_group=self._group)
        t0 = time.perf_counter()

        def finish():
            written.result()  # this rank's shards, and on rank 0 .metadata, on disk
            if _rank() == 0:
                self._publish(tmp, step)
            self._record(step, time.perf_counter() - t0, nbytes)

        self._start(finish)

    def restore(self, step: int, state):
        """Copy step `step` into `state` in place; returns state. Either
        layout restores into either state, so a gang whose size changed
        (a live reshard's closed fallback) reads the last save: a sharded
        step into one process's whole leaves, a one-process step into each
        rank's shards. Waits for a save in flight first."""
        self.wait_until_finished()
        if os.path.isfile(os.path.join(self.directory, str(step), SHARDED_FILE)):
            import torch.distributed.checkpoint as dcp

            payload = {"params": state.params, "opt_state": state.opt_state, "step": 0}
            view = _dcp_view(payload)
            dcp.load(view, checkpoint_id=os.path.join(self.directory, str(step)))
            payload = _from_view(payload, view)
            state.params, state.opt_state = payload["params"], payload["opt_state"]
            state.step = int(payload["step"])
            return state
        path = os.path.join(self.directory, str(step), STATE_FILE)
        saved = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
        state.params = _assign(state.params, saved["params"], "params")
        state.opt_state = _assign(state.opt_state, saved["opt_state"], "opt_state")
        state.step = int(saved["step"])
        return state
