"""Checkpoints of the whole TrainState (the port's counterpart of the
Orbax CheckpointManager calls in kubedl_tpu/train/trainer.py:411-470).

Step N lives in ``<directory>/<N>/state.pt`` -- digit-named step
directories, the layout Orbax makes and the operator's tests read. A save
writes into a hidden temporary directory and renames it into place
(``os.replace``), so a SIGTERM in the middle of a save never leaves a
partial newest step; ``max_to_keep`` prunes the oldest steps after each
save. Saves are synchronous. A restore reads the file into host memory
(memory-mapped) and copies it leaf by leaf into the live state's tensors,
so the device never holds two copies of the state.

A sharded state (DTensor leaves, parallel/train_step.py on a mesh) is
saved by `torch.distributed.checkpoint` into the same digit-named step
directory: every rank writes its own shards of a hidden temporary
directory, rank 0 renames it into place after a barrier and prunes, and a
restore loads each rank's shards straight into the live sharded state.
Every rank of the gang calls save and restore together.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

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
        with torch.no_grad():
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


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and any(
            os.path.isfile(os.path.join(self.directory, n, f))
            for f in (STATE_FILE, SHARDED_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write the state as step `step`, atomically, then prune."""
        if _sharded(state):
            return self._save_sharded(step, state)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        payload = {"params": state.params, "opt_state": state.opt_state,
                   "step": int(state.step)}
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        self._publish(tmp, step)

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

        tmp = os.path.join(self.directory, f".tmp-{step}")
        if _rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier()
        dcp.save({"params": state.params, "opt_state": state.opt_state,
                  "step": int(state.step)}, checkpoint_id=tmp)
        _barrier()  # every rank's shards are on disk
        if _rank() == 0:
            self._publish(tmp, step)
        _barrier()

    def restore(self, step: int, state):
        """Copy step `step` into `state` in place; returns state."""
        if _sharded(state):
            import torch.distributed.checkpoint as dcp

            payload = {"params": state.params, "opt_state": state.opt_state, "step": 0}
            dcp.load(payload, checkpoint_id=os.path.join(self.directory, str(step)))
            state.step = int(payload["step"])
            return state
        path = os.path.join(self.directory, str(step), STATE_FILE)
        saved = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
        state.params = _assign(state.params, saved["params"], "params")
        state.opt_state = _assign(state.opt_state, saved["opt_state"], "opt_state")
        state.step = int(saved["step"])
        return state
