"""Process identity from the operator-injected env (the port's copy of
kubedl_tpu/train/coordinator.py's env contract).

The operator injects KUBEDL_COORDINATOR_ADDRESS / KUBEDL_NUM_PROCESSES /
KUBEDL_PROCESS_ID (and the multislice and live-reshard names below).
This slice of the port runs one process on one device: `initialize()`
returns the info of that process and raises for a multi-process gang,
whose rendezvous (torch.distributed) is still to port (ROADMAP.md).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

ENV_COORDINATOR_ADDRESS = "KUBEDL_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KUBEDL_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBEDL_PROCESS_ID"
ENV_NUM_SLICES = "KUBEDL_NUM_SLICES"
ENV_SLICE_ID = "KUBEDL_SLICE_ID"
ENV_CONTROL_DIR = "KUBEDL_CONTROL_DIR"
ENV_LIVE_RESHARD = "KUBEDL_LIVE_RESHARD"
ENV_RESHARD_DIR = "KUBEDL_RESHARD_DIR"


class MultiProcessNotPorted(RuntimeError):
    """A gang of more than one process: not ported yet."""


@dataclass
class ProcessInfo:
    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    num_slices: int = 1
    slice_id: int = 0
    control_dir: str = ""
    live_reshard: bool = False
    reshard_dir: str = ""

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def process_info() -> ProcessInfo:
    return ProcessInfo(
        coordinator_address=os.environ.get(ENV_COORDINATOR_ADDRESS),
        num_processes=int(os.environ.get(ENV_NUM_PROCESSES, "1")),
        process_id=int(os.environ.get(ENV_PROCESS_ID, "0")),
        num_slices=int(os.environ.get(ENV_NUM_SLICES, "1")),
        slice_id=int(os.environ.get(ENV_SLICE_ID, "0")),
        control_dir=os.environ.get(ENV_CONTROL_DIR, ""),
        live_reshard=os.environ.get(ENV_LIVE_RESHARD, "") == "1",
        reshard_dir=os.environ.get(ENV_RESHARD_DIR, ""),
    )


def initialize(info: Optional[ProcessInfo] = None) -> ProcessInfo:
    """The info of this process; raises MultiProcessNotPorted when the
    gang has more than one process."""
    info = info or process_info()
    if info.is_distributed:
        raise MultiProcessNotPorted(
            f"{ENV_NUM_PROCESSES}={info.num_processes}: multi-process "
            f"training (the torch.distributed rendezvous) is not ported to "
            f"kubedl_tpu_torch yet (ROADMAP.md, Queue 1); run one process")
    return info
