"""The rendezvous from the operator-injected env (the port of
kubedl_tpu/train/coordinator.py).

The operator injects KUBEDL_COORDINATOR_ADDRESS / KUBEDL_NUM_PROCESSES /
KUBEDL_PROCESS_ID (workloads/common.py), and the multislice and
live-reshard names below. `initialize()` joins the gang's
torch.distributed process group over ``tcp://`` at the injected address:
nccl when the process trains on a card, gloo on the CPU. Process 0 hosts
the store at that address, as it hosts JAX's coordination service. A
process without an address stays ungrouped, as in the JAX package; a
single process with an address joins a group of one, because the port's
sharded step runs only in a group (JAX builds its mesh without one).
"""
from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("kubedl_tpu_torch.coordinator")

ENV_COORDINATOR_ADDRESS = "KUBEDL_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KUBEDL_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBEDL_PROCESS_ID"
ENV_NUM_SLICES = "KUBEDL_NUM_SLICES"
ENV_SLICE_ID = "KUBEDL_SLICE_ID"
ENV_CONTROL_DIR = "KUBEDL_CONTROL_DIR"
ENV_LIVE_RESHARD = "KUBEDL_LIVE_RESHARD"
ENV_RESHARD_DIR = "KUBEDL_RESHARD_DIR"
DEFAULT_PORT = "8471"  # workloads/common.py COORDINATOR_PORT


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

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1


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


def _resolve_local(address: str) -> str:
    """Map a service-DNS coordinator address to loopback when the headless
    DNS name does not resolve (local executor: every process of the gang
    shares one host, so the store is on 127.0.0.1)."""
    host, _, port = address.partition(":")
    try:
        socket.getaddrinfo(host, None)
        return address
    except socket.gaierror:
        return f"127.0.0.1:{port or DEFAULT_PORT}"


def initialize(info: Optional[ProcessInfo] = None, backend: str = "gloo") -> ProcessInfo:
    """Join the gang's process group (idempotent). `backend` is "nccl"
    for a process on a card (its device must be current already) and
    "gloo" on the CPU. Without KUBEDL_COORDINATOR_ADDRESS nothing is
    initialized."""
    import torch.distributed as dist

    info = info or process_info()
    if info.coordinator_address is None or dist.is_initialized():
        return info
    addr = _resolve_local(info.coordinator_address)
    if ":" not in addr:
        addr = f"{addr}:{DEFAULT_PORT}"
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=info.num_processes,
        rank=info.process_id)
    log.info("torch.distributed initialized: %d/%d via %s (%s)",
             info.process_id, info.num_processes, addr, backend)
    return info
