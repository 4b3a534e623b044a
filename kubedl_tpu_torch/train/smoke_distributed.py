"""Multi-host rendezvous smoke program (the port of
kubedl_tpu/train/smoke_distributed.py): proves the coordinator wiring.

Run as the container command of an N-replica job: every process joins the
gang's process group from the operator's env (train/coordinator.py),
checks that the global device count is its local count times the
processes (one device a process, as train/launch.py places them), and runs
one all-reduce of ones over every rank. Exit 0 only if the collective saw
every device. The group is nccl on a card and gloo on the CPU; processes
sharing one card need --backend gloo.

Usage:
    python -m kubedl_tpu_torch.train.smoke_distributed [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="the gang's process group (default nccl on a card, gloo on the "
                        "CPU; gloo for processes sharing one card)")
    return p.parse_args(argv)


def count_error(n_global: int, n_local: int, num_processes: int) -> Optional[str]:
    """The reference's check: the global device count must be the local
    count times the processes. Returns its message, or None when it holds."""
    if n_global != n_local * num_processes:
        return f"global devices {n_global} != local {n_local} x {num_processes} processes"
    return None


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.train import coordinator
    from kubedl_tpu_torch.utils.device import process_device

    info = coordinator.process_info()
    device = process_device(args.device)  # current before NCCL binds to it
    coordinator.initialize(info, backend=args.backend or (
        "nccl" if device.type == "cuda" else "gloo"))
    grouped = dist.is_initialized()

    def all_sum(x: torch.Tensor) -> float:
        if grouped:
            dist.all_reduce(x)
        return float(x.item())

    try:
        n_local = 1  # one device a process
        # every rank's local count, summed over the gang
        n_global = int(all_sum(torch.tensor([float(n_local)], device=device)))
        err = count_error(n_global, n_local, info.num_processes)
        if err:
            print(err, file=sys.stderr)
            return 1
        # one all-reduce spanning every device of every process
        total = all_sum(torch.ones(n_local, device=device).sum(0, keepdim=True))
        if int(total) != n_global:
            print(f"psum saw {total}, expected {n_global}", file=sys.stderr)
            return 1
        print(f"distributed ok: process {info.process_id}/{info.num_processes} "
              f"devices {n_local} local / {n_global} global, psum={total}", flush=True)
        return 0
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
