"""Device selection: the port's entry points run on the card unless the
caller asks for the CPU, and asking for a card that is not there raises.
A process of a training gang drives one device (`process_device`)."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """``torch.device`` for `device` (default ``cuda``). Raises when a CUDA
    device is requested and none is available; never picks the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} (cuda, cpu)")
    return dev


def process_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The one device a process of the gang trains on: ``cuda`` means
    ``cuda:0`` of the devices the pod sees (``--device cuda:N`` picks
    another), made the current device so NCCL binds to it; ``cpu`` stays
    the CPU. Like `resolve_device`, it never falls back to the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    return dev
