"""The authenticated socket transport plane (the port's copy of
kubedl_tpu/transport/: `plane.py`, `metrics.py`, `control.py` and
`blocks.py`).

One message plane for what rides between pods: the RL fleet's
trajectories and weight versions (train/rl_pod.py), the serving plane's KV
handoffs (serving/router.py), RESIZE control messages (`control.py`: the
operator's router and the trainer's endpoint, train/reshard_runtime.py
`control_from_env`) and staged-reshard block fetches (`blocks.py`). Stdlib
sockets, token authenticated, length-prefix framed, the same bytes on the
wire as the JAX package's plane; `DirChannel` stays the local-executor
transport, selected via ``KUBEDL_TRANSPORT``.
"""
from kubedl_tpu_torch.transport.blocks import fetch_staging, serve_staging
from kubedl_tpu_torch.transport.control import SocketControlRouter, SocketReshardControl
from kubedl_tpu_torch.transport.metrics import transport_metrics
from kubedl_tpu_torch.transport.plane import (
    ENV_BIND,
    ENV_TOKEN,
    ENV_TRANSPORT,
    SocketChannel,
    TransportError,
    TransportPlane,
    plane_from_env,
)

__all__ = [
    "ENV_BIND",
    "ENV_TOKEN",
    "ENV_TRANSPORT",
    "SocketChannel",
    "SocketControlRouter",
    "SocketReshardControl",
    "TransportError",
    "TransportPlane",
    "fetch_staging",
    "plane_from_env",
    "serve_staging",
    "transport_metrics",
]
