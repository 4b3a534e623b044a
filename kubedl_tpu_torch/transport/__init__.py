"""The authenticated socket transport plane (the port's copy of
kubedl_tpu/transport/: `plane.py` and `metrics.py`).

One message plane for what rides between pods: the RL fleet's
trajectories and weight versions (train/rl_pod.py) and the serving
plane's KV handoffs (serving/router.py). Stdlib sockets, token
authenticated, length-prefix framed, the same bytes on the wire as the
JAX package's plane; `DirChannel` stays the local-executor transport,
selected via ``KUBEDL_TRANSPORT``. The RESIZE control router and the
staged reshard fetch (`control.py`, `blocks.py`) are not ported yet
(ROADMAP.md).
"""
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
    "TransportError",
    "TransportPlane",
    "plane_from_env",
    "transport_metrics",
]
