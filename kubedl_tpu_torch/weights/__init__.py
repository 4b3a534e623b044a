"""One weight-distribution plane (the port's copy of kubedl_tpu/weights/).

`tree.py` computes the deterministic fan-out-f broadcast tree over a
gang's pod list; `dist.py` moves a version's serialized state through
that tree as sha-checked chunks with pipelined relay and
reparent-to-root repair; `metrics.py` is the process-wide counter
singleton (`kubedl_weights_*` + `kubedl_model_version`).
"""
from kubedl_tpu_torch.weights.tree import ROOT, TreeSpec, build_tree
from kubedl_tpu_torch.weights.dist import (
    WEIGHTS_CHANNEL,
    WEIGHTS_CONTROL_CHANNEL,
    RelayNode,
    RootDistributor,
    WeightsError,
)
from kubedl_tpu_torch.weights.metrics import weights_metrics

__all__ = [
    "ROOT", "TreeSpec", "build_tree",
    "WEIGHTS_CHANNEL", "WEIGHTS_CONTROL_CHANNEL",
    "RelayNode", "RootDistributor", "WeightsError",
    "weights_metrics",
]
