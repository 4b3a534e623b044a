"""Matrix products over parameter leaves (kubedl_tpu/models/quant.py).

Only the plain branch is ported: weight-only int8 leaves ({"q", "s"}
dicts) raise until that serving feature is ported (ROADMAP.md, "Serving
features deferred from slice 1").
"""
from __future__ import annotations

from typing import Any

import torch


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for a plain [in, out] weight."""
    if is_quantized(w):
        raise NotImplementedError(
            "int8 weight leaves are not ported yet (ROADMAP.md: serving "
            "features deferred from slice 1, weight-only int8)")
    return x @ w
