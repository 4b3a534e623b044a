"""Carry parameters and configurations across from the JAX package.

The port keeps the JAX package's parameter tree (leaf names, nesting and
the ``[in, out]`` weight layout), so carrying weights across is a copy:
the caller turns the JAX tree into numpy arrays (``jax.device_get``) and
`params_from_numpy` turns those into tensors leaf for leaf. bfloat16 leaves
arrive as ``ml_dtypes.bfloat16`` numpy arrays; they cross as their raw
16-bit patterns, so no value is rounded.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from kubedl_tpu_torch.models.llama import LlamaConfig, RopeScaling

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def torch_dtype(dtype: Any) -> torch.dtype:
    """numpy / ml_dtypes / JAX dtype (or its name) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[np.dtype(dtype).name]
    except (KeyError, TypeError) as e:
        raise ValueError(f"no torch dtype for {dtype!r}") from e


def tensor_from_numpy(a: np.ndarray, device="cpu",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy array -> tensor, bit-exact (bfloat16 through its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device=device, dtype=dtype or t.dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; bfloat16 comes back as ml_dtypes.bfloat16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Map a nested dict/list tree of numpy arrays to tensors, leaf for
    leaf. `dtype` casts floating-point leaves (None keeps each leaf's)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    leaf = tensor_from_numpy(tree, device)
    if dtype is not None and leaf.is_floating_point():
        leaf = leaf.to(dtype)
    return leaf


def params_to_numpy(tree):
    """Inverse of `params_from_numpy`."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tensor_to_numpy(tree)


def config_from_fields(**fields) -> LlamaConfig:
    """The port's LlamaConfig from the JAX config's fields
    (``dataclasses.asdict``-style): ``dtype`` maps to a torch dtype and
    ``rope_scaling`` (a dict or any object with the same fields) to the
    port's RopeScaling."""
    fields = dict(fields)
    if "dtype" in fields:
        fields["dtype"] = torch_dtype(fields["dtype"])
    rs = fields.get("rope_scaling")
    if rs is not None and not isinstance(rs, RopeScaling):
        if not isinstance(rs, dict):
            rs = {f: getattr(rs, f) for f in RopeScaling.__dataclass_fields__}
        fields["rope_scaling"] = RopeScaling(**rs)
    if fields.get("layer_windows") is not None:
        fields["layer_windows"] = tuple(fields["layer_windows"])
    return LlamaConfig(**fields)
