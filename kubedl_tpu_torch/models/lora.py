"""LoRA: low-rank adapters for parameter-efficient fine-tuning
(kubedl_tpu/models/lora.py).

Hu et al., 2021: the base weights stay frozen and each targeted projection
trains a delta W' = W + (alpha/r) * A @ B, A [in, r] fan-in noise and
B [r, out] zeros, so step 0 is exactly the base model.

`merge` is a plain map over the parameter tree that gives ordinary Llama
params, so the same train step, decode and serving engine run an adapted
model. In training the merge runs inside the loss (`make_lora_step`): the
base rides in the batch and never requires grad, gradients reach only the
adapters, and the optimizer state covers only them. The serving engine
also takes adapters per request without merging (models/serving.py
`register_adapter`, models/llama.py `_proj`).

On a mesh the base is sharded by `llama.param_specs` and the adapters are
replicated DTensors (they are small). `merge` gives each merged leaf the
base leaf's placements: a rank adds its rows of A times its columns of B
to its shard, with no communication, so the model's local views of the
merged tree are those of the base. In backward each rank's share of an
adapter's gradient is summed over the mesh dims that shard the leaf (the
token axes are already summed by the local views), so the replicated
adapters get the whole gradient on every rank.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from kubedl_tpu_torch.models import llama

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def lora_init(generator: Optional[torch.Generator], params: Dict, rank: int = 8,
              targets: Tuple[str, ...] = DEFAULT_TARGETS,
              dtype=torch.float32) -> Dict:
    """Adapter tree mirroring params' layers: per targeted projection,
    {"a": [in, r] (fan-in noise), "b": [r, out] (zeros)}, on the device of
    the projection. `generator` draws A (it must live on that device);
    None seeds one with 0. Layers without a target (MoE layers carry no
    dense w1/w3/w2) are skipped."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    adapters = {"layers": []}
    for layer in params["layers"]:
        entry = {}
        for name in targets:
            w = layer.get(name)
            if w is None:  # e.g. MoE layers carry no dense w1/w3/w2
                continue
            if generator is None:
                generator = torch.Generator(device=w.device).manual_seed(0)
            fan_in = w.shape[0]
            a = torch.randn((fan_in, rank), generator=generator, dtype=torch.float32,
                            device=w.device) / math.sqrt(fan_in)
            entry[name] = {"a": a.to(dtype),
                           "b": torch.zeros((rank, w.shape[1]), dtype=dtype, device=w.device)}
        adapters["layers"].append(entry)
    if not any(adapters["layers"]):
        # a typo'd target list would otherwise train zero parameters
        raise ValueError(f"no adapter targets matched any layer: targets={targets!r}")
    return adapters


def _sharded_merge(w, a, b, scale: float):
    """The merged leaf of a DTensor base leaf `w`, computed on local tensors
    (DTensor ops would go through sharding propagation over every mesh
    dim): this rank's rows of A times its columns of B, added to w's local
    shard, wrapped with w's placements. A and B (replicated DTensors, or
    plain tensors when nothing trains them) enter with their gradient
    marked partial over the mesh dims that shard w, so each rank's share of
    the adapter gradient is summed over them in backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = w.device_mesh, tuple(w.placements)
    (rows, cols), (r0, c0) = compute_local_shape_and_global_offset(w.shape, mesh, pl)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]

    def local(x):
        if not isinstance(x, DTensor):
            return x
        # redistribute to the same placements: its backward reduces the
        # partial gradient onto the leaf's replicated placements
        return x.redistribute(mesh, x.placements).to_local(grad_placements=grad)

    delta = local(a)[r0:r0 + rows].float() @ local(b)[:, c0:c0 + cols].float()
    merged = (w.to_local().float() + scale * delta).to(w.dtype)
    return DTensor.from_local(merged, mesh, pl, run_check=False, shape=w.shape,
                              stride=w.stride())


def merge(params: Dict, adapters: Dict, alpha: Optional[float] = None) -> Dict:
    """Base + (alpha/r) * A @ B -> ordinary Llama params (a new tree; the
    base is untouched). The sum is taken in f32 and cast to the base
    leaf's dtype; alpha defaults to the rank (scale 1.0). A DTensor base
    leaf gives a DTensor merged leaf with its placements."""
    from torch.distributed.tensor import DTensor

    if len(params["layers"]) != len(adapters["layers"]):
        raise ValueError(
            f"adapter/base layer-count mismatch: {len(adapters['layers'])} "
            f"adapter layers vs {len(params['layers'])} model layers — "
            f"wrong checkpoint/config pairing")
    merged_layers = []
    for layer, entry in zip(params["layers"], adapters["layers"]):
        new_layer = dict(layer)
        for name, ab in entry.items():
            r = ab["a"].shape[1]
            scale = (alpha if alpha is not None else float(r)) / float(r)
            w = layer[name]
            if isinstance(w, DTensor):
                new_layer[name] = _sharded_merge(w, ab["a"], ab["b"], scale)
                continue
            delta = ab["a"].float() @ ab["b"].float()
            new_layer[name] = (w.float() + scale * delta).to(w.dtype)
        merged_layers.append(new_layer)
    out = dict(params)
    out["layers"] = merged_layers
    return out


def adapter_count(adapters: Dict) -> int:
    return llama.param_count(adapters)


def restore_and_merge(base_params: Dict, checkpoint_path: str,
                      alpha: Optional[float] = None) -> Dict:
    """Merge the newest adapter checkpoint under `checkpoint_path` (a
    trainer --lora-rank run's directory) into the base weights, on the
    base's device: the consumer side of adapter-only checkpoints for
    generate and serve."""
    from kubedl_tpu_torch.train.generate import restore_params

    adapters = restore_params(checkpoint_path, label="lora adapters",
                              device=base_params["embed"].device)
    if adapters is None:
        raise ValueError(f"no adapter checkpoint under {checkpoint_path!r}")
    return merge(base_params, adapters, alpha=alpha)


def make_lora_step(base_params: Dict, config: llama.LlamaConfig, tx, mesh=None, rules=None,
                   rank: int = 8, alpha: Optional[float] = None,
                   targets: Tuple[str, ...] = DEFAULT_TARGETS,
                   generator: Optional[torch.Generator] = None, accum_steps: int = 1):
    """(adapters0, init_state, lora_step): the pretraining LM loss with
    gradients reaching only the adapters, and an adapter-sized optimizer
    state (parallel/train_step.py `make_train_step`). lora_step(state,
    tokens) is the plain train step's call. On a mesh the base is sharded
    by `llama.param_specs` and the adapters are replicated; `tokens` are
    this rank's rows."""
    from kubedl_tpu_torch.parallel.mesh import P, ShardingRules, shard_tree
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    rules = rules or ShardingRules()
    adapters0 = lora_init(generator, base_params, rank=rank, targets=targets)
    base = llama.tree_map(lambda t: t.detach(), base_params)
    adapter_specs = None
    if mesh is not None:
        base = shard_tree(base, mesh, llama.param_specs(config, rules))
        # adapters replicate: small tensors, gathered nowhere
        adapter_specs = llama.tree_map(lambda _: P(), adapters0)

    def loss_fn(adapters, batch):
        tokens, base = batch
        merged = merge(base, adapters, alpha=alpha)
        return llama.loss_fn(merged, tokens, config, mesh=mesh, rules=rules)

    init_state, step = make_train_step(loss_fn, tx, mesh, adapter_specs,
                                       rules.spec("batch", None), rules,
                                       accum_steps=accum_steps)

    def lora_step(state, tokens):
        return step(state, (tokens, base))

    return adapters0, init_state, lora_step
