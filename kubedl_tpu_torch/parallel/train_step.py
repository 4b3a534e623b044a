"""The training step (kubedl_tpu/parallel/train_step.py), on one device or
sharded over a DeviceMesh.

`make_train_step(loss_fn, tx, mesh, param_spec_tree, batch_spec, rules,
accum_steps, has_aux)` gives (init_state, train_step): the loss and its
gradients by autograd, then the optimizer (parallel/optim.py) applied leaf
by leaf in place. The JAX step is jitted over a mesh and donates the state;
this one runs eagerly and updates the state's tensors in place.

With `mesh=None` the step runs on the device the parameters lie on. With a
mesh, `init_state` lays the parameters out as DTensors by `param_spec_tree`
(parallel/mesh.py `shard_tree`), the optimizer's moments follow them, and
`loss_fn` (e.g. models/llama.py `loss_fn` with the same mesh) computes on
local shards: each leaf's gradient arrives reduced over the token axes
(and the context axis, whose ranks each hold a part) on the leaf's own
placements, so a replicated leaf's gradient is summed over them once, and
`grad_norm` sums each leaf's shards once. The batch is this rank's rows of
the global batch (`batch_spec` names the axes that shard it; a DTensor
batch gives its local rows), and with a context axis its sequence block
(parallel/mesh.py `seq_block`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from kubedl_tpu_torch.models.llama import tree_leaves
from kubedl_tpu_torch.parallel.mesh import ShardingRules, shard_tree
from kubedl_tpu_torch.parallel.optim import MultiSteps, global_norm


@dataclass
class TrainState:
    params: Any     # the model's tree of tensors (leaves require grad)
    opt_state: Any  # the optimizer's state dict
    step: int


def make_train_step(loss_fn: Callable, tx, mesh=None, param_spec_tree: Any = None,
                    batch_spec: Any = None, rules: Optional[ShardingRules] = None,
                    accum_steps: int = 1, has_aux: bool = False
                    ) -> Tuple[Callable, Callable]:
    """Returns (init_state, train_step).

    init_state(params) -> TrainState; the parameter leaves (DTensors on a
    mesh) are made leaves of autograd (requires_grad). train_step(state,
    batch) -> (state, {"loss", "grad_norm", **aux}), 0-d tensors on the
    device: grad_norm is the global norm of this micro-step's own
    gradients. loss_fn(params, batch) returns the loss, or (loss, aux dict)
    with has_aux. accum_steps > 1 wraps tx in MultiSteps: the parameters
    move on every accum_steps-th call, by the update of the mean gradient.
    `batch_spec` and `rules` are the JAX signature's: here the loss closes
    over the rules, and each rank is given its own rows.
    """
    if accum_steps > 1:
        tx = MultiSteps(tx, every_k=accum_steps)
    if mesh is not None and param_spec_tree is None:
        raise ValueError("a sharded step needs the param_spec_tree of its parameters")

    def init_state(params) -> TrainState:
        if mesh is not None:
            params = shard_tree(params, mesh, param_spec_tree)
        leaves = list(tree_leaves(params))
        for p in leaves:
            if p.is_floating_point():
                p.requires_grad_(True)
        return TrainState(params=params, opt_state=tx.init(leaves), step=0)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if mesh is not None and hasattr(batch, "to_local"):
            batch = batch.to_local()
        leaves = list(tree_leaves(state.params))
        with torch.enable_grad():
            out = loss_fn(state.params, batch)
            loss, aux = out if has_aux else (out, {})
            grads = torch.autograd.grad(loss, leaves)
        gnorm = global_norm(grads)
        tx.apply(leaves, list(grads), state.opt_state)
        del grads
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm, **aux}

    return init_state, train_step
