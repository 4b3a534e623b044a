"""The training step on one device (kubedl_tpu/parallel/train_step.py).

`make_train_step(loss_fn, tx, accum_steps)` gives (init_state, train_step):
the loss and its gradients by autograd, then the optimizer (parallel/
optim.py) applied leaf by leaf in place. The JAX step is jitted over a
mesh and donates the state; this one runs eagerly on the device the
parameters lie on and updates the state's tensors in place. There is no
mesh: the trainer refuses a mesh of more than one device (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from kubedl_tpu_torch.models.llama import tree_leaves
from kubedl_tpu_torch.parallel.optim import MultiSteps, global_norm


@dataclass
class TrainState:
    params: Any     # the model's tree of tensors (leaves require grad)
    opt_state: Any  # the optimizer's state dict
    step: int


def make_train_step(loss_fn: Callable, tx, accum_steps: int = 1
                    ) -> Tuple[Callable, Callable]:
    """Returns (init_state, train_step).

    init_state(params) -> TrainState; the parameter leaves are made leaves
    of autograd (requires_grad). train_step(state, batch) -> (state,
    {"loss", "grad_norm"}), both 0-d tensors on the device: grad_norm is
    the global norm of this micro-step's own gradients. accum_steps > 1
    wraps tx in MultiSteps: the parameters move on every accum_steps-th
    call, by the update of the mean gradient."""
    if accum_steps > 1:
        tx = MultiSteps(tx, every_k=accum_steps)

    def init_state(params) -> TrainState:
        leaves = list(tree_leaves(params))
        for p in leaves:
            if p.is_floating_point():
                p.requires_grad_(True)
        return TrainState(params=params, opt_state=tx.init(leaves), step=0)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        leaves = list(tree_leaves(state.params))
        with torch.enable_grad():
            loss = loss_fn(state.params, batch)
            grads = torch.autograd.grad(loss, leaves)
        gnorm = global_norm(grads)
        tx.apply(leaves, list(grads), state.opt_state)
        del grads
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return init_state, train_step
