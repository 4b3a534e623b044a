"""The optimizer of the training step, on tensors (the optax calls of
kubedl_tpu/train/trainer.py:327-341 and parallel/train_step.py:62-63).

Each function computes what its optax namesake computes:

* `adamw`: ``optax.adamw(lr, weight_decay=...)`` -- b1 0.9, b2 0.999, eps
  1e-8 added to sqrt(v_hat), bias correction from the update count,
  decoupled decay on every leaf (norms and embedding included), moments
  kept in the parameter's dtype; the learning rate is a float or a
  schedule of the applied-update count;
* `adam`: ``optax.adam(lr)`` -- `adamw` without the decay;
* `sgd`: ``optax.sgd(lr)`` without momentum;
* `adagrad`: ``optax.adagrad(lr)`` -- the running sum of squared gradients
  (from 0.1), each gradient times rsqrt(sum + 1e-7), scaled by
  -learning_rate;
* `clip_by_global_norm`, `global_norm`;
* `linear_schedule`, `cosine_decay_schedule`, `warmup_cosine_decay_schedule`;
* `chain` and `MultiSteps` (the running mean of k micro-step gradients;
  the wrapped transform runs on that mean on every k-th call).

A transform here updates the parameters in place, leaf by leaf, so no
temporary is larger than one leaf: ``begin`` sees the whole gradient tree
once for its scalars (the global norm, the step size), ``leaf`` turns one
leaf's gradient into its update, ``end`` advances the counters. Leaves
are lists of tensors in one fixed order (models/llama.py ``tree_leaves``).
Scalars enter the arithmetic rounded to the leaf's dtype, as JAX's
weakly-typed constants do; the global norm is summed in f32.

Sharded leaves (DTensors, parallel/mesh.py) are updated through their
local shards, with moments and accumulators laid out as their parameter;
`global_norm` sums each leaf's local squares once over the mesh axes that
shard it, never over those that replicate it.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Union

import torch

Schedule = Callable[[int], float]
Leaves = List[torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, the trainer's values
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7  # optax.adagrad's defaults


def _as_dtype(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype` (a bf16 leaf multiplies by bf16(x))."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage), or x itself."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _sq(g: torch.Tensor) -> torch.Tensor:
    g = _local(g).float()
    return torch.sum(g * g)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (0-d f32 tensor). For
    DTensor leaves: the local sums of each set of sharding mesh dims are
    added up, then each is all-reduced over just those dims (one small
    all-reduce per mesh dim that shards anything)."""
    from torch.distributed.tensor import DTensor, Shard

    sharded = [g for g in leaves if isinstance(g, DTensor)]
    if not sharded:
        return torch.sqrt(sum(_sq(g) for g in leaves))
    mesh = sharded[0].device_mesh
    by_dims = {}
    for g in leaves:
        dims = ()
        if isinstance(g, DTensor):
            dims = tuple(i for i, p in enumerate(g.placements)
                         if isinstance(p, Shard) and mesh.size(i) > 1)
        by_dims[dims] = by_dims.get(dims, 0.0) + _sq(g)
    keys = sorted(by_dims)
    sums = torch.stack([torch.as_tensor(by_dims[k]) for k in keys])
    for i in sorted({i for k in keys for i in k}):
        mask = torch.tensor([i in k for k in keys], device=sums.device)
        part = torch.where(mask, sums, torch.zeros_like(sums))
        torch.distributed.all_reduce(part, group=mesh.get_group(i))
        sums = torch.where(mask, part, sums)
    return torch.sqrt(sums.sum())


# ---------------------------------------------------------------------------
# schedules (functions of the applied-update count)
# ---------------------------------------------------------------------------


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        c = min(max(count, 0), transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule: decay_steps must be > 0")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """Linear warmup from init_value to peak_value, then cosine decay to
    end_value at decay_steps (counted from 0, warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warmup(count) if count < warmup_steps else decay(count - warmup_steps)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


class Transform:
    """One stage of an update, applied leaf by leaf. State is a dict."""

    def init(self, leaves: Leaves) -> dict:
        return {}

    def begin(self, grads: Leaves, state: dict) -> dict:
        """Whole-tree scalars for this update (no leaf-sized temporaries)."""
        return {}

    def leaf(self, i: int, u: torch.Tensor, p: torch.Tensor, state: dict,
             ctx: dict) -> torch.Tensor:
        raise NotImplementedError

    def end(self, state: dict, ctx: dict) -> None:
        pass

    def apply(self, params: Leaves, grads: Leaves, state: dict) -> None:
        """params[i] += update of grads[i], in place, one leaf at a time."""
        with torch.no_grad():
            ctx = self.begin(grads, state)
            for i, (p, g) in enumerate(zip(params, grads)):
                p = _local(p)
                p.add_(self.leaf(i, _local(g), p, state, ctx))
            self.end(state, ctx)


class clip_by_global_norm(Transform):
    """Scale every leaf by max_norm / global_norm when the norm is at or
    above max_norm."""

    def __init__(self, max_norm: float):
        self.max_norm = float(max_norm)

    def begin(self, grads, state):
        norm = float(global_norm(grads))
        return {"clip": not norm < self.max_norm, "norm": norm}

    def leaf(self, i, u, p, state, ctx):
        if not ctx["clip"]:
            return u
        return (u / _as_dtype(ctx["norm"], u.dtype)) * _as_dtype(self.max_norm, u.dtype)


class adamw(Transform):
    """Adam with decoupled weight decay, scaled by -learning_rate."""

    def __init__(self, learning_rate: Union[float, Schedule], weight_decay: float):
        self.lr = learning_rate
        self.weight_decay = weight_decay

    def init(self, leaves):
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    def begin(self, grads, state):
        count = state["count"] + 1
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        # 1 - b ** count in f32, as the bias correction is computed in JAX
        f32 = torch.float32
        bc1 = 1.0 - float(torch.tensor(B1, dtype=f32) ** count)
        bc2 = 1.0 - float(torch.tensor(B2, dtype=f32) ** count)
        return {"count": count, "lr": lr, "bc1": bc1, "bc2": bc2}

    def leaf(self, i, u, p, state, ctx):
        dt = u.dtype
        mu, nu = _local(state["mu"][i]), _local(state["nu"][i])
        # in place, each product rounded to the leaf's dtype as optax's is
        mu.mul_(_as_dtype(B1, dt)).add_(u * _as_dtype(1 - B1, dt))
        nu.mul_(_as_dtype(B2, dt)).add_((u * u).mul_(_as_dtype(1 - B2, dt)))
        upd = mu / _as_dtype(ctx["bc1"], dt)
        den = (nu / _as_dtype(ctx["bc2"], dt)).sqrt_().add_(_as_dtype(EPS, dt))
        upd.div_(den)
        if self.weight_decay:
            upd.add_(p * _as_dtype(self.weight_decay, dt))
        return upd.mul_(_as_dtype(-ctx["lr"], dt))

    def end(self, state, ctx):
        state["count"] = ctx["count"]


class adam(adamw):
    """Adam, scaled by -learning_rate (optax.adam: no weight decay)."""

    def __init__(self, learning_rate: Union[float, Schedule]):
        super().__init__(learning_rate, weight_decay=0.0)


class sgd(Transform):
    """optax.sgd(lr) without momentum: the gradient scaled by
    -learning_rate (lr 0 leaves the parameters as they are, as the MPMD
    pipeline's parity runs want)."""

    def __init__(self, learning_rate: Union[float, Schedule]):
        self.lr = learning_rate

    def init(self, leaves):
        return {"count": 0}

    def begin(self, grads, state):
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        return {"count": state["count"] + 1, "lr": lr}

    def leaf(self, i, u, p, state, ctx):
        return u * _as_dtype(-ctx["lr"], u.dtype)

    def end(self, state, ctx):
        state["count"] = ctx["count"]


class adagrad(Transform):
    """Adagrad, scaled by -learning_rate (optax.adagrad: scale_by_rss,
    then the learning rate). The accumulator starts at 0.1 in the
    parameter's dtype, so it is never 0 (optax's guard for a zero sum
    never fires), and a zero gradient moves nothing."""

    def __init__(self, learning_rate: Union[float, Schedule]):
        self.lr = learning_rate

    def init(self, leaves):
        return {"count": 0,
                "sum_of_squares": [torch.full_like(p, ADAGRAD_INIT) for p in leaves]}

    def begin(self, grads, state):
        lr = self.lr(state["count"]) if callable(self.lr) else self.lr
        return {"count": state["count"] + 1, "lr": lr}

    def leaf(self, i, u, p, state, ctx):
        dt = u.dtype
        acc = _local(state["sum_of_squares"][i])
        acc.add_(u * u)
        return (torch.rsqrt(acc + _as_dtype(ADAGRAD_EPS, dt)) * u).mul_(
            _as_dtype(-ctx["lr"], dt))

    def end(self, state, ctx):
        state["count"] = ctx["count"]


class chain(Transform):
    """The transforms one after the other on each leaf."""

    def __init__(self, *transforms: Transform):
        self.transforms = transforms

    def init(self, leaves):
        return {"stages": [t.init(leaves) for t in self.transforms]}

    def begin(self, grads, state):
        # every stage sees the raw gradients here: a clip, the one stage that
        # reads them, comes first in every chain the trainer builds
        return {"stages": [t.begin(grads, s)
                           for t, s in zip(self.transforms, state["stages"])]}

    def leaf(self, i, u, p, state, ctx):
        for t, s, c in zip(self.transforms, state["stages"], ctx["stages"]):
            u = t.leaf(i, u, p, s, c)
        return u

    def end(self, state, ctx):
        for t, s, c in zip(self.transforms, state["stages"], ctx["stages"]):
            t.end(s, c)


class MultiSteps:
    """Accumulate the running mean of `every_k` micro-step gradients; on
    every k-th call apply `inner` to that mean (optax.MultiSteps with
    use_grad_mean). The inner transform's counts, and so its schedule,
    advance only on applied updates."""

    def __init__(self, inner: Transform, every_k: int):
        if every_k < 1:
            raise ValueError(f"MultiSteps: every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)

    def init(self, leaves):
        return {"mini_step": 0, "gradient_step": 0,
                "inner": self.inner.init(leaves),
                "acc": [torch.zeros_like(p) for p in leaves]}

    def apply(self, params: Leaves, grads: Leaves, state: dict) -> None:
        n = state["mini_step"]
        with torch.no_grad():
            for a, g in zip(state["acc"], grads):
                a = _local(a)
                a.copy_(a + (_local(g) - a) / (n + 1))
        if n == self.every_k - 1:
            self.inner.apply(params, state["acc"], state["inner"])
            for a in state["acc"]:
                _local(a).zero_()
            state["gradient_step"] += 1
        state["mini_step"] = (n + 1) % self.every_k
