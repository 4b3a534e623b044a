"""Learner runtime -- staleness-bounded GRPO updates over the trajectory
queue, versioned weight broadcast back to the actors (the port's copy of
kubedl_tpu/rl/learner.py).

The learner is the ONLY writer of policy versions: version v is the
parameter tree after v update steps (broadcast every
``broadcast_interval`` steps). Arriving trajectories carry the version
they sampled from; one staler than ``max_weight_lag`` versions is DROPPED
and counted -- the off-policy bound is enforced here, at the single
consumption point, so "weight lag never exceeds maxWeightLag" is a
property of the update stream, not a hope about actor behavior.

The update is the GRPO step (train/rl.py `make_grpo_step`, AdamW after
`clip_by_global_norm` from parallel/optim.py, as the trainer builds it)
over whole groups: B trajectories = B prompts x G completions a step, the
monolithic train/grpo.py batch shape, which makes the fleet's loss
directly comparable to the monolith on a fixed seed. A batch's groups are
ordered by (actor, seq), not by arrival, so the update is the same
whichever actor's group came first. Behavior logprobs
come FROM the trajectories (sampling-time capture);
``use_behavior_logprobs=False`` falls back to the strictly-on-policy
detached form.

Waiting on an empty queue is actor-starved time (rl.idle span,
cause=actor_starved): a fleet whose wall time pools there needs more or
faster actors; one pooling in the actors' learner_starved spans needs a
faster learner.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

import torch

from kubedl_tpu_torch.models.llama import tree_leaves
from kubedl_tpu_torch.rl.metrics import rl_metrics
from kubedl_tpu_torch.rl.trajectory import TrajectoryConsumer
from kubedl_tpu_torch.rl.weights import WeightBroadcaster


@dataclass
class LearnerConfig:
    prompts_per_step: int = 4      # trajectory groups per update
    group_size: int = 8
    max_weight_lag: int = 1
    broadcast_interval: int = 1    # publish every N steps
    lr: float = 1e-6
    clip_eps: float = 0.2
    kl_coef: float = 0.04
    grad_clip: float = 1.0
    use_behavior_logprobs: bool = True
    take_timeout_s: float = 120.0  # starvation budget before failing loud
    job: str = "rl"


@dataclass
class LearnerStats:
    steps: int = 0
    consumed: int = 0
    stale_dropped: int = 0
    max_lag_observed: int = 0
    actor_starved_s: float = 0.0
    weight_sync_s: float = 0.0
    learn_s: float = 0.0
    last_loss: float = float("nan")
    last_metrics: Dict = field(default_factory=dict)


class LearnerRuntime:
    """The update half of the fleet; see module docstring."""

    def __init__(
        self,
        base_params,
        config,
        cfg: LearnerConfig,
        consumer: TrajectoryConsumer,
        broadcaster: Optional[WeightBroadcaster] = None,
        mesh=None,
        tracer=None,
    ) -> None:
        from kubedl_tpu_torch.parallel import optim
        from kubedl_tpu_torch.train.rl import make_grpo_step

        self.config = config
        self.cfg = cfg
        self.consumer = consumer
        self.broadcaster = broadcaster
        self.tracer = tracer
        self.stats = LearnerStats()
        self.mesh = mesh  # a mesh is refused by make_grpo_step (ROADMAP.md)
        tx = optim.adamw(cfg.lr, weight_decay=0.0)
        if cfg.grad_clip > 0:
            tx = optim.chain(optim.clip_by_global_norm(cfg.grad_clip), tx)
        init_state, self._lp_fn, self._ref_fn, self._step = make_grpo_step(
            base_params, config, tx, mesh, clip_eps=cfg.clip_eps,
            kl_coef=cfg.kl_coef, use_old_logprobs=cfg.use_behavior_logprobs,
        )
        # trains the tree it is given, in place (make_train_step)
        self.state = init_state(base_params)
        self.device = next(tree_leaves(self.state.params)).device

    @property
    def version(self) -> int:
        return self.broadcaster.version if self.broadcaster else 0

    def _trace(self, name: str, dur: float, **attrs) -> None:
        if self.tracer is not None:
            try:
                self.tracer.record(name, duration_s=dur, **attrs)
            except Exception:  # noqa: BLE001 — tracing never blocks updates
                pass

    # -- consumption -----------------------------------------------------

    def _collect_batch(self):
        """Blocking: the next B fresh (lag-bounded) trajectory groups.
        Every drop and every starved wait is counted and traced."""
        groups = []
        deadline = time.monotonic() + self.cfg.take_timeout_s
        while len(groups) < self.cfg.prompts_per_step:
            t0 = time.perf_counter()
            traj = self.consumer.take(timeout=1.0)
            waited = time.perf_counter() - t0
            # ANY genuine blocking inside take() is actor-starved time —
            # a take that waits 0.9s and then returns a trajectory idled
            # the learner just as much as one that timed out (a
            # timeout-only count would under-report exactly the fleets
            # whose actors are slow-but-not-dead)
            if waited > 0.01:
                self.stats.actor_starved_s += waited
                self._trace("rl.idle", waited, cause="actor_starved",
                            side="learner", have=len(groups))
            if traj is None:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"learner starved: {len(groups)}/"
                        f"{self.cfg.prompts_per_step} trajectory groups "
                        f"after {self.cfg.take_timeout_s:.0f}s")
                continue
            lag = self.version - traj.weight_version
            if lag > self.cfg.max_weight_lag:
                self.stats.stale_dropped += 1
                rl_metrics.on_stale_dropped(self.cfg.job, weight_lag=lag)
                continue
            self.stats.consumed += 1
            self.stats.max_lag_observed = max(
                self.stats.max_lag_observed, lag)
            rl_metrics.on_consumed(self.cfg.job, weight_lag=lag)
            groups.append(traj)
        return groups

    # -- update ----------------------------------------------------------

    def train_step(self, groups) -> Dict:
        """One GRPO update over B trajectory groups (B*G sequences)."""
        from kubedl_tpu_torch.train.rl import group_advantages

        # one order for the batch's rows whichever actor's group arrived
        # first, so an update does not depend on the threads' timing
        groups = sorted(groups, key=lambda t: (t.actor, t.seq))
        B, G = len(groups), self.cfg.group_size
        widths = {t.tokens.shape[1] for t in groups}
        if len(widths) != 1:
            raise ValueError(
                f"trajectory groups disagree on padded width: "
                f"{sorted(widths)} — actors must share one prompt set")
        for t in groups:
            if t.tokens.shape[0] != G:
                raise ValueError(
                    f"trajectory group of {t.tokens.shape[0]} != "
                    f"configured group size {G}")

        def on_device(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        tokens = np.concatenate([t.tokens for t in groups])      # [B*G, T]
        prompt_lens = np.repeat(
            np.array([t.prompt_len for t in groups], np.int32), G)
        seq_lens = np.concatenate([t.seq_lens for t in groups])
        rewards = np.stack([t.rewards for t in groups])          # [B, G]
        adv = group_advantages(rewards).reshape(B * G).to(self.device)
        lp_batch = (on_device(tokens), on_device(prompt_lens), on_device(seq_lens))
        t0 = time.perf_counter()
        ref_lp = self._ref_fn(lp_batch)
        if self.cfg.use_behavior_logprobs:
            old_lp = on_device(
                np.concatenate([t.behavior_logprobs for t in groups]))
            batch = (*lp_batch, adv, old_lp, ref_lp)
        else:
            batch = (*lp_batch, adv, ref_lp)
        self.state, metrics = self._step(self.state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        learn_s = time.perf_counter() - t0
        self.stats.steps += 1
        self.stats.learn_s += learn_s
        self.stats.last_loss = metrics["loss"]
        self.stats.last_metrics = dict(metrics, reward=float(rewards.mean()))
        rl_metrics.observe_learn(self.cfg.job, learn_s, metrics["loss"])
        self._trace("rl.learn", learn_s, groups=B,
                    loss=metrics["loss"], reward=float(rewards.mean()))
        return metrics

    def _maybe_broadcast(self, step: int) -> None:
        if self.broadcaster is None:
            return
        if step % max(self.cfg.broadcast_interval, 1):
            return
        t0 = time.perf_counter()
        version, _ = self.broadcaster.publish(self.state.params, step)
        sync_s = time.perf_counter() - t0
        self.stats.weight_sync_s += sync_s
        rl_metrics.on_weights_published(self.cfg.job, version)
        self._trace("rl.weight_sync", sync_s, side="learner",
                    version=version, step=step)

    def run(self, steps: int, start: int = 1,
            on_step=None) -> LearnerStats:
        """`steps` update steps (blocking on the queue); `on_step(step,
        metrics)` is the checkpoint/log hook of the pod entrypoint."""
        for step in range(start, start + steps):
            groups = self._collect_batch()
            metrics = self.train_step(groups)
            self._maybe_broadcast(step)
            if on_step is not None:
                on_step(step, metrics)
        return self.stats
