"""In-process fleet harness -- actors and learner as threads over
QueueChannels (the port's copy of kubedl_tpu/rl/fleet.py).

The single-process lane of the RL plane: tests and chip_smoke.py drive
the REAL ActorRuntime/LearnerRuntime against in-memory channels, so the
trajectory/broadcast protocol, the staleness bound and the starvation
accounting run without pods. The pod-world difference is only the
transport (DirChannel) and the process boundary (train/rl_pod.py).
Past two actors the weights ride the broadcast tree (weights/dist.py);
hub-and-spoke stays the <= 2-actor path.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from kubedl_tpu_torch.parallel.pipeline_mpmd import QueueChannel
from kubedl_tpu_torch.rl.actor import ActorConfig, ActorRuntime
from kubedl_tpu_torch.rl.learner import LearnerConfig, LearnerRuntime, LearnerStats
from kubedl_tpu_torch.rl.trajectory import TrajectoryConsumer, TrajectoryProducer
from kubedl_tpu_torch.rl.weights import WeightBroadcaster, WeightReceiver


class RLFleet:
    """n actors + one learner in one process; run() drives the learner on
    the calling thread so its failures propagate naturally."""

    def __init__(
        self,
        base_params,
        config,
        prompts: List[List[int]],
        reward_fn: Callable[[list, list], float],
        actor_cfg: ActorConfig,
        learner_cfg: LearnerConfig,
        n_actors: int = 1,
        mesh=None,
        tracer=None,
        use_weight_tree: Optional[bool] = None,
        weight_fanout: Optional[int] = None,
        weight_chunk_bytes: Optional[int] = None,
    ) -> None:
        self.n_actors = n_actors
        self.actor_cfg = actor_cfg
        self.learner_cfg = learner_cfg
        # weight path: hub-and-spoke sends to every actor serially (the
        # <= 2-actor fast path and parity oracle); past that the
        # broadcast tree relays chunks in O(log n) hops. None = auto by
        # fleet size.
        self.use_weight_tree = (n_actors > 2 if use_weight_tree is None
                                else bool(use_weight_tree))
        traj_channels: Dict[str, QueueChannel] = {}
        weight_channels: List[QueueChannel] = []
        self.actors: List[ActorRuntime] = []
        weight_ch_by_actor: Dict[str, QueueChannel] = {}
        for i in range(n_actors):
            cfg_i = ActorConfig(
                **{**actor_cfg.__dict__, "actor_index": i,
                   "n_actors": n_actors})
            traj_ch = QueueChannel()
            weight_ch = QueueChannel()
            traj_channels[cfg_i.actor_id] = traj_ch
            weight_channels.append(weight_ch)
            weight_ch_by_actor[cfg_i.actor_id] = weight_ch
            self.actors.append(ActorRuntime(
                base_params, config, cfg_i, prompts, reward_fn,
                producer=TrajectoryProducer(
                    traj_ch, cfg_i.actor_id, job=cfg_i.job),
                receiver=WeightReceiver(weight_ch),
                tracer=tracer,
            ))
        self.relays: List = []
        self._relay_stop = threading.Event()
        self._relay_threads: List[threading.Thread] = []
        distributor = None
        if self.use_weight_tree:
            from kubedl_tpu_torch.weights.dist import RelayNode, RootDistributor

            dist_channels = {a: QueueChannel() for a in traj_channels}
            control = QueueChannel()

            def _deliver_into(ch: QueueChannel):
                # the relay hands the actor the ORIGINAL encoded record
                # under the hub-and-spoke tag — WeightReceiver and the
                # actor runtime are byte-identical on both paths
                def deliver(payload: bytes, version: int,
                            step: int) -> None:
                    ch.send(f"w.{version:08d}", payload)
                return deliver

            for a in traj_channels:
                self.relays.append(RelayNode(
                    pod=a, recv=dist_channels[a],
                    child_channel=dist_channels.__getitem__,
                    control=control,
                    on_deliver=_deliver_into(weight_ch_by_actor[a]),
                    job=learner_cfg.job, tracer=tracer))
            distributor = RootDistributor(
                list(traj_channels), dist_channels, control,
                job=learner_cfg.job, fanout=weight_fanout,
                chunk_bytes=weight_chunk_bytes, tracer=tracer)
        self.distributor = distributor
        self.learner = LearnerRuntime(
            base_params, config, learner_cfg,
            consumer=TrajectoryConsumer(traj_channels, job=learner_cfg.job),
            broadcaster=WeightBroadcaster(weight_channels,
                                          distributor=distributor),
            mesh=mesh, tracer=tracer,
        )

    def actor_steps_for(self, learner_steps: int) -> int:
        """Iterations per actor so the fleet produces exactly (at least)
        the groups `learner_steps` updates consume — assuming no stale
        drops, which the version-ordered adopt-newest pull guarantees
        for a healthy fleet."""
        total = learner_steps * self.learner_cfg.prompts_per_step
        per_actor = -(-total // self.n_actors)
        return -(-per_actor // self.actor_cfg.prompts_per_step)

    def run(self, learner_steps: int,
            on_step=None) -> LearnerStats:
        actor_steps = self.actor_steps_for(learner_steps)
        errors: List[BaseException] = []

        def _actor(a: ActorRuntime) -> None:
            try:
                a.run(actor_steps)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        def _relay(node) -> None:
            try:
                node.run(self._relay_stop)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
                self._relay_stop.set()

        threads = [
            threading.Thread(target=_actor, args=(a,), daemon=True,
                             name=f"rl-{a.cfg.actor_id}")
            for a in self.actors
        ]
        self._relay_threads = [
            threading.Thread(target=_relay, args=(node,), daemon=True,
                             name=f"rl-relay-{node.pod}")
            for node in self.relays
        ]
        for t in self._relay_threads:
            t.start()
        for t in threads:
            t.start()
        try:
            stats = self.learner.run(learner_steps, on_step=on_step)
        except BaseException as learner_err:
            # a crashed actor usually SURFACES as a learner starvation
            # timeout — report the root cause, not just the symptom
            self._relay_stop.set()
            for t in threads:
                t.join(timeout=1.0)
            if errors:
                raise RuntimeError(
                    f"actor/relay thread(s) failed: "
                    f"{[repr(e) for e in errors]}") from learner_err
            raise
        for t in threads:
            t.join(timeout=self.actor_cfg.weight_wait_s + 10.0)
        self._relay_stop.set()
        for t in self._relay_threads:
            t.join(timeout=5.0)
        if errors:
            raise RuntimeError(
                f"actor/relay thread(s) failed: "
                f"{[repr(e) for e in errors]}")
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            raise RuntimeError(f"actor thread(s) wedged: {alive}")
        return stats


def fleet_goodput_split(stats: LearnerStats,
                        actors: Optional[List[ActorRuntime]] = None) -> Dict:
    """The coupling-claim numbers in one dict: where the fleet's waiting
    time pooled (actor-starved vs learner-starved) next to the
    productive rollout/learn/sync seconds."""
    out = {
        "learn_s": round(stats.learn_s, 4),
        "weight_sync_s": round(stats.weight_sync_s, 4),
        "actor_starved_s": round(stats.actor_starved_s, 4),
        "stale_dropped": stats.stale_dropped,
        "max_weight_lag_observed": stats.max_lag_observed,
    }
    if actors:
        out["rollout_s"] = round(
            sum(a.rollout_s_total for a in actors), 4)
        out["rollout_tokens"] = sum(a.tokens_generated for a in actors)
        out["learner_starved_s"] = round(
            sum(a.learner_starved_s for a in actors), 4)
    return out
