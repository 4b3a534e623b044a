"""The actor/learner RL plane (the port's copy of kubedl_tpu/rl/).

Runs RL post-training as a DISAGGREGATED fleet instead of the monolithic
rollout->update loop (train/grpo.py): actors generate groups of
completions and emit them -- with the behavior log-probs that are free at
sample time -- as exactly-once trajectories; a learner folds them into
the GRPO update and broadcasts version-stamped weights back:

  * wire.py        -- named-array record codec (per-array dtype recorded,
                      raw bytes; each package decodes the other's records)
  * trajectory.py  -- Trajectory + producer/consumer over any channel
  * weights.py     -- versioned weight broadcast + receiver
  * actor.py       -- ActorRuntime: batched rollouts, reward scoring,
                      weight pulls at generation boundaries
  * learner.py     -- LearnerRuntime: staleness-bounded GRPO updates,
                      weight publishing, checkpointing hooks
  * fleet.py       -- in-process harness (threads + QueueChannels)
  * metrics.py     -- kubedl_rl_* counters (a module singleton)

The pod entry point is train/rl_pod.py.
"""
from kubedl_tpu_torch.rl.metrics import rl_metrics
from kubedl_tpu_torch.rl.trajectory import (
    TRAJECTORY_CHANNEL,
    Trajectory,
    TrajectoryConsumer,
    TrajectoryProducer,
    decode_trajectory,
    encode_trajectory,
)
from kubedl_tpu_torch.rl.weights import (
    WEIGHT_CHANNEL,
    WeightBroadcaster,
    WeightReceiver,
    decode_weights,
    encode_weights,
)

__all__ = [
    "TRAJECTORY_CHANNEL",
    "WEIGHT_CHANNEL",
    "Trajectory",
    "TrajectoryConsumer",
    "TrajectoryProducer",
    "WeightBroadcaster",
    "WeightReceiver",
    "decode_trajectory",
    "decode_weights",
    "encode_trajectory",
    "encode_weights",
    "rl_metrics",
]
