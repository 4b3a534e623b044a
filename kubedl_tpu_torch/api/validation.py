"""The shape rules the port's programs share (the port's copies of
`validate_pipeline_shapes`, `PIPELINE_SCHEDULES`, `validate_rl_shapes`,
`RL_REWARDS` and `RL_ROLLOUT_ENGINES` of kubedl_tpu/api/validation.py,
with the same error strings). The rest of that module validates job
manifests for the operator, which is not part of the port.
"""
from __future__ import annotations

from typing import List

PIPELINE_SCHEDULES = ("gpipe", "1f1b")


def validate_pipeline_shapes(
    n_stages: int,
    n_microbatches: int,
    interleave: int = 1,
    n_layers: int = None,
    schedule: str = None,
    path: str = "spec.pipeline",
) -> List[str]:
    """Pipeline shape sanity -- the ONE rule set the schedules
    (parallel/pipeline.py), the stage plan (parallel/pipeline_mpmd.py) and
    both trainers share, as JAXJob submit validation applies it: a shape
    the trainer would reject minutes into a job is already rejected at
    apply time. Pure arithmetic. `n_layers=None` skips the divisibility
    rule (unknown at submit unless declared); `schedule=None` skips the
    schedule-name/interleave pairing rules (callers that already resolved
    a schedule pass it, so a schedule added in one place cannot drift past
    the other). Every message is the reference's."""
    errs: List[str] = []
    if schedule is not None:
        if schedule not in PIPELINE_SCHEDULES:
            errs.append(
                f"{path}.schedule: unknown {schedule!r} "
                f"({', '.join(PIPELINE_SCHEDULES)})")
        elif interleave > 1 and schedule != "1f1b":
            errs.append(
                f"{path}.interleave > 1 requires schedule '1f1b' "
                f"(GPipe has no virtual stages)")
    if n_stages < 1:
        errs.append(f"{path}.stages: must be >= 1, got {n_stages}")
    if interleave < 1:
        errs.append(f"{path}.interleave: must be >= 1, got {interleave}")
    if n_stages >= 1 and n_microbatches < n_stages:
        # fewer microbatches than stages can never fill the pipeline —
        # the schedule would deadlock on (or garbage-feed) empty slots
        errs.append(
            f"{path}.microbatches: need >= stages ({n_stages}) to fill "
            f"the pipeline, got {n_microbatches}")
    if (n_layers is not None and n_stages >= 1 and interleave >= 1
            and n_layers % (n_stages * interleave)):
        errs.append(
            f"{path}: layer count {n_layers} not divisible by stages x "
            f"interleave = {n_stages} x {interleave} (every rank must "
            f"hold {interleave} equal layer chunks)")
    return errs


RL_REWARDS = ("token-match", "length")
RL_ROLLOUT_ENGINES = ("decode", "serving")


def validate_rl_shapes(
    actor_replicas: int,
    learner_replicas: int,
    group_size: int,
    max_weight_lag: int,
    prompts_per_step: int = 1,
    max_new_tokens: int = 1,
    temperature: float = 1.0,
    broadcast_interval: int = 1,
    reward: str = "token-match",
    eos_id: int = -1,
    rollout_engine: str = "decode",
    path: str = "spec.rl",
) -> List[str]:
    """RL-fleet shape sanity, the rule set of JAXJob submit validation,
    which train/rl_pod.py applies again to the injected env: a fleet the
    learner would reject minutes in is rejected before it starts. Pure
    arithmetic; every message is the reference's."""
    errs: List[str] = []
    if actor_replicas < 1:
        errs.append(f"{path}.actorReplicas: must be >= 1, got "
                    f"{actor_replicas}")
    if learner_replicas != 1:
        # the sharded GRPO step is ONE program; a learner data-parallel
        # group would need cross-learner gradient sync the plane does
        # not carry yet — refuse rather than silently train n diverging
        # policies
        errs.append(f"{path}.learnerReplicas: must be exactly 1, got "
                    f"{learner_replicas}")
    if group_size < 2:
        errs.append(f"{path}.groupSize: must be >= 2 (the group mean is "
                    f"the GRPO baseline; one sample always has advantage "
                    f"0), got {group_size}")
    if max_weight_lag < 0:
        errs.append(f"{path}.maxWeightLag: must be >= 0, got "
                    f"{max_weight_lag}")
    if prompts_per_step < 1:
        errs.append(f"{path}.promptsPerStep: must be >= 1, got "
                    f"{prompts_per_step}")
    if max_new_tokens < 1:
        errs.append(f"{path}.maxNewTokens: must be >= 1, got "
                    f"{max_new_tokens}")
    if temperature <= 0:
        errs.append(f"{path}.temperature: must be > 0 (greedy rollouts "
                    f"make all G samples of a group identical, zeroing "
                    f"every advantage), got {temperature}")
    if broadcast_interval < 1:
        errs.append(f"{path}.broadcastInterval: must be >= 1, got "
                    f"{broadcast_interval}")
    elif (actor_replicas >= 1 and max_weight_lag >= 0
            and broadcast_interval > actor_replicas * (max_weight_lag + 1)):
        # the learner needs broadcastInterval updates' worth of
        # trajectories to reach the NEXT version, but the actors' parking
        # guard stops the fleet at actorReplicas * (maxWeightLag + 1)
        # generations per version — past that the whole fleet deadlocks
        # (actors parked for a version the learner can never reach),
        # times out, restarts, and deadlocks again forever
        errs.append(
            f"{path}.broadcastInterval: {broadcast_interval} exceeds "
            f"actorReplicas * (maxWeightLag + 1) = "
            f"{actor_replicas * (max_weight_lag + 1)} — the actors park "
            f"after that many generations per weight version, so the "
            f"learner could never collect enough trajectories to publish "
            f"the next one (the fleet would deadlock)")
    if reward not in RL_REWARDS and ":" not in reward:
        errs.append(f"{path}.reward: unknown {reward!r} "
                    f"({', '.join(RL_REWARDS)}, or 'module.path:fn')")
    if reward == "length" and eos_id < 0:
        errs.append(f"{path}.reward 'length' needs {path}.eosId >= 0: "
                    f"without a stop token every completion is exactly "
                    f"maxNewTokens long and every group's reward is "
                    f"constant — training would be a no-op")
    if rollout_engine not in RL_ROLLOUT_ENGINES:
        errs.append(f"{path}.rolloutEngine: unknown {rollout_engine!r} "
                    f"({', '.join(RL_ROLLOUT_ENGINES)})")
    return errs
