"""Trajectory queue -- exactly-once rollout delivery, actor -> learner (the
port's copy of kubedl_tpu/rl/trajectory.py: the same records and tags).

A trajectory is one prompt GROUP (the GRPO unit): G completions of one
prompt, their rewards, and the behavior log-probs the actor captured at
sample time (free there; recomputing them on the learner costs a full
forward). Groups travel whole so the learner's group-normalized
advantages never straddle a message boundary.

Delivery contract: tags are deterministic -- ``{actor}.{seq:08d}`` with a
per-actor monotonic seq -- so the consumer knows exactly which message
comes next from each actor; the channel's one-message-a-tag delivery
(parallel/pipeline_mpmd.py) makes that exactly-once. The consumer is
ORDERED per actor and fair across actors (round-robin), so one hot actor
cannot starve another's queue position.

The queue-depth gauge is produced - consumed - stale_dropped within one
process's collector: exact for the in-process fleet, per-pod it reports
that pod's own side.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from kubedl_tpu_torch.rl.metrics import rl_metrics
from kubedl_tpu_torch.rl.wire import decode_arrays, encode_arrays

log = logging.getLogger("kubedl_tpu_torch.rl")

TRAJECTORY_CHANNEL = "rl-traj"


@dataclass
class Trajectory:
    """One rollout group: prompt + G completions, rewards, behavior lp."""

    tokens: np.ndarray            # [G, T] int32 — prompt+completion, padded
    prompt_len: int               # the group shares one prompt
    seq_lens: np.ndarray          # [G] int32 — true length incl. prompt
    rewards: np.ndarray           # [G] f32
    behavior_logprobs: np.ndarray  # [G, T-1] f32 grid (sequence_logprobs
    # layout: index i holds log p(token i+1); zero outside the completion)
    weight_version: int = 0       # policy version the rollout sampled from
    actor: str = ""
    seq: int = 0                  # per-actor monotonic (the delivery tag)
    rollout_s: float = 0.0        # actor-side generation seconds
    step_hint: int = 0            # actor iteration (parity/debug)

    def __post_init__(self) -> None:
        self.tokens = np.asarray(self.tokens, np.int32)
        self.seq_lens = np.asarray(self.seq_lens, np.int32)
        self.rewards = np.asarray(self.rewards, np.float32)
        self.behavior_logprobs = np.asarray(
            self.behavior_logprobs, np.float32)
        g, t = self.tokens.shape
        if self.seq_lens.shape != (g,) or self.rewards.shape != (g,):
            raise ValueError(
                f"trajectory group mismatch: tokens {self.tokens.shape}, "
                f"seq_lens {self.seq_lens.shape}, rewards "
                f"{self.rewards.shape}")
        if self.behavior_logprobs.shape != (g, t - 1):
            raise ValueError(
                f"behavior_logprobs must be [G, T-1] = {(g, t - 1)}, got "
                f"{self.behavior_logprobs.shape} (sequence_logprobs grid)")
        if not 0 < int(self.prompt_len) < t:
            raise ValueError(
                f"prompt_len {self.prompt_len} out of (0, {t})")


def encode_trajectory(traj: Trajectory) -> bytes:
    return encode_arrays(
        [("tokens", traj.tokens),
         ("seq_lens", traj.seq_lens),
         ("rewards", traj.rewards),
         ("behavior_logprobs", traj.behavior_logprobs)],
        meta={
            "prompt_len": int(traj.prompt_len),
            "weight_version": int(traj.weight_version),
            "actor": traj.actor,
            "seq": int(traj.seq),
            "rollout_s": float(traj.rollout_s),
            "step_hint": int(traj.step_hint),
        })


def decode_trajectory(data: bytes) -> Trajectory:
    arrays, meta = decode_arrays(data)
    try:
        return Trajectory(
            tokens=arrays["tokens"],
            prompt_len=int(meta["prompt_len"]),
            seq_lens=arrays["seq_lens"],
            rewards=arrays["rewards"],
            behavior_logprobs=arrays["behavior_logprobs"],
            weight_version=int(meta.get("weight_version", 0)),
            actor=str(meta.get("actor", "")),
            seq=int(meta.get("seq", 0)),
            rollout_s=float(meta.get("rollout_s", 0.0)),
            step_hint=int(meta.get("step_hint", 0)),
        )
    except KeyError as e:
        raise ValueError(f"trajectory record missing field {e}") from e


class TrajectoryProducer:
    """Actor-side send half over one channel to the learner."""

    def __init__(self, channel, actor: str, job: str = "rl") -> None:
        self.channel = channel
        self.actor = actor
        self.job = job
        self._seq = 0

    def send(self, traj: Trajectory) -> None:
        self._seq += 1
        traj.actor = self.actor
        traj.seq = self._seq
        self.channel.send(f"{self.actor}.{self._seq:08d}",
                          encode_trajectory(traj))
        rl_metrics.on_produced(self.job)


@dataclass
class _ActorCursor:
    channel: object
    next_seq: int = 1
    failed: Optional[BaseException] = None


class TrajectoryConsumer:
    """Learner-side receive half over one channel PER actor.

    ``take(timeout)`` returns the next trajectory from any actor
    (round-robin, in per-actor seq order) or None when the deadline
    passes with every queue empty — the caller books that wait as
    actor-starved time. A channel whose recv raises a non-timeout error
    (poisoned inbox: a restarted actor on a latched plane) marks that
    actor failed LOUDLY on the first take after it; the other actors
    keep flowing."""

    def __init__(self, channels: Dict[str, object], job: str = "rl",
                 poll_s: float = 0.02) -> None:
        if not channels:
            raise ValueError("trajectory consumer needs >= 1 actor channel")
        self.job = job
        self.poll_s = poll_s
        self._cursors = {
            actor: _ActorCursor(channel=ch)
            for actor, ch in channels.items()
        }
        self._order = sorted(self._cursors)
        self._rr = 0

    def failed_actors(self) -> Dict[str, BaseException]:
        return {a: c.failed for a, c in self._cursors.items()
                if c.failed is not None}

    def take(self, timeout: float = 30.0) -> Optional[Trajectory]:
        deadline = time.monotonic() + timeout
        while True:
            live = [a for a in self._order
                    if self._cursors[a].failed is None]
            if not live:
                failures = {a: repr(e)
                            for a, e in self.failed_actors().items()}
                raise RuntimeError(
                    f"every actor channel failed: {failures}")
            for _ in range(len(live)):
                actor = live[self._rr % len(live)]
                self._rr += 1
                cur = self._cursors[actor]
                tag = f"{actor}.{cur.next_seq:08d}"
                try:
                    data = cur.channel.recv(tag, timeout=0.0)
                except TimeoutError:
                    continue
                except Exception as e:  # noqa: BLE001 — poisoned channel
                    cur.failed = e
                    # loud: the fleet keeps flowing on the survivors,
                    # but a silently-shrunk actor pool reads as healthy
                    # with mysteriously degraded throughput
                    log.error(
                        "trajectory channel for %s failed; dropping it "
                        "from the rotation (%d/%d actors left): %r",
                        actor,
                        sum(1 for c in self._cursors.values()
                            if c.failed is None),
                        len(self._cursors), e)
                    print(f"rl: actor {actor} channel failed — "
                          f"continuing on the surviving actors: {e!r}",
                          flush=True)
                    continue
                cur.next_seq += 1
                return decode_trajectory(data)
            if time.monotonic() >= deadline:
                return None
            time.sleep(self.poll_s)
