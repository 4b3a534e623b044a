"""Actor runtime -- batched rollouts on their own device (the port's copy of
kubedl_tpu/rl/actor.py).

One actor = one generation loop: pull the newest broadcast weights at the
GENERATION BOUNDARY (never mid-trajectory -- every trajectory is sampled
under exactly one policy version, stamped on it), roll out G completions
a prompt with the behavior log-probs captured at sample time, score them
with the reward, and emit each group as an exactly-once trajectory.

The rollout engine is models/decode.py `generate(with_logprobs=True)`,
numerically the monolithic train/grpo.py path, drawing from a
torch.Generator seeded from (seed, it), or (seed, 1000 + actor index, it)
when the fleet has several actors (train/grpo.py `sampling_generator`).
With engine="serving" it is the paged serving plane instead
(serving/rollout.py `RolloutEngine`, B * G slots, max_len the longest
prompt plus K), whose engine draws from one generator seeded with
seed + actor index for the actor's lifetime.

Off-policy guard: after ``max_weight_lag + 1`` generations at one version
the actor PARKS until the next broadcast (rl.idle cause=learner_starved)
-- trajectories past the learner's staleness bound would be dropped on
arrival. ``lockstep=True`` (n_actors == 1) instead waits for version
``it - 1`` before iteration ``it``: strictly on-policy, the schedule of the
monolithic loop.

The actor keeps its own copy of the parameters (the learner updates its
tree in place), and adopts a version by copying the record's leaves into
that copy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from kubedl_tpu_torch.rl.metrics import rl_metrics
from kubedl_tpu_torch.rl.trajectory import Trajectory, TrajectoryProducer
from kubedl_tpu_torch.rl.weights import WeightReceiver, copy_leaves_into


@dataclass
class ActorConfig:
    actor_index: int = 0
    n_actors: int = 1
    seed: int = 0
    group_size: int = 8
    prompts_per_step: int = 4     # groups emitted per iteration
    max_new_tokens: int = 32
    temperature: float = 1.0
    eos_id: int = -1              # >= 0: completions end at first occurrence
    max_weight_lag: int = 1
    lockstep: bool = False        # strict on-policy (parity oracle config)
    engine: str = "decode"        # decode | serving
    job: str = "rl"
    weight_wait_s: float = 120.0  # park budget before failing loud

    @property
    def actor_id(self) -> str:
        return f"actor-{self.actor_index}"


class ActorRuntime:
    """The rollout half of the fleet; see module docstring."""

    def __init__(
        self,
        params,
        config,
        cfg: ActorConfig,
        prompts: List[List[int]],
        reward_fn: Callable[[list, list], float],
        producer: TrajectoryProducer,
        receiver: Optional[WeightReceiver] = None,
        tracer=None,
    ) -> None:
        from kubedl_tpu_torch.models import llama

        if cfg.temperature <= 0:
            raise ValueError("actor temperature must be > 0 (greedy "
                             "rollouts collapse every group)")
        if cfg.group_size < 2:
            raise ValueError("group_size must be >= 2 (the group mean is "
                             "the baseline)")
        if not prompts:
            raise ValueError("actor needs >= 1 prompt")
        if cfg.engine not in ("decode", "serving"):
            raise ValueError(
                f"unknown rollout engine {cfg.engine!r} (decode | serving)")
        self.config = config
        self.cfg = cfg
        self.prompts = prompts
        self.reward_fn = reward_fn
        self.producer = producer
        self.receiver = receiver
        self.tracer = tracer
        self.weight_version = 0   # version the NEXT rollout samples from
        self.weight_step = 0      # the learner step that version carries
        self._gens_at_version = 0
        self.tokens_generated = 0
        self.rollout_s_total = 0.0
        self.learner_starved_s = 0.0  # time parked waiting for weights
        self._params = llama.tree_map(lambda t: t.detach().clone(), params)
        self.device = next(iter(llama.tree_leaves(self._params))).device
        self.pad_to = max(len(p) for p in prompts)
        self._uniform = len({len(p) for p in prompts}) == 1
        self._serving = None
        if cfg.engine == "serving":
            from kubedl_tpu_torch.serving.rollout import RolloutEngine

            self._serving = RolloutEngine(
                self._params, config, slots=cfg.group_size * cfg.prompts_per_step,
                max_len=self.pad_to + cfg.max_new_tokens,
                temperature=cfg.temperature,
                # per-actor sampling stream: same-seed engines on two
                # actors would emit duplicate groups whenever their prompt
                # picks collide
                seed=cfg.seed + cfg.actor_index)

    @property
    def params(self):
        return self._params

    # -- weight sync -----------------------------------------------------

    def _adopt(self, got) -> None:
        leaves, version, step = got
        if self._serving is not None:
            # the engine shares this tree: the copy below is the swap, so
            # the generation-boundary check runs first
            self._serving.swap_params(self._params)
        copy_leaves_into(self._params, leaves)
        self.weight_version = version
        self.weight_step = step
        self._gens_at_version = 0

    def _trace(self, name: str, dur: float, **attrs) -> None:
        if self.tracer is not None:
            try:
                self.tracer.record(name, duration_s=dur,
                                   actor=self.cfg.actor_id, **attrs)
            except Exception:  # noqa: BLE001 — tracing never blocks rollouts
                pass

    def _wait_and_adopt(self, need: int) -> None:
        """Park until version `need` has arrived, adopt the newest."""
        t0 = time.perf_counter()
        got = self.receiver.wait_for(need, timeout=self.cfg.weight_wait_s)
        waited = time.perf_counter() - t0
        self.learner_starved_s += waited
        self._trace("rl.idle", waited, cause="learner_starved",
                    side="actor", waiting_for_version=need)
        if got is not None:
            t0 = time.perf_counter()
            self._adopt(got)
            self._trace("rl.weight_sync", time.perf_counter() - t0,
                        side="actor", version=self.weight_version)

    def _sync_weights(self, it: int) -> None:
        """Generation-boundary pull; parks when the off-policy guard (or
        lockstep) demands a version that has not arrived yet."""
        if self.receiver is None:
            return
        t0 = time.perf_counter()
        got = self.receiver.poll(timeout=0.0)
        if got is not None:
            self._adopt(got)
            self._trace("rl.weight_sync", time.perf_counter() - t0,
                        side="actor", version=self.weight_version)
        need = 0
        if self.cfg.lockstep:
            # strict on-policy: iteration it samples from the params
            # after it-1 learner updates (the monolithic schedule)
            need = it - 1
        elif self._gens_at_version > self.cfg.max_weight_lag:
            need = self.weight_version + 1
        if self.receiver.version < need:
            self._wait_and_adopt(need)

    def finish(self, last_step: int) -> None:
        """After the last iteration, adopt the weights of learner step
        `last_step` (its last broadcast), so the actor ends on the final
        policy; each wait parks at most weight_wait_s (TimeoutError past
        that). Steps, not versions: a restarted learner renumbers its
        versions from 1 but keeps counting steps."""
        if self.receiver is None:
            return
        got = self.receiver.poll(timeout=0.0)
        if got is not None:
            self._adopt(got)
        while self.weight_step < last_step:
            self._wait_and_adopt(self.receiver.version + 1)

    # -- rollouts --------------------------------------------------------

    def _pick_prompts(self, it: int) -> np.ndarray:
        """Prompt picks derive from the STEP index (and actor index when
        the fleet has several) -- the monolithic grpo.py discipline, so a
        single-actor fleet replays the exact monolith data schedule."""
        derive = ((self.cfg.seed, it) if self.cfg.n_actors == 1
                  else (self.cfg.seed, self.cfg.actor_index, it))
        rng = np.random.default_rng(derive)
        B = self.cfg.prompts_per_step
        return rng.choice(len(self.prompts), size=B,
                          replace=len(self.prompts) < B)

    def _generator(self, it: int) -> torch.Generator:
        from kubedl_tpu_torch.train.grpo import sampling_generator

        if self.cfg.n_actors > 1:
            return sampling_generator(self.device, self.cfg.seed,
                                      1000 + self.cfg.actor_index, it)
        return sampling_generator(self.device, self.cfg.seed, it)

    def _generate(self, tiled: np.ndarray, tiled_plens: np.ndarray, it: int):
        """[(B*G), K] completions + sampling-time logprobs, on the host."""
        from kubedl_tpu_torch.models import decode

        if self._serving is not None:
            B, G, K = (self.cfg.prompts_per_step, self.cfg.group_size,
                       self.cfg.max_new_tokens)
            prompts = [list(tiled[i * G][:tiled_plens[i * G]]) for i in range(B)]
            with torch.no_grad():
                waves = self._serving.rollout(
                    prompts, G, K,
                    eos_id=self.cfg.eos_id if self.cfg.eos_id >= 0 else None)
            comp = np.zeros((B * G, K), np.int32)
            lps = np.zeros((B * G, K), np.float32)
            for b, grp in enumerate(waves):
                for g, (toks, lp) in enumerate(grp):
                    row = b * G + g
                    comp[row, :len(toks)] = toks
                    lps[row, :len(lp)] = lp
            return comp, lps
        with torch.no_grad():
            toks, lps = decode.generate(
                self._params, torch.from_numpy(tiled).to(self.device), self.config,
                self.cfg.max_new_tokens, temperature=self.cfg.temperature,
                generator=self._generator(it),
                lengths=(None if self._uniform
                         else torch.from_numpy(tiled_plens).to(self.device)),
                with_logprobs=True)
        return toks.cpu().numpy(), lps.cpu().numpy()

    def step(self, it: int) -> List[Trajectory]:
        """One iteration: sync weights, roll B groups, emit trajectories."""
        from kubedl_tpu_torch.train.grpo import completion_rows

        self._sync_weights(it)
        B, G, K = (self.cfg.prompts_per_step, self.cfg.group_size,
                   self.cfg.max_new_tokens)
        pick = self._pick_prompts(it)
        batch_prompts = [self.prompts[i] for i in pick]
        plens = np.array([len(p) for p in batch_prompts], np.int32)
        toks = np.zeros((B, self.pad_to), np.int32)
        for i, p in enumerate(batch_prompts):
            toks[i, :len(p)] = p
        tiled = np.repeat(toks, G, axis=0)
        tiled_plens = np.repeat(plens, G)
        t0 = time.perf_counter()
        comp, lps = self._generate(tiled, tiled_plens, it)
        rollout_s = time.perf_counter() - t0
        self.rollout_s_total += rollout_s
        self.tokens_generated += int(comp.size)
        rl_metrics.observe_rollout(
            self.cfg.job, comp.size / max(rollout_s, 1e-9))
        self._trace("rl.rollout", rollout_s, groups=B,
                    tokens=int(comp.size), version=self.weight_version)
        self._gens_at_version += 1

        full, seq_lens, rewards, grid = completion_rows(
            comp, tiled, tiled_plens, self.cfg.eos_id, self.reward_fn, self.pad_to + K, lps)
        out: List[Trajectory] = []
        for b in range(B):
            rows = slice(b * G, (b + 1) * G)
            traj = Trajectory(
                tokens=full[rows], prompt_len=int(plens[b]), seq_lens=seq_lens[rows],
                rewards=rewards[rows], behavior_logprobs=grid[rows],
                weight_version=self.weight_version,
                rollout_s=rollout_s / B, step_hint=it)
            self.producer.send(traj)
            out.append(traj)
        return out

    def run(self, steps: int, start: int = 1) -> None:
        for it in range(start, start + steps):
            self.step(it)
