"""Rollout mode -- the serving plane reused as an RL rollout engine (the
port's copy of kubedl_tpu/serving/rollout.py).

GRPO rollouts are G samples of the SAME prompt: the shape the paged-KV
pool's copy-on-write prefix sharing was built for. A prompt whose full
blocks are already indexed (a later wave of the same prompt) is admitted
by reference: its group shares one prompt's K/V blocks. The engine's
per-request ``logprobs=True`` captures each emitted token's log-prob
under the model's untempered distribution (models/serving.py
`chosen_logprob`, the convention of ``decode.generate(with_logprobs=True)``
and ``sequence_logprobs``), so behavior log-probs ride out of sampling.

Weight versions: ``swap_params`` replaces the engine's param tree at a
GENERATION BOUNDARY (no requests in flight -- enforced), which is how the
actor runtime adopts a broadcast version between rollouts.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kubedl_tpu_torch.serving.disaggregated import DisaggregatedEngine


class RolloutEngine:
    """Group sampling with behavior log-probs over the paged serving
    plane. One instance per actor pod; submit/drain is a full wave per
    rollout call (RL generation is throughput-bound, not latency-bound --
    no need for continuous admission)."""

    def __init__(
        self,
        params: Dict,
        config,
        slots: int = 8,
        max_len: int = 1024,
        temperature: float = 1.0,
        seed: int = 0,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
    ) -> None:
        if temperature <= 0:
            raise ValueError(
                "rollout temperature must be > 0: greedy rollouts make "
                "all G samples of a group identical, which zeroes every "
                "group-normalized advantage")
        self.engine = DisaggregatedEngine(
            params, config, slots=slots, max_len=max_len,
            temperature=temperature, seed=seed, block_size=block_size,
            num_blocks=num_blocks, share_prefixes=True)

    def swap_params(self, params: Dict) -> None:
        """Adopt a new policy version. Generation-boundary only: swapping
        under in-flight requests would mix policy versions inside one
        trajectory, poisoning its behavior log-probs."""
        if self.engine.has_pending():
            raise RuntimeError(
                "swap_params with requests in flight — a trajectory must "
                "be sampled under ONE policy version; drain first")
        self.engine.prefill.params = params
        self.engine.decode.params = params

    def rollout(
        self,
        prompts: List[List[int]],
        group_size: int,
        max_new_tokens: int,
        eos_id: Optional[int] = None,
    ) -> List[List[Tuple[List[int], List[float]]]]:
        """One wave: for each prompt, G sampled completions with their
        per-token behavior log-probs -- ``out[p][g] = (tokens,
        logprobs)``. A request the engine failed surfaces as an error,
        never as a silently empty completion."""
        if group_size < 2:
            raise ValueError(
                f"group_size must be >= 2 (the group mean is the GRPO "
                f"baseline), got {group_size}")
        groups = []
        for p in prompts:
            groups.append([
                self.engine.submit(p, max_new_tokens, eos_token=eos_id,
                                   logprobs=True)
                for _ in range(group_size)
            ])
        flat = [r for grp in groups for r in grp]
        while not all(r.done for r in flat):
            self.engine.step_block()
        out = []
        for grp in groups:
            rows = []
            for r in grp:
                if r.error:
                    raise RuntimeError(f"rollout request failed: {r.error}")
                rows.append((list(r.tokens), list(r.token_logprobs)))
            out.append(rows)
        return out

    def stats(self) -> Dict:
        return self.engine.stats()
