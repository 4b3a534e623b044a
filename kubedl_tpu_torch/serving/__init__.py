"""Disaggregated serving plane (the port's copy of kubedl_tpu/serving/).

The monolithic `models/serving.py` engine interleaves admission prefill
and decode ticks on one host thread over one contiguous [slots, max_len]
cache. This package splits that hot path into cooperating pieces:

  * kv_pool        -- paged KV: a block-pool allocator (fixed-size blocks,
                      per-request block tables, refcounted copy-on-write
                      prefix sharing keyed by prompt-prefix hash) plus the
                      device-side row pool the decode tick gathers through;
  * engine_prefill -- batched prefill through the flash kernel, with no
                      decode ticks in its path; emits KV rows + the first
                      token;
  * engine_decode  -- tick-only decode over the paged pool;
  * handoff        -- prefill->decode KV transfer, by reference in-process
                      or serialized (npz, the JAX package's bytes) for a
                      cross-pod hop;
  * disaggregated  -- a facade with the monolithic engine's API and
                      exact-token parity;
  * router         -- the multi-pod fleet: shortest-queue prefill routing,
                      least-outstanding-blocks decode routing, per-pod
                      health/drain with mid-stream migration;
  * rollout        -- the plane as an RL rollout engine (rl/actor.py
                      engine="serving").
"""
from kubedl_tpu_torch.serving.disaggregated import DisaggregatedEngine
from kubedl_tpu_torch.serving.engine_decode import DecodeEngine
from kubedl_tpu_torch.serving.engine_prefill import PrefillEngine
from kubedl_tpu_torch.serving.handoff import (
    HandoffItem,
    HandoffQueue,
    deserialize_item,
    serialize_item,
)
from kubedl_tpu_torch.serving.kv_pool import BlockPool, PoolExhausted, PrefixIndex
from kubedl_tpu_torch.serving.rollout import RolloutEngine
from kubedl_tpu_torch.serving.router import DecodePod, PrefillPod, ServingRouter

__all__ = [
    "BlockPool",
    "DecodeEngine",
    "DecodePod",
    "DisaggregatedEngine",
    "HandoffItem",
    "HandoffQueue",
    "PoolExhausted",
    "PrefillEngine",
    "PrefillPod",
    "PrefixIndex",
    "RolloutEngine",
    "ServingRouter",
    "deserialize_item",
    "serialize_item",
]
