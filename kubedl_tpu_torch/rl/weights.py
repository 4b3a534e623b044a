"""Versioned weight broadcast -- learner -> actor fleet (the port's copy of
kubedl_tpu/rl/weights.py; a record of the same parameters is the same
bytes in both packages).

The learner publishes its policy after (every ``broadcast_interval``)
update steps as a version-stamped record (rl/wire.py) of the parameter
tree's leaves, each with its dtype string and shape; bf16 leaves travel as
their raw words. The receiver puts the leaves back into its OWN tree
(actor and learner build the same model config), so no tree structure
ever travels.

Leaf order is the contract, and it is JAX's ``tree_flatten`` order: dict
keys SORTED, lists in order (`sorted_leaves`). models/llama.py's
``tree_leaves`` walks insertion order, which other paths rely on, so this
module keeps its own walk.

Versions are sequential from 1 and the delivery tag is deterministic
(``w.{version:08d}``), so the receiver always knows the next message to
look for: ``poll()`` drains every already-arrived version and decodes
only the NEWEST (intermediate payloads are skipped bytes, not skipped
messages).
"""
from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

import torch

from kubedl_tpu_torch.rl.wire import decode_arrays, encode_arrays

WEIGHT_CHANNEL = "rl-weights"


def sorted_leaves(tree) -> List[Any]:
    """The leaves of a nested dict/list tree in JAX's flatten order: dict
    keys sorted, list items in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def copy_leaves_into(params, leaves: List[torch.Tensor]) -> None:
    """Copy `leaves` (in `sorted_leaves` order) into the tensors of
    `params`, in place; shapes and dtypes must match leaf for leaf."""
    dst = sorted_leaves(params)
    if len(dst) != len(leaves):
        raise ValueError(f"weight record has {len(leaves)} leaves, the model {len(dst)}")
    with torch.no_grad():
        for i, (d, s) in enumerate(zip(dst, leaves)):
            if tuple(d.shape) != tuple(s.shape) or d.dtype != s.dtype:
                raise ValueError(f"weight leaf {i}: record {tuple(s.shape)} {s.dtype}, "
                                 f"model {tuple(d.shape)} {d.dtype}")
            d.copy_(s)


def encode_weights(params, version: int, step: int = 0) -> bytearray:
    """Flattened-leaf record of one policy version. Leaves are named by
    their flatten index -- order IS the contract."""
    if version < 1:
        raise ValueError(f"weight version must be >= 1, got {version}")
    leaves = sorted_leaves(params)
    if not leaves:
        raise ValueError("empty param tree")
    arrays = [(f"leaf{i:05d}", leaf) for i, leaf in enumerate(leaves)]
    return encode_arrays(
        arrays, meta={"version": int(version), "step": int(step),
                      "n_leaves": len(leaves)})


def decode_weights(data) -> Tuple[List[torch.Tensor], int, int]:
    """(leaves in flatten order as CPU tensors, version, step); put them
    back with `copy_leaves_into`."""
    arrays, meta = decode_arrays(data)
    leaves = list(arrays.values())  # decode preserves header order
    if len(leaves) != int(meta.get("n_leaves", -1)):
        raise ValueError(
            f"weight record leaf count mismatch: header says "
            f"{meta.get('n_leaves')}, payload has {len(leaves)}")
    return leaves, int(meta["version"]), int(meta.get("step", 0))


class WeightBroadcaster:
    """Learner-side publish half: one channel per actor, every actor
    gets every version (the tag makes resends idempotent).

    With a `distributor` (weights/dist.py RootDistributor over the
    broadcast tree) the single encoded record rides the O(log n) chunk
    relay instead of n hub-and-spoke sends; relay sidecars re-inject the
    SAME bytes into each actor's weight channel, so the receiver half is
    identical either way. Hub-and-spoke stays the <= 2-actor path and the
    parity oracle. On BOTH paths the payload is serialized exactly once a
    version: ``bytes_encoded_total`` grows by one state size a publish."""

    def __init__(self, channels: List[object], distributor=None) -> None:
        if not channels and distributor is None:
            raise ValueError("weight broadcaster needs >= 1 actor channel")
        self.channels = list(channels)
        self.distributor = distributor
        self.version = 0
        self.bytes_encoded_total = 0
        self.last_payload_bytes = 0

    def publish(self, params, step: int = 0) -> Tuple[int, float]:
        """Encode once, send to every actor; returns (version, seconds)."""
        self.version += 1
        t0 = time.perf_counter()
        payload = encode_weights(params, self.version, step)
        self.last_payload_bytes = len(payload)
        self.bytes_encoded_total += len(payload)
        if self.distributor is not None:
            self.distributor.distribute(payload, self.version, step)
        else:
            tag = f"w.{self.version:08d}"
            for ch in self.channels:
                ch.send(tag, payload)
        return self.version, time.perf_counter() - t0


class WeightReceiver:
    """Actor-side receive half: tracks the next expected version and
    adopts the newest available at each generation boundary."""

    def __init__(self, channel) -> None:
        self.channel = channel
        self.version = 0  # newest adopted (0 = still on the base policy)

    def poll(self, timeout: float = 0.0) -> Optional[Tuple[List, int, int]]:
        """Newest already-delivered (leaves, version, step), or None.
        With a timeout, waits up to that long for version+1 to arrive
        (then still drains anything newer that landed meanwhile)."""
        newest = None
        wait = timeout
        while True:
            tag = f"w.{self.version + 1:08d}"
            try:
                data = self.channel.recv(tag, timeout=wait)
            except TimeoutError:
                break
            wait = 0.0  # only the FIRST recv blocks; the rest drain
            self.version += 1
            newest = data
        if newest is None:
            return None
        leaves, version, step = decode_weights(newest)
        if version != self.version:
            raise ValueError(
                f"weight record carries version {version} under tag for "
                f"{self.version} — publisher/tag drift")
        return leaves, version, step

    def wait_for(self, version: int, timeout: float = 60.0):
        """Block until at least `version` has been RECEIVED; returns the
        newest (leaves, version, step) this call took delivery of, or
        None when `version` was already adopted before the call (nothing
        new to hand back). The actor's off-policy guard parks here when
        it runs too far ahead of the learner — that wait is
        learner-starved time (rl.idle)."""
        deadline = time.monotonic() + timeout
        newest = None
        while self.version < version:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"weight version {version} not received within "
                    f"{timeout:.1f}s (have {self.version})")
            got = self.poll(timeout=left)
            if got is not None:
                newest = got
        return newest
