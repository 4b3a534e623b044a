"""Deterministic fan-out-f broadcast tree over a gang's pod list.

The source (learner / operator) is a distinguished ``ROOT`` node that is
NOT in the pod list; pods are arranged under it as a complete f-ary
tree over a version-seeded shuffle of the list:

* every pod appears exactly once (it is a permutation);
* the root and every pod have at most ``fanout`` children, so no node —
  including the source — ever sends more than ``fanout`` copies of the
  payload (no O(n) hotspot);
* depth <= ceil(log_f n): pod at shuffled index j has parent index
  ``j // fanout - 1`` (index < fanout hangs off the root), the
  heap-shaped complete tree;
* the shuffle is seeded by (version, pods), so the SAME (pods, version)
  pair yields the SAME tree on every node with no coordination, while
  successive versions rotate which pods serve as interior nodes —
  relay cost amortizes across the fleet instead of pinning to the
  first f pods forever.
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: the distinguished source node (learner / operator); never in `order`.
ROOT = ""


def _seed(pods: Sequence[str], version: int) -> int:
    """Process-independent shuffle seed (hash() is salted per process)."""
    h = hashlib.sha256()
    h.update(str(int(version)).encode("utf-8"))
    for p in pods:
        h.update(b"\x00")
        h.update(p.encode("utf-8"))
    return int.from_bytes(h.digest()[:8], "big")


@dataclass(frozen=True)
class TreeSpec:
    """One version's broadcast tree: the shuffled pod order IS the
    topology (index arithmetic gives parents/children)."""

    version: int
    fanout: int
    order: Tuple[str, ...]
    _pos: Dict[str, int] = field(default_factory=dict, repr=False,
                                 compare=False)

    def __post_init__(self) -> None:
        self._pos.update({p: i for i, p in enumerate(self.order)})

    def index(self, pod: str) -> int:
        try:
            return self._pos[pod]
        except KeyError:
            raise ValueError(
                f"pod {pod!r} is not in version {self.version}'s tree")

    def children(self, node: str) -> List[str]:
        """Direct children of `node` (`ROOT` for the source)."""
        n = len(self.order)
        if node == ROOT:
            return list(self.order[:min(self.fanout, n)])
        i = self.index(node)
        first = (i + 1) * self.fanout
        return list(self.order[first:first + self.fanout])

    def parent(self, pod: str) -> str:
        """`ROOT` for pods fed directly by the source."""
        j = self.index(pod)
        if j < self.fanout:
            return ROOT
        return self.order[j // self.fanout - 1]

    def depth_of(self, pod: str) -> int:
        """Hops from the source (direct children are depth 1)."""
        d, node = 0, pod
        while node != ROOT:
            node = self.parent(node)
            d += 1
        return d

    def max_depth(self) -> int:
        return self.depth_of(self.order[-1]) if self.order else 0

    def interior(self) -> List[str]:
        """Pods that relay to at least one child this version."""
        return [p for p in self.order if self.children(p)]


def build_tree(pods: Sequence[str], version: int,
               fanout: int = 4) -> TreeSpec:
    """The version's tree. Deterministic given (pods, version, fanout);
    the pod SET (not its order) defines the topology family — callers
    pass the gang's pod list in any stable order."""
    if version < 1:
        raise ValueError(f"tree version must be >= 1, got {version}")
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    if not pods:
        raise ValueError("empty pod list")
    if len(set(pods)) != len(pods):
        raise ValueError("duplicate pods in tree pod list")
    if ROOT in pods:
        raise ValueError("the empty pod name is reserved for the source")
    order = sorted(pods)
    random.Random(_seed(order, version)).shuffle(order)
    return TreeSpec(version=int(version), fanout=int(fanout),
                    order=tuple(order))


def validate_tree(spec: TreeSpec, pods: Sequence[str]) -> Optional[str]:
    """Why `spec` is not a valid tree over `pods`, or None. Receivers
    run this on the announced order before relaying — a corrupt or
    adversarial announce must not make a pod relay to the wrong place."""
    if sorted(spec.order) != sorted(pods):
        return "announced tree order is not a permutation of the pod set"
    if spec.fanout < 1:
        return f"announced fanout {spec.fanout} invalid"
    return None
