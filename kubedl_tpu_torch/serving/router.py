"""ServingRouter -- the multi-pod serving fleet's traffic brain (the port's
copy of kubedl_tpu/serving/router.py).

The operator reconciles N prefill pods + M decode pods (JAXJob
`spec.serving`); this module is the routing logic those pods and the
front end share:

  * prefill routing: SHORTEST QUEUE among healthy, non-draining prefill
    pods -- prefill work is queue-bound, so queue depth IS the load;
  * decode routing: LEAST OUTSTANDING KV BLOCKS among healthy,
    non-draining decode pods with a free slot -- blocks, not request
    count, measure a decode pod's true occupancy under paged KV (one
    2k-context stream outweighs five short chats);
  * per-pod health/draining with MID-STREAM MIGRATION: draining or
    failing a decode pod re-routes its in-flight streams as
    continuations (prompt + tokens emitted so far) through the normal
    path; emitted tokens are never lost, and greedy streams resume
    token-exact in practice -- the re-prefill recomputes the same KV
    mathematically, though prefill's float order can flip an argmax
    near-tie against the tick path.

In-process the handoff travels by reference; with `cross_pod=True`
every prefill->decode hop round-trips through `serialize_item`/
`deserialize_item` -- the wire discipline. Passing `transport=` (a
send/recv channel: `transport.SocketChannel` over the authenticated
plane, or `DirChannel` in local tests) sends the serialized payload over
a REAL hop instead of the in-memory round trip.

Pods here are in-process objects (one engine each), which is both the
test harness and the single-host deployment; a networked deployment
keeps this routing logic and swaps the pod handles for HTTP clients.
Each prefill pod keeps its own torch.Generator (seeded with `seed`), one
draw per pumped request.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from kubedl_tpu_torch.models.serving import Request, _bucket, validate_sampling
from kubedl_tpu_torch.serving.engine_decode import DecodeEngine
from kubedl_tpu_torch.serving.engine_prefill import PrefillEngine
from kubedl_tpu_torch.serving.handoff import (
    HandoffItem,
    HandoffQueue,
    deserialize_item,
    serialize_item,
)
from kubedl_tpu_torch.serving.kv_pool import PoolExhausted


class PrefillPod:
    """One prefill engine + its work queue (a pod in the serving fleet)."""

    def __init__(self, name: str, params, config, max_len: int = 1024,
                 prompt_buckets=None, prefill_chunk: int = 256,
                 seed: int = 0, max_top_k: int = 64) -> None:
        self.name = name
        self.engine = PrefillEngine(
            params, config, max_len=max_len, prompt_buckets=prompt_buckets,
            prefill_chunk=prefill_chunk, max_top_k=max_top_k)
        self.healthy = True
        self.draining = False
        # weight-rollout state: the version this pod's
        # params were prefilled/decoded with; 0 = the boot params
        self.model_version = 0
        self._staged = None  # (version, params) awaiting commit
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self.generator = torch.Generator(
            device=self.engine.device).manual_seed(seed)

    def stage_params(self, version: int, params) -> None:
        with self._lock:
            if version > self.model_version:
                self._staged = (version, params)

    def try_commit(self) -> bool:
        """Swap to the staged version. Prefill is stateless per request
        (each pump computes a fresh KV), so the swap lands between
        pumps — queued requests simply prefill at the NEW version."""
        with self._lock:
            if self._staged is None:
                return False
            self.model_version, self.engine.params = self._staged
            self._staged = None
            return True

    def queue_len(self) -> int:
        with self._lock:
            return len(self._queue)

    def enqueue(self, req: Request) -> None:
        with self._lock:
            self._queue.append(req)

    def steal_queue(self) -> List[Request]:
        """Drain the waiting queue (for re-routing on drain/failure)."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            return out

    def pump_one(self) -> Optional[HandoffItem]:
        """Prefill one queued request; returns its handoff item."""
        with self._lock:
            if not self._queue:
                return None
            req = self._queue.popleft()
        eng = self.engine
        prompt = np.asarray(req.prompt, np.int32)
        try:
            if (len(prompt) > eng.prompt_buckets[-1]
                    and eng.prefill_chunk > 0):
                first, _lp, rows_k, rows_v, t, _tp = eng.prefill_chunked(
                    req, self.generator)
                total = t
            else:
                bucket = _bucket(len(prompt), eng.prompt_buckets)
                firsts, _lps, rows, lengths = eng.prefill_group(
                    [req], bucket, self.generator)
                rows_k, rows_v = eng.extract_rows(rows, 0, bucket)
                first = firsts[0]
                total = int(lengths[0])
        except Exception as e:  # noqa: BLE001 — fail the request, keep
            # the pod serving (a poisoned prompt must not kill the pod)
            req.error = f"prefill failed: {e}"
            req.done = True
            req.finished_at = time.monotonic()
            return None
        return HandoffItem(
            request=req, prompt=prompt, total_len=total, start=0,
            rows_k=rows_k, rows_v=rows_v,
            first_token=int(first), first_logprob=0.0,
            meta={"request_id": req.request_id,
                  "max_new_tokens": req.max_new_tokens,
                  "temperature": req.temperature,
                  "top_k": req.top_k, "top_p": req.top_p,
                  "eos_token": req.eos_token,
                  # the KV rows above were computed by THIS version;
                  # decode must happen on a pod running the same one
                  "model_version": self.model_version})


class DecodePod:
    """One paged decode engine (a pod in the serving fleet)."""

    def __init__(self, name: str, params, config, slots: int = 8,
                 max_len: int = 1024, block_size: int = 16,
                 num_blocks: Optional[int] = None, seed: int = 0,
                 max_top_k: int = 64, share_prefixes: bool = False) -> None:
        self.name = name
        # pods serve full prefills from remote prefill pods; prefix
        # sharing needs the prefill to happen against THIS pod's pool,
        # so it stays a facade/same-pool feature unless enabled
        self.engine = DecodeEngine(
            params, config, slots=slots, max_len=max_len,
            block_size=block_size, num_blocks=num_blocks, seed=seed,
            max_top_k=max_top_k, share_prefixes=share_prefixes)
        self.healthy = True
        self.draining = False
        self.model_version = 0
        self._staged = None  # (version, params) awaiting commit
        self._lock = threading.Lock()

    def stage_params(self, version: int, params) -> None:
        with self._lock:
            if version > self.model_version:
                self._staged = (version, params)

    def try_commit(self) -> bool:
        """Swap to the staged version ONLY while no stream is in flight
        — the same refusal RolloutEngine.swap_params makes: a stream's
        KV was computed by the version that prefilled it, and decoding
        it under new params would silently mix versions mid-stream."""
        with self._lock:
            if self._staged is None:
                return False
            if any(r is not None for r in self.engine._slot_req):
                return False
            self.model_version, self.engine.params = self._staged
            self._staged = None
            return True

    def free_slots(self) -> int:
        with self._lock:
            return self.engine.free_slots()

    def blocks_outstanding(self) -> int:
        with self._lock:
            return self.engine.blocks_outstanding()

    def admit(self, item: HandoffItem, req: Request) -> None:
        with self._lock:
            slot = self.engine.admit(item, req)
            # first emission happens pod-side so streams see the token
            # as soon as the handoff lands
            if not req.done:
                self.engine._emit(slot, item.first_token, item.first_logprob)

    def tick_block(self, k: int = 8) -> int:
        with self._lock:
            decoding = self.engine.decoding()
            if not decoding:
                return 0
            try:
                self.engine.ensure_capacity(k)
            except PoolExhausted:
                k = 1  # tick-by-tick while streams finish and free blocks
                self.engine.ensure_capacity(1)
            return self.engine.tick_block(k)

    def in_flight(self) -> List[Request]:
        with self._lock:
            return [r for r in self.engine._slot_req if r is not None]

    def evict_youngest(self) -> Optional[Request]:
        """Evict the most recently admitted stream under pool pressure
        (its re-prefill costs the least); None when one lone stream
        holds the pool — evicting it would just loop."""
        with self._lock:
            decoding = self.engine.decoding()
            if len(decoding) <= 1:
                return None
            victim = max(decoding, key=lambda s: self.engine._slot_seq[s])
            return self.engine.evict_slot(victim)

    def evict_all(self) -> List[Request]:
        """Free every in-flight stream's blocks (drain/failover path);
        returns the evicted requests for re-routing."""
        with self._lock:
            out = []
            for slot, req in enumerate(self.engine._slot_req):
                if req is not None:
                    out.append(self.engine.evict_slot(slot))
            return out


class ServingRouter:
    """Load-aware routing + health/drain over a prefill/decode fleet."""

    def __init__(self, prefill_pods: List[PrefillPod],
                 decode_pods: List[DecodePod],
                 cross_pod: bool = False, transport=None,
                 job: str = "") -> None:
        if not prefill_pods or not decode_pods:
            raise ValueError("a serving fleet needs >= 1 prefill and "
                             ">= 1 decode pod")
        self.prefill_pods = list(prefill_pods)
        self.decode_pods = list(decode_pods)
        self.cross_pod = cross_pod
        # cross_pod transport: any send(tag, bytes)/recv(tag, timeout)
        # channel (transport.SocketChannel over the authenticated plane,
        # or DirChannel in local tests). The ALREADY-SERIALIZED npz
        # payload rides it verbatim; None keeps the in-memory serialize
        # round trip (the wire discipline without the wire).
        if transport is not None and not cross_pod:
            raise ValueError("a handoff transport requires cross_pod=True "
                             "(by-reference items cannot ride a wire)")
        self.transport = transport
        # per-HOP sequence: a request re-prefilled after a drain/eviction
        # crosses the transport again, and the socket plane dedups by
        # tag — a tag built from the request id alone would make every
        # migration's second payload vanish into the dedup
        self._hop_seq = 0
        # the tightest pod bounds every request (any pod may serve it)
        self.max_len = min(p.engine.max_len
                           for p in self.prefill_pods + self.decode_pods)
        self.max_top_k = min(p.engine.max_top_k for p in self.decode_pods)
        self.handoffs = HandoffQueue()
        # live requests only: entries are reaped as requests finish, so
        # a long-running router never accumulates dead prompt arrays
        self._by_id: Dict[int, Request] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self.migrations = 0
        self.serialized_bytes = 0
        # weight-rollout target: the newest version pushed to the fleet.
        # Pods commit independently (prefill immediately, decode as its
        # streams drain); `job` labels the kubedl_model_version gauge.
        self.job = job
        self.target_version = 0

    # -- routing policies --------------------------------------------------

    def _eligible(self, pods):
        return [p for p in pods if p.healthy and not p.draining]

    def route_prefill(self) -> PrefillPod:
        """Shortest queue among eligible prefill pods."""
        pods = self._eligible(self.prefill_pods)
        if not pods:
            raise RuntimeError("no healthy prefill pods")
        return min(pods, key=lambda p: p.queue_len())

    def route_decode(self,
                     version: Optional[int] = None) -> Optional[DecodePod]:
        """Least outstanding KV blocks among eligible decode pods with a
        free slot; None when every pod is full (the handoff waits).
        With `version`, only pods COMMITTED to that exact version are
        eligible — a handoff's KV must decode under the params that
        prefilled it, never a mix ."""
        pods = [p for p in self._eligible(self.decode_pods)
                if p.free_slots() > 0
                and (version is None or p.model_version == version)]
        if not pods:
            return None
        return min(pods, key=lambda p: p.blocks_outstanding())

    # -- traffic -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               eos_token: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        # same shared validator as the monolith and the facade — the
        # router is a third submit entry point, and an unvalidated top_k
        # would silently clamp in sample_tokens instead of rejecting
        validate_sampling(temperature, top_k, top_p,
                          self.max_top_k, None)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + max_new_tokens > self.max_len:
            # same guard as the monolithic submit — past max_len the
            # decode write clamps to the last row and silently corrupts
            # the stream's KV, so over-long requests must die HERE
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens "
                f"exceeds max_len {self.max_len}")
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        req = Request(rid, prompt, max_new_tokens, eos_token,
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p))
        with self._lock:
            self._by_id[rid] = req
        self.route_prefill().enqueue(req)
        return req

    def _resubmit(self, req: Request) -> None:
        """Continuation re-route after a drain/failover: the prompt
        grows by the tokens already emitted, so the re-prefill recomputes
        the stream's KV and greedy decoding resumes where it left off
        (emitted tokens are never lost; see the module doc's float-order
        caveat on exactness)."""
        req.prompt = np.concatenate(
            [np.asarray(req.prompt, np.int32),
             np.asarray(req.tokens, np.int32)])
        self.migrations += 1
        self.route_prefill().enqueue(req)

    def pump_prefill(self) -> int:
        """One prefill from every eligible pod's queue -> handoff queue
        (serialized round trip in cross_pod mode; over the transport
        channel when one is wired — the real pod-to-pod hop)."""
        moved = 0
        for pod in self._eligible(self.prefill_pods):
            item = pod.pump_one()
            if item is None:
                continue
            if self.cross_pod:
                payload = serialize_item(item)
                self.serialized_bytes += len(payload)
                if self.transport is not None:
                    # the serialized KV payload rides the message plane
                    # byte-for-byte; the tag must be unique per HOP, not
                    # per request — migrations re-prefill the same id
                    with self._lock:
                        self._hop_seq += 1
                        hop = self._hop_seq
                    tag = f"kv-{int(item.meta['request_id'])}-{hop}"
                    self.transport.send(tag, payload)
                    payload = self.transport.recv(tag, timeout=60.0)
                item = deserialize_item(payload)
                item.request = self._by_id[int(item.meta["request_id"])]
            self.handoffs.put(item)
            moved += 1
        return moved

    def dispatch_handoffs(self) -> int:
        """Admit queued handoffs to the least-loaded decode pods."""
        admitted = 0
        held = []
        while True:
            item = self.handoffs.get()
            if item is None:
                break
            pod = self.route_decode(
                version=item.meta.get("model_version"))
            if pod is None:
                # every matching pod full — or mid-rollout, none has
                # committed this item's version yet; retry next round
                held.append(item)
                continue
            req = item.request
            try:
                pod.admit(item, req)
            except PoolExhausted:
                held.append(item)
                continue
            admitted += 1
        for item in reversed(held):  # head of queue, original order kept
            self.handoffs.requeue(item)
        return admitted

    def pump_decode(self, k: int = 8) -> int:
        n = 0
        for pod in self.decode_pods:
            if not pod.healthy:
                continue  # draining pods still finish in-flight work
            try:
                n += pod.tick_block(k)
            except PoolExhausted:
                # even tick-by-tick the pod's pool can't cover every
                # stream's next block (undersized kvBlocks or a pile-up
                # of near-max streams): evict the youngest stream and
                # re-route it as a continuation instead of letting the
                # pump die and stall the whole fleet
                req = pod.evict_youngest()
                if req is None:
                    raise  # a single stream outgrew the pool: config error
                self._resubmit(req)
        self._reap_done()
        return n

    def _reap_done(self) -> None:
        """Drop finished requests from the routing table. Covers every
        completion path (prefill failure, first-token at admit, decode
        ticks) because it scans, and nothing here outlives the caller's
        own reference to the Request it submitted."""
        with self._lock:
            for rid in [r_id for r_id, r in self._by_id.items() if r.done]:
                del self._by_id[rid]

    def step_all(self, k: int = 8) -> int:
        """One deterministic scheduling round (the single-threaded
        driver tests use; production pumps each stage from its own
        thread/pod)."""
        self.advance_rollout()
        self.pump_prefill()
        self.dispatch_handoffs()
        return self.pump_decode(k)

    # -- weight rollout ----------------------------------------------------

    def begin_weight_rollout(self, version: int, params) -> int:
        """Stage `params` as `version` on every pod and commit the idle
        ones immediately. In-flight streams FINISH on the version that
        prefilled them (a decode pod refuses the swap until it drains);
        new requests prefill — and therefore decode — at `version` as
        soon as pods commit. Returns pods committed so far; the rest
        land on subsequent `advance_rollout()` calls (step_all runs one
        every round)."""
        if version <= self.target_version:
            raise ValueError(
                f"weight rollout must move forward: got version "
                f"{version}, fleet target is {self.target_version}")
        self.target_version = version
        for pod in self.prefill_pods + self.decode_pods:
            pod.stage_params(version, params)
        return self.advance_rollout()

    def advance_rollout(self) -> int:
        """Commit any pod whose staged version can land now (decode pods
        drain first); publishes the per-pod kubedl_model_version gauge."""
        committed = 0
        for pod in self.prefill_pods + self.decode_pods:
            if pod.try_commit():
                committed += 1
                if self.job:
                    from kubedl_tpu_torch.weights.metrics import weights_metrics

                    weights_metrics.on_committed(
                        self.job, pod.name, pod.model_version)
        return committed

    def rollout_status(self) -> Dict:
        """Where the fleet is between versions: the push target and
        every pod's committed version (GET /serving/versions)."""
        pods = {p.name: p.model_version
                for p in self.prefill_pods + self.decode_pods}
        return {
            "target_version": self.target_version,
            "pods": pods,
            "pending": sorted(n for n, v in pods.items()
                              if v < self.target_version),
        }

    def serve_all(self, prompts, max_new_tokens: int, k: int = 8,
                  **kw) -> List[List[int]]:
        reqs = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        while not all(r.done for r in reqs):
            self.step_all(k)
        return [r.tokens for r in reqs]

    # -- health / drain ----------------------------------------------------

    def _find(self, name: str):
        for p in self.prefill_pods + self.decode_pods:
            if p.name == name:
                return p
        raise KeyError(f"unknown pod {name!r}")

    def drain(self, name: str, migrate: bool = True) -> int:
        """Stop routing new work to a pod. With migrate=True (the
        default) its in-flight/queued work re-routes immediately as
        continuations; otherwise a decode pod finishes its streams
        before the operator takes it down. Returns requests moved.

        Draining the LAST eligible prefill pod while requests are queued
        is refused (the pod keeps serving): stealing its queue with no
        re-route target would strand the requests undone and hang their
        clients forever."""
        pod = self._find(name)
        if isinstance(pod, PrefillPod) and pod.queue_len() and not [
            p for p in self._eligible(self.prefill_pods) if p is not pod
        ]:
            raise RuntimeError(
                f"cannot drain {name!r}: it is the last eligible prefill "
                f"pod and {pod.queue_len()} request(s) are queued")
        pod.draining = True
        moved = 0
        if isinstance(pod, PrefillPod):
            for req in pod.steal_queue():
                self.route_prefill().enqueue(req)
                moved += 1
        elif migrate:
            for req in pod.evict_all():
                self._resubmit(req)
                moved += 1
        return moved

    def fail(self, name: str) -> int:
        """Hard failure: the pod is gone; its device state with it. Every
        in-flight stream re-routes as a continuation. Queued requests of
        a failed prefill pod with NO eligible replacement fail LOUDLY
        (error + done) — silently dropping them would hang their clients
        forever on a done flag nobody will ever set."""
        pod = self._find(name)
        pod.healthy = False
        moved = 0
        if isinstance(pod, PrefillPod):
            stolen = pod.steal_queue()
            has_target = bool(self._eligible(self.prefill_pods))
            for req in stolen:
                if has_target:
                    self.route_prefill().enqueue(req)
                    moved += 1
                else:
                    req.error = (f"prefill pod {name!r} failed with no "
                                 f"eligible replacement")
                    req.done = True
                    req.finished_at = time.monotonic()
        else:
            for req in pod.evict_all():
                self._resubmit(req)
                moved += 1
        return moved

    def stats(self) -> Dict:
        return {
            "prefill_pods": [
                {"name": p.name, "queue": p.queue_len(),
                 "healthy": p.healthy, "draining": p.draining,
                 "model_version": p.model_version,
                 **p.engine.stats()}
                for p in self.prefill_pods],
            "decode_pods": [
                {"name": p.name, "blocks": p.blocks_outstanding(),
                 "free_slots": p.free_slots(),
                 "healthy": p.healthy, "draining": p.draining,
                 "model_version": p.model_version,
                 **p.engine.stats()}
                for p in self.decode_pods],
            "handoff_queue": len(self.handoffs),
            "handoffs_total": self.handoffs.put_count,
            "migrations": self.migrations,
            "serialized_bytes": self.serialized_bytes,
            "target_version": self.target_version,
        }


def adopt_weight_payload(router: ServingRouter, payload: bytes) -> int:
    """Turn a weight-tree delivery into a fleet rollout: the serving fleet
    rides the SAME distribution plane as the RL actors -- a relay node
    whose ``on_deliver`` is ``lambda p, v, s: adopt_weight_payload(router,
    p)`` makes the serving pods one more subtree of the broadcast. The
    record's leaves (JAX's flatten order, rl/weights.py) are copied into a
    fresh tree of the fleet's OWN param structure on its device; no tree
    travels."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.rl.weights import copy_leaves_into, decode_weights

    leaves, version, _step = decode_weights(payload)
    params = llama.tree_map(torch.empty_like, router.prefill_pods[0].engine.params)
    copy_leaves_into(params, leaves)
    router.begin_weight_rollout(version, params)
    return version
