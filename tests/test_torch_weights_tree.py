"""The port's weight-distribution plane (kubedl_tpu_torch/weights/) against
the JAX package's: build_tree's permutation, parents, children and seed
digest over an (n, fanout) grid; the announce and manifest records byte
for byte, each package's relay verifying the other's; every pod
committing the same bytes; a tampered chunk or a mismatched manifest never
adopted; a dead interior node's subtree re-parenting to the root; and a
3-actor RL fleet on the tree equal to hub-and-spoke."""
import dataclasses
import hashlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.weights import dist as jdist
from kubedl_tpu.weights import tree as jtree
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel.pipeline_mpmd import QueueChannel
from kubedl_tpu_torch.rl.actor import ActorConfig
from kubedl_tpu_torch.rl.fleet import RLFleet
from kubedl_tpu_torch.rl.learner import LearnerConfig
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy
from kubedl_tpu_torch.weights import dist, tree
from kubedl_tpu_torch.weights.metrics import weights_metrics


@pytest.fixture(autouse=True)
def _reset_metrics():
    weights_metrics.reset()
    yield
    weights_metrics.reset()


@pytest.mark.parametrize("n,fanout", [(1, 4), (2, 1), (3, 2), (7, 2), (16, 4), (64, 4),
                                      (65, 4), (100, 3)])
def test_build_tree_equals_jax(n, fanout):
    pods = [f"pod-{i:03d}" for i in range(n)]
    for version in (1, 2, 17):
        want = jtree.build_tree(pods, version, fanout)
        got = tree.build_tree(list(reversed(pods)), version, fanout)
        assert got.order == want.order and got.fanout == want.fanout
        assert tree._seed(sorted(pods), version) == jtree._seed(sorted(pods), version)
        assert got.children(tree.ROOT) == want.children(jtree.ROOT)
        for p in pods:
            assert got.parent(p) == want.parent(p) and got.children(p) == want.children(p)
        assert got.max_depth() == want.max_depth() and got.interior() == want.interior()


def test_tree_refusals_equal_jax():
    for args in ((["a"], 0), (["a"], 1, 0), ([], 1), (["a", "a"], 1), (["a", ""], 1)):
        with pytest.raises(ValueError) as je:
            jtree.build_tree(*args)
        with pytest.raises(ValueError) as te:
            tree.build_tree(*args)
        assert str(te.value) == str(je.value)
    spec = tree.build_tree(["a", "b"], 1)
    assert tree.validate_tree(spec, ["a", "c"]) == jtree.validate_tree(
        jtree.build_tree(["a", "b"], 1), ["a", "c"])


def test_announce_and_manifest_records_equal_jax():
    payload = np.random.default_rng(0).bytes(300)
    spec_t, spec_j = tree.build_tree(["a", "b", "c"], 2, 2), jtree.build_tree(["a", "b", "c"], 2, 2)
    chunks = dist.chunk_payload(payload, 64)
    assert chunks == jdist.chunk_payload(payload, 64)
    sha = hashlib.sha256(payload).hexdigest()
    ann = dist.encode_announce(spec_t, 5, 64, chunks, sha, len(payload), "j")
    assert ann == jdist.encode_announce(spec_j, 5, 64, chunks, sha, len(payload), "j")
    assert dist.encode_manifest(2, 5, sha, 300) == jdist.encode_manifest(2, 5, sha, 300)
    assert dist.decode_announce(ann).spec.order == spec_j.order
    assert (dist.announce_tag(2), dist.chunk_tag(2, 3), dist.manifest_tag(2)) == (
        jdist.announce_tag(2), jdist.chunk_tag(2, 3), jdist.manifest_tag(2))


def _harness(n, fanout=2, chunk_bytes=64, dead=(), chunk_timeout=0.3):
    """N relay pods over QueueChannels under one RootDistributor; a pod in
    `dead` gets an inbox but no relay thread."""
    pods = [f"pod-{i:02d}" for i in range(n)]
    inboxes = {p: QueueChannel() for p in pods}
    control = QueueChannel()
    delivered, relays = {}, {}
    for p in pods:
        if p in dead:
            continue

        def deliver(payload, version, step, _p=p):
            delivered.setdefault(_p, []).append(
                (hashlib.sha256(payload).hexdigest(), version, step))

        relays[p] = dist.RelayNode(pod=p, recv=inboxes[p], child_channel=inboxes.__getitem__,
                                   control=control, on_deliver=deliver, job="j",
                                   chunk_timeout=chunk_timeout, repair_timeout=5.0)
    root = dist.RootDistributor(pods, inboxes, control, job="j", fanout=fanout,
                                chunk_bytes=chunk_bytes)
    return pods, root, relays, delivered


def _pump(relays, stop):
    errs = []

    def run(node):
        try:
            node.run(stop, poll_timeout=0.05)
        except BaseException as e:  # noqa: BLE001 — asserted by the caller
            errs.append((node.pod, e))

    threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in relays.values()]
    for t in threads:
        t.start()
    return threads, errs


@pytest.mark.parametrize("dead", [False, True])
def test_distribute_commits_the_same_bytes(dead):
    """9 pods at fanout 2: every pod adopts both versions byte-identical,
    no node sends more than fanout copies; with an interior pod dead, its
    subtree re-parents to the root and commits, and the distributor names
    only the dead pod."""
    payload = np.random.default_rng(3).bytes(900)
    victim = ()
    if dead:
        spec = tree.build_tree([f"pod-{i:02d}" for i in range(9)], 1, 2)
        victim = (spec.children(tree.ROOT)[0],)
        assert spec.children(victim[0])
    pods, root, relays, delivered = _harness(9, dead=victim)
    stop = threading.Event()
    threads, errs = _pump(relays, stop)
    try:
        if dead:
            with pytest.raises(dist.WeightsError) as ei:
                root.distribute(payload, version=1, timeout=4.0)
            assert victim[0] in str(ei.value)
        else:
            report = root.distribute(payload, version=1, step=7, timeout=20.0)
            assert sorted(report["committed"]) == pods and report["reparented"] == []
            root.distribute(payload, version=2, step=8, timeout=20.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
    assert not errs
    src = hashlib.sha256(payload).hexdigest()
    snap = weights_metrics.snapshot()["jobs"]["j"]
    if dead:
        live = [p for p in pods if p not in victim]
        assert {p: delivered[p] for p in live} == {p: [(src, 1, 0)] for p in live}
        assert victim[0] not in delivered and root.reparents >= 1 and snap["reparents"] >= 1
    else:
        assert delivered == {p: [(src, 1, 7), (src, 2, 8)] for p in pods}
        assert snap["pods"] == {p: 2 for p in pods} and snap["versions_published"] == 2
        assert max(snap["node_bytes"].values()) <= 2 * 2 * len(payload)


@pytest.mark.parametrize("fault", ["chunk", "manifest"])
def test_tampered_version_never_adopted(fault):
    """A chunk whose sha disagrees with the announce, or a manifest that
    does not match the assembled bytes, is refused: nothing adopted,
    nothing acknowledged, no manifest passed on. The announce and chunks
    here are the JAX package's records."""
    payload = np.random.default_rng(1).bytes(300)
    chunks = jdist.chunk_payload(payload, 100)
    spec = jtree.build_tree(["a", "b"], version=1, fanout=1)
    first, second = spec.order
    inboxes = {p: QueueChannel() for p in ("a", "b")}
    control, adopted = QueueChannel(), []
    node = dist.RelayNode(pod=first, recv=inboxes[first], child_channel=inboxes.__getitem__,
                          control=control, on_deliver=lambda *a: adopted.append(a),
                          chunk_timeout=0.1, repair_timeout=0.1)
    sha = hashlib.sha256(payload).hexdigest()
    ch = inboxes[first]
    ch.send(dist.announce_tag(1), jdist.encode_announce(spec, 0, 100, chunks, sha,
                                                        len(payload), "j"))
    sent = list(chunks)
    if fault == "chunk":
        evil = bytearray(chunks[1])
        evil[0] ^= 0xFF
        sent[1] = bytes(evil)
    for i, c in enumerate(sent):
        ch.send(dist.chunk_tag(1, i), c)
    ch.send(dist.manifest_tag(1), jdist.encode_manifest(
        1, 3, sha if fault == "chunk" else "f" * 64, len(payload)))
    with pytest.raises(dist.WeightsError, match="refused"):
        node.poll(timeout=1.0)
    assert adopted == [] and node.version == 0
    with pytest.raises(TimeoutError):
        control.recv(f"ok.00000001.{first}", timeout=0.0)
    with pytest.raises(TimeoutError):
        inboxes[second].recv(dist.manifest_tag(1), timeout=0.0)


def _token5_reward(prompt, completion):
    return float(sum(1 for t in completion if t == 5))


def test_three_actor_fleet_on_the_tree_equals_hub_and_spoke():
    """3 lockstep actors (one group each) feeding a learner of 3 groups a
    step: past two actors the fleet picks the tree by itself; its losses,
    final parameters and adopted versions equal the hub-and-spoke run bit
    for bit, each version serialized once and committed by every actor."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jp = jax.device_get(jllama.init(jcfg, jax.random.PRNGKey(0)))
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, tcfg.vocab_size, 6)) for _ in range(8)]

    def run(use_tree):
        weights_metrics.reset()
        fleet = RLFleet(
            params_from_numpy(jp), tcfg, prompts, _token5_reward,
            ActorConfig(seed=0, group_size=2, prompts_per_step=1, max_new_tokens=4,
                        max_weight_lag=0, lockstep=True),
            LearnerConfig(prompts_per_step=3, group_size=2, max_weight_lag=0,
                          take_timeout_s=60.0),
            n_actors=3, use_weight_tree=use_tree, weight_fanout=2)
        losses = []
        fleet.run(2, on_step=lambda s, m: losses.append(m["loss"]))
        return fleet, losses, weights_metrics.snapshot()

    hub, hub_losses, _ = run(False)
    auto, auto_losses, snap = run(None)
    assert hub.distributor is None and auto.use_weight_tree and len(auto.relays) == 3
    assert auto_losses == hub_losses
    for a, b in zip(llama.tree_leaves(hub.learner.state.params),
                    llama.tree_leaves(auto.learner.state.params)):
        assert torch.equal(a, b)
    for h, t in zip(hub.actors, auto.actors):
        assert h.receiver.version == t.receiver.version == 1
        for a, b in zip(llama.tree_leaves(h.params), llama.tree_leaves(t.params)):
            assert torch.equal(a, b)
    assert set(snap["jobs"]["rl"]["pods"]) == {a.cfg.actor_id for a in auto.actors}
    for b in (hub.learner.broadcaster, auto.learner.broadcaster):
        assert b.bytes_encoded_total == b.version * b.last_payload_bytes
