"""The port's socket transport plane (kubedl_tpu_torch/transport/) on the
CPU: the plane cases of tests/test_transport.py -- framing (a message is
whole or absent, torn frames commit nothing), auth (bad or missing token
refused loudly), exactly-once under reconnect and resend, the boot-id
latch on both sides, heartbeats, `plane_from_env` -- plus the wire against
the JAX package's plane: a JAX plane and a port plane exchange messages in
both directions (byte-identical payloads, exactly once under drop and
resend, a restarted peer refused), and both metrics singletons render the
same /metrics text for the same events. The RL trajectory stream runs
exactly once over the port's channels. Every recv waits at most 10 s and
every plane is closed in the fixture's teardown."""
import json
import socket as pysocket
import struct
import time

import numpy as np
import pytest
import torch

from kubedl_tpu.transport import TransportPlane as JaxPlane
from kubedl_tpu.transport import transport_metrics as jax_metrics
from kubedl_tpu_torch.parallel.pipeline_mpmd import DirChannel
from kubedl_tpu_torch.rl.metrics import rl_metrics
from kubedl_tpu_torch.rl.trajectory import (
    Trajectory,
    TrajectoryConsumer,
    TrajectoryProducer,
    encode_trajectory,
)
from kubedl_tpu_torch.rl.wire import decode_arrays, encode_arrays
from kubedl_tpu_torch.transport import (
    TransportError,
    TransportPlane,
    plane_from_env,
    transport_metrics,
)

TOKEN = "test-job-token"
RECV_S = 10.0  # no recv in this file waits longer

# (listener package, dialer package): the port alone, and across the wire
# in both directions
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]
_KIND = {"port": TransportPlane, "jax": JaxPlane}


@pytest.fixture
def planes():
    """make(kind="port", **kw): a plane sharing one token; all closed
    after the test."""
    made = []

    def make(kind="port", **kw):
        kw.setdefault("token", TOKEN)
        p = _KIND[kind](**kw)
        made.append(p)
        return p

    try:
        yield make
    finally:
        for p in made:
            p.close()


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _bf16_record() -> bytearray:
    act = (torch.arange(64, dtype=torch.float32) / 9.0).to(torch.bfloat16).reshape(4, 16)
    return encode_arrays([("act", act), ("ids", np.arange(5, dtype=np.int32))],
                         meta={"mb": 0, "aux": 0.5})


# ---------------------------------------------------------------------------
# framing + payload parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("listener,dialer", PAIRS)
def test_payload_byte_identical_over_socket_and_dir(planes, tmp_path, listener, dialer):
    """An RL record with a bf16 array arrives byte for byte over a
    SocketChannel (either package on either end) and over a DirChannel:
    the plane carries the consumer's encoding opaquely."""
    wire = bytes(_bf16_record())
    a = planes(listener, service="recv")
    addr = a.listen("127.0.0.1:0")
    b = planes(dialer, service="send")
    b.channel("act0", peer_addr=addr).send("a1.0", wire)
    via_socket = a.recv("act0", "a1.0", timeout=RECV_S)
    dch = DirChannel(str(tmp_path / "edge"))
    dch.send("a1.0", wire)
    via_dir = dch.recv("a1.0", timeout=RECV_S)
    assert via_socket == wire == via_dir
    arrays, meta = decode_arrays(via_socket)
    assert arrays["act"].dtype == torch.bfloat16 and meta == {"mb": 0, "aux": 0.5}


@pytest.mark.parametrize("listener,dialer", PAIRS)
def test_large_payload(planes, listener, dialer):
    """A 9 MiB message survives intact."""
    a = planes(listener)
    addr = a.listen("127.0.0.1:0")
    b = planes(dialer)
    blob = np.random.default_rng(0).integers(0, 256, 9 * 2**20, dtype=np.uint8).tobytes()
    b.channel("act0", peer_addr=addr).send("big", blob)
    assert a.recv("act0", "big", timeout=RECV_S) == blob


def test_channel_poll_and_purge(planes):
    a = planes()
    addr = a.listen("127.0.0.1:0")
    b = planes()
    tx = b.channel("ctl", peer_addr=addr)
    tx.send("t1", b"one")
    tx.send("t2", b"two")
    rx = a.channel("ctl")
    assert rx.poll() == ("t1", b"one")  # insertion order
    assert rx.purge() == 1
    assert rx.poll() is None


def test_torn_frame_commits_nothing(planes):
    """A frame that stops mid-payload is dropped whole -- no partial
    message ever reaches an inbox -- and the plane keeps serving."""
    transport_metrics.reset()
    a = planes()
    addr = a.listen("127.0.0.1:0")
    host, _, port = addr.rpartition(":")
    raw = pysocket.create_connection((host, int(port)), timeout=5)
    hello = json.dumps({"token": TOKEN, "boot": "x"}).encode()
    raw.sendall(b"KDTP" + bytes([1]) + struct.pack(">I", len(hello)) + hello
                + struct.pack(">Q", 0))
    raw.recv(4096)  # WELCOME
    header = json.dumps({"channel": "act0", "tag": "torn", "boot": "x", "seq": 1}).encode()
    # claim a 1000-byte payload, deliver 10 bytes, die
    raw.sendall(b"KDTP" + bytes([3]) + struct.pack(">I", len(header))
                + header + struct.pack(">Q", 1000) + b"x" * 10)
    raw.close()
    assert _wait_for(lambda: transport_metrics.snapshot()["torn_frames_total"] >= 1)
    assert a.channel("act0").poll() is None  # nothing committed
    b = planes()
    b.channel("act0", peer_addr=addr).send("good", b"whole")
    assert a.recv("act0", "good", timeout=RECV_S) == b"whole"


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad_token", ["WRONG", ""])
@pytest.mark.parametrize("intruder_kind", ["port", "jax"])
def test_bad_or_missing_token_rejected_loudly(planes, bad_token, intruder_kind):
    """The port's listener refuses a wrong or empty token from either
    package's dialer: REJECT, a counter, nothing committed."""
    transport_metrics.reset()
    a = planes()
    addr = a.listen("127.0.0.1:0")
    intruder = planes(intruder_kind, token=bad_token)
    with pytest.raises(RuntimeError, match="rejected"):  # either TransportError
        intruder.channel("act0", peer_addr=addr).send("t", b"sneak")
    assert transport_metrics.snapshot()["auth_failures_total"] >= 1
    assert a.channel("act0").poll() is None


def test_port_dialer_refused_by_jax_listener_raises_transport_error(planes):
    a = planes("jax")
    addr = a.listen("127.0.0.1:0")
    with pytest.raises(TransportError, match="rejected"):
        planes(token="WRONG").channel("c", peer_addr=addr).send("t", b"x")


# ---------------------------------------------------------------------------
# reconnect + incarnations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("listener,dialer", PAIRS)
def test_connection_drop_resends_exactly_once(planes, listener, dialer):
    """A dropped connection reconnects with backoff and resends; the
    accept-side tag dedup makes delivery exactly once, across packages
    too."""
    a = planes(listener)
    addr = a.listen("127.0.0.1:0")
    b = planes(dialer, reconnect_budget_s=5)
    ch = b.channel("c", peer_addr=addr)
    ch.send("m1", b"one")
    b._peer(addr).sock.close()  # a network blip mid-stream
    ch.send("m2", b"two")
    ch.send("m2", b"two")  # an explicit resend: deduped, still ACKed
    assert a.recv("c", "m1", timeout=RECV_S) == b"one"
    assert a.recv("c", "m2", timeout=RECV_S) == b"two"
    with pytest.raises(TimeoutError):
        a.recv("c", "m2", timeout=0.2)  # no duplicate delivery
    metrics = transport_metrics if dialer == "port" else jax_metrics
    assert metrics.snapshot()["reconnects_total"] >= 1


@pytest.mark.parametrize("listener,dialer", PAIRS)
def test_restarted_sender_refused_by_receiver(planes, listener, dialer):
    """Receiver-side boot latch: a NEW sender incarnation's message is
    REJECTed (its send raises) and poisons the channel so recv fails loud
    too."""
    a = planes(listener)
    addr = a.listen("127.0.0.1:0")
    planes(dialer, service="sender-1").channel("c", peer_addr=addr).send("n1", b"x")
    assert a.recv("c", "n1", timeout=RECV_S) == b"x"
    b2 = planes(dialer, service="sender-2")  # the restart: fresh boot id
    with pytest.raises(RuntimeError, match="stale-incarnation"):
        b2.channel("c", peer_addr=addr).send("n2", b"y")
    with pytest.raises(RuntimeError, match="incarnation"):
        a.recv("c", "n2", timeout=RECV_S)


def _try_listen(plane, port) -> bool:
    try:
        plane.listen(f"127.0.0.1:{port}")
        return True
    except OSError:
        return False


def test_restarted_listener_refused_by_dialer(planes):
    """Dialer-side boot latch: reconnecting to a listener that came back
    as a NEW incarnation is refused (the WELCOME boot echo changed)."""
    a = planes()
    addr = a.listen("127.0.0.1:0")
    port = addr.rsplit(":", 1)[1]
    b = planes(reconnect_budget_s=5)
    ch = b.channel("c", peer_addr=addr)
    ch.send("m1", b"one")
    a.close()
    a2 = planes()
    assert _wait_for(lambda: _try_listen(a2, port), timeout=10), "could not rebind the port"
    with pytest.raises(TransportError, match="incarnation"):
        ch.send("m2", b"two")


def test_latch_false_tolerates_restarts(planes):
    a = planes(latch=False)
    addr = a.listen("127.0.0.1:0")
    planes(latch=False).channel("c", peer_addr=addr).send("n1", b"x")
    assert a.recv("c", "n1", timeout=RECV_S) == b"x"
    planes(latch=False).channel("c", peer_addr=addr).send("n2", b"y")
    assert a.recv("c", "n2", timeout=RECV_S) == b"y"


def test_heartbeats_flow(planes):
    transport_metrics.reset()
    a = planes("jax")  # the port's PINGs answered by a JAX listener
    addr = a.listen("127.0.0.1:0")
    b = planes(heartbeat_s=0.05)
    b.listen("127.0.0.1:0")  # the heartbeat thread rides the listen side
    b.channel("c", peer_addr=addr).send("t", b"x")
    assert _wait_for(lambda: transport_metrics.snapshot()["heartbeats_total"] >= 2)


def test_plane_from_env(planes):
    assert plane_from_env(env={"KUBEDL_TRANSPORT": "dir"}) is None
    # an empty token would be an UNAUTHENTICATED plane -- refused loudly
    with pytest.raises(ValueError, match="TOKEN"):
        plane_from_env(env={"KUBEDL_TRANSPORT": "socket"})
    env = {"KUBEDL_TRANSPORT": "socket", "KUBEDL_TRANSPORT_TOKEN": TOKEN,
           "KUBEDL_TRANSPORT_BIND": "127.0.0.1:0"}
    p = plane_from_env(service="t", env=env)
    try:
        assert p is not None and p.bound_addr.rsplit(":", 1)[1] != "0"
        planes("jax").channel("c", peer_addr=p.bound_addr).send("t", b"x")
        assert p.recv("c", "t", timeout=RECV_S) == b"x"
    finally:
        p.close()


# ---------------------------------------------------------------------------
# both directions over one pair, metrics text
# ---------------------------------------------------------------------------


def test_jax_and_port_planes_talk_both_ways(planes):
    """One JAX plane and one port plane, each listening and each dialing
    the other: messages flow in both directions, exactly once."""
    j = planes("jax", service="jax-side")
    p = planes(service="port-side")
    j_addr, p_addr = j.listen("127.0.0.1:0"), p.listen("127.0.0.1:0")
    for i in range(3):
        j.channel("up", peer_addr=p_addr).send(f"u{i}", f"to-port-{i}".encode())
        p.channel("down", peer_addr=j_addr).send(f"d{i}", f"to-jax-{i}".encode())
    assert [p.recv("up", f"u{i}", timeout=RECV_S) for i in range(3)] == \
        [f"to-port-{i}".encode() for i in range(3)]
    assert [j.recv("down", f"d{i}", timeout=RECV_S) for i in range(3)] == \
        [f"to-jax-{i}".encode() for i in range(3)]
    assert p.channel("up").poll() is None and j.channel("down").poll() is None


def test_metrics_text_equals_jax(planes):
    """The same events on a port pair and on a JAX pair: equal snapshots,
    so the operator's /metrics renders the same kubedl_transport_* text."""
    from kubedl_tpu.metrics.runtime_metrics import RuntimeMetrics

    texts = []
    for kind, metrics in (("port", transport_metrics), ("jax", jax_metrics)):
        metrics.reset()
        a = planes(kind)
        addr = a.listen("127.0.0.1:0")
        b = planes(kind)
        b.channel("act0", peer_addr=addr).send("t", b"payload")
        a.recv("act0", "t", timeout=RECV_S)
        with pytest.raises(RuntimeError):
            planes(kind, token="WRONG").channel("act0", peer_addr=addr).send("x", b"y")
        assert _wait_for(lambda m=metrics: m.snapshot()["auth_failures_total"] == 1)
        rm = RuntimeMetrics()
        rm.register_transport(metrics.snapshot)
        texts.append(rm.render())
    assert texts[0] == texts[1]
    assert 'kubedl_transport_messages_total{channel="act0",dir="recv"} 1' in texts[0]
    assert "kubedl_transport_auth_failures_total 1" in texts[0]


# ---------------------------------------------------------------------------
# the RL trajectory stream over the port's channels
# ---------------------------------------------------------------------------


def _traj(seed: int) -> Trajectory:
    rng = np.random.default_rng(seed)
    g, t = 4, 12
    return Trajectory(
        tokens=rng.integers(0, 100, (g, t)).astype(np.int32), prompt_len=5,
        seq_lens=np.full((g,), t, np.int32), rewards=rng.random(g).astype(np.float32),
        behavior_logprobs=-rng.random((g, t - 1)).astype(np.float32),
        weight_version=0, rollout_s=0.1, step_hint=seed)


def test_trajectory_exactly_once_under_reconnect_and_resend(planes):
    """tests/test_rl.py's exactly-once case on the port's channels:
    deterministic tags + ACK/dedup = exactly once. A duplicate resend
    (lost-ACK replay) is dropped, a dropped connection reconnects and the
    stream continues in per-actor order."""
    rl_metrics.reset()
    rx = planes(service="learner")
    addr = rx.listen("127.0.0.1:0")
    tx = planes(service="actor")
    ch = tx.channel("rl-traj.actor-0", peer_addr=addr)
    producer = TrajectoryProducer(ch, "actor-0", job="j")
    t1, t2, t3 = _traj(1), _traj(2), _traj(3)
    producer.send(t1)
    # lost-ACK replay: resend tag 1's exact bytes -- dedup, not dup
    tx.send(addr, "rl-traj.actor-0", "actor-0.00000001", encode_trajectory(t1))
    producer.send(t2)
    peer = tx._peer(addr)
    with peer.lock:
        peer._drop()  # a connection drop mid-stream
    producer.send(t3)
    consumer = TrajectoryConsumer({"actor-0": rx.channel("rl-traj.actor-0")}, job="j")
    got = [consumer.take(timeout=RECV_S) for _ in range(3)]
    assert [g.seq for g in got] == [1, 2, 3]
    np.testing.assert_array_equal(got[0].tokens, t1.tokens)
    assert consumer.take(timeout=0.2) is None  # the dup never lands
    assert rl_metrics.snapshot()["jobs"]["j"]["produced"] == 3
    rl_metrics.reset()
