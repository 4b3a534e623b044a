"""The RL plane's wire in kubedl_tpu_torch (rl/wire.py, rl/trajectory.py,
rl/weights.py, parallel/pipeline_mpmd.py's channels) against the JAX
package's: records of the same arrays byte-identical (bf16 included), each
package decoding the other's, the refusals, the trajectory and weight
records (JAX's sorted leaf order), the broadcast/receive halves and the
channels' exactly-once delivery."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel import pipeline_mpmd as jmpmd
from kubedl_tpu.rl import trajectory as jtraj
from kubedl_tpu.rl import weights as jweights
from kubedl_tpu.rl import wire as jwire
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel.pipeline_mpmd import DirChannel, QueueChannel
from kubedl_tpu_torch.rl import metrics as tmetrics
from kubedl_tpu_torch.rl import trajectory, weights, wire
from kubedl_tpu_torch.utils.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_metrics():
    tmetrics.rl_metrics.reset()
    yield
    tmetrics.rl_metrics.reset()


def _mixed():
    """(numpy arrays for JAX, the same values as torch tensors)."""
    rng = np.random.default_rng(0)
    tokens = np.arange(12, dtype=np.int32).reshape(3, 4)
    rewards = np.linspace(-1, 1, 3).astype(np.float32)
    w = rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16)
    flag = np.array([True, False])
    scalar = np.float32(2.5).reshape(())
    ids = np.array([7, -3], np.int64)
    np_arrays = [("tokens", tokens), ("rewards", rewards), ("w", w), ("flag", flag),
                 ("scalar", scalar), ("ids", ids)]
    t_arrays = [("tokens", torch.from_numpy(tokens)), ("rewards", torch.from_numpy(rewards)),
                ("w", torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)),
                ("flag", torch.from_numpy(flag)), ("scalar", torch.tensor(2.5)),
                ("ids", torch.from_numpy(ids))]
    return np_arrays, t_arrays


def _raw(t):
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def test_records_byte_identical_and_cross_decoded():
    """torch tensors and numpy arrays encode to JAX's bytes; each package
    decodes the other's record, dtype for dtype, byte for byte."""
    np_arrays, t_arrays = _mixed()
    meta = {"v": 7, "actor": "a"}
    want = jwire.encode_arrays(np_arrays, meta=meta)
    assert bytes(wire.encode_arrays(t_arrays, meta=meta)) == want
    assert bytes(wire.encode_arrays(np_arrays, meta=meta)) == want
    got, m = wire.decode_arrays(want)
    assert m == meta and list(got) == [n for n, _ in np_arrays]
    for (name, a), (_, t) in zip(np_arrays, t_arrays):
        assert got[name].dtype == t.dtype and tuple(got[name].shape) == a.shape
        assert _raw(got[name]) == a.tobytes()
    back, m = jwire.decode_arrays(bytes(wire.encode_arrays(t_arrays, meta=meta)))
    assert m == meta
    for name, a in np_arrays:
        assert back[name].dtype == a.dtype and back[name].tobytes() == a.tobytes()


def test_bf16_decodes_without_ml_dtypes():
    """A bf16 record decodes in a process where ml_dtypes cannot import."""
    rec = jwire.encode_arrays([("w", np.arange(6, dtype=np.float32).astype(
        ml_dtypes.bfloat16))])
    code = ("import sys\nsys.modules['ml_dtypes'] = None\n"
            "from kubedl_tpu_torch.rl.wire import decode_arrays\n"
            f"out, _ = decode_arrays({bytes(rec)!r})\n"
            "print(out['w'].dtype, out['w'].float().tolist())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["torch.bfloat16", "[0.0,", "1.0,", "2.0,", "3.0,", "4.0,",
                                  "5.0]"]


@pytest.mark.parametrize("case", ["truncated", "trailing", "magic", "duplicate", "empty"])
def test_refusals_match_jax(case):
    np_arrays, t_arrays = _mixed()
    data = jwire.encode_arrays(np_arrays)
    calls = {
        "truncated": lambda m: m.decode_arrays(data[:-3]),
        "trailing": lambda m: m.decode_arrays(data + b"x"),
        "magic": lambda m: m.decode_arrays(b"nope" + data),
        "duplicate": lambda m: m.encode_arrays([("a", np.zeros(1)), ("a", np.zeros(1))]),
        "empty": lambda m: m.encode_arrays([]),
    }
    with pytest.raises(ValueError) as je:
        calls[case](jwire)
    with pytest.raises(ValueError) as te:
        calls[case](wire)
    assert str(te.value) == str(je.value)


def _jtraj(g=3, t=10, pl=4, version=5, seed=0):
    rng = np.random.default_rng(seed)
    return jtraj.Trajectory(
        tokens=rng.integers(1, 100, (g, t)).astype(np.int32), prompt_len=pl,
        seq_lens=np.full(g, t, np.int32), rewards=rng.normal(size=g).astype(np.float32),
        behavior_logprobs=rng.normal(size=(g, t - 1)).astype(np.float32),
        weight_version=version, actor="actor-1", seq=9, rollout_s=0.25, step_hint=3)


def test_trajectory_records_cross_packages():
    j = _jtraj()
    t = trajectory.Trajectory(
        tokens=j.tokens, prompt_len=j.prompt_len, seq_lens=j.seq_lens, rewards=j.rewards,
        behavior_logprobs=j.behavior_logprobs, weight_version=5, actor="actor-1", seq=9,
        rollout_s=0.25, step_hint=3)
    data = jtraj.encode_trajectory(j)
    assert bytes(trajectory.encode_trajectory(t)) == data
    back = trajectory.decode_trajectory(data)
    for f in ("prompt_len", "weight_version", "actor", "seq", "rollout_s", "step_hint"):
        assert getattr(back, f) == getattr(j, f)
    for f in ("tokens", "seq_lens", "rewards", "behavior_logprobs"):
        got, exp = getattr(back, f), getattr(j, f)
        assert got.dtype == exp.dtype and np.array_equal(got, exp)
    jback = jtraj.decode_trajectory(bytes(trajectory.encode_trajectory(back)))
    assert np.array_equal(jback.behavior_logprobs, j.behavior_logprobs)


@pytest.mark.parametrize("case", ["group", "grid", "prompt_len"])
def test_trajectory_shape_errors_match_jax(case):
    kw = dict(tokens=np.zeros((2, 8), np.int32), prompt_len=3, seq_lens=np.zeros(2, np.int32),
              rewards=np.zeros(2, np.float32), behavior_logprobs=np.zeros((2, 7), np.float32))
    kw.update({"group": dict(seq_lens=np.zeros(3, np.int32)),
               "grid": dict(behavior_logprobs=np.zeros((2, 8), np.float32)),
               "prompt_len": dict(prompt_len=8)}[case])
    with pytest.raises(ValueError) as je:
        jtraj.Trajectory(**kw)
    with pytest.raises(ValueError) as te:
        trajectory.Trajectory(**kw)
    assert str(te.value) == str(je.value)


def _ordered_like(tree, like):
    if isinstance(like, dict):
        return {k: _ordered_like(tree[k], like[k]) for k in like}
    if isinstance(like, list):
        return [_ordered_like(a, b) for a, b in zip(tree, like)]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_records_in_jax_leaf_order(dtype):
    """encode_weights of the converted params is JAX's record of the JAX
    params (dict keys sorted, not insertion order); decoded leaves go
    back into the port's tree bit for bit, and JAX decodes the port's."""
    jcfg = jllama.LlamaConfig.tiny(dtype=getattr(jnp, dtype), use_flash=False)
    jp = jax.device_get(jllama.init(jcfg, jax.random.PRNGKey(3)))
    # the converted tree in the insertion order of the port's own init
    like = llama.init(llama.LlamaConfig.tiny(), device="cpu")
    tp = _ordered_like(params_from_numpy(jp), like)
    assert list(tp) == ["embed", "layers", "final_norm", "lm_head"]
    want = jweights.encode_weights(jp, 4, step=9)
    got = weights.encode_weights(tp, 4, step=9)
    assert bytes(got) == want
    leaves, version, step = weights.decode_weights(want)
    assert (version, step) == (4, 9)
    fresh = llama.tree_map(torch.zeros_like, tp)
    weights.copy_leaves_into(fresh, leaves)
    for a, b in zip(llama.tree_leaves(fresh), llama.tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jleaves, _, _ = jweights.decode_weights(bytes(got))
    for a, b in zip(jleaves, jax.tree_util.tree_leaves(jp)):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="leaves"):
        weights.copy_leaves_into({"w": torch.zeros(2)}, leaves)


def test_weight_record_guards_match_jax():
    for bad in (({"w": np.ones(2)}, 0), ({}, 1)):
        with pytest.raises(ValueError) as je:
            jweights.encode_weights(*bad)
        with pytest.raises(ValueError) as te:
            weights.encode_weights(*bad)
        assert str(te.value) == str(je.value)
    data = jweights.encode_weights({"w": np.ones(2)}, 3, step=7)
    with pytest.raises(ValueError, match="truncated"):
        weights.decode_weights(data[:-1])


def test_broadcast_adopts_only_the_newest():
    """Two versions pending: the receiver adopts version 2 (one decode),
    then nothing; wait_for times out loudly past its budget."""
    params = {"embed": torch.arange(24, dtype=torch.float32).reshape(4, 6).bfloat16(),
              "layers": [{"w": torch.ones(2, 3)}, {"w": torch.full((2, 3), 0.5)}]}
    ch = QueueChannel()
    caster = weights.WeightBroadcaster([ch])
    caster.publish(params, step=1)
    doubled = llama.tree_map(lambda t: t * 2, params)
    assert caster.publish(doubled, step=2)[0] == 2
    assert caster.bytes_encoded_total == 2 * caster.last_payload_bytes
    rx = weights.WeightReceiver(ch)
    leaves, version, step = rx.poll(timeout=1.0)
    assert (version, step) == (2, 2) and rx.version == 2
    for got, exp in zip(leaves, weights.sorted_leaves(doubled)):
        assert got.dtype == exp.dtype and torch.equal(got, exp)
    assert rx.poll(timeout=0.05) is None
    with pytest.raises(TimeoutError, match="version 3"):
        rx.wait_for(3, timeout=0.1)


@pytest.mark.parametrize("kind", ["queue", "dir"])
def test_channels_exactly_once(kind, tmp_path):
    """Each tag is delivered once; QueueChannel refuses a queued duplicate
    as JAX's does; a DirChannel message crosses instances (processes) and
    purge() drops what is pending."""
    if kind == "queue":
        tx = rx = QueueChannel()
        jch = jmpmd.QueueChannel()
    else:
        tx, rx = DirChannel(str(tmp_path / "d")), DirChannel(str(tmp_path / "d"))
    tx.send("a.00000001", b"one")
    tx.send("a.00000002", bytearray(b"two"))
    if kind == "queue":
        with pytest.raises(ValueError) as te:
            tx.send("a.00000001", b"again")
        jch.send("a.00000001", b"x")
        with pytest.raises(ValueError) as je:
            jch.send("a.00000001", b"x")
        assert str(te.value) == str(je.value)
    assert bytes(rx.recv("a.00000001", timeout=1.0)) == b"one"
    with pytest.raises(TimeoutError):
        rx.recv("a.00000001", timeout=0.05)
    if kind == "dir":
        # the JAX package's DirChannel reads the port's file under the same name
        assert jmpmd.DirChannel(str(tmp_path / "d")).recv("a.00000002", timeout=1.0) == b"two"
        tx.send("a/b c", b"odd")  # unsafe tag characters become '_'
        assert os.path.exists(tmp_path / "d" / "a_b_c.msg")
        assert rx.purge() == 1 and rx.purge() == 0
        assert not [f for f in os.listdir(tmp_path / "d") if ".tmp." in f]
    else:
        assert rx.recv("a.00000002", timeout=1.0) == bytearray(b"two")


def test_producer_consumer_round_robin_and_metrics():
    """Tags {actor}.{seq:08d}; the consumer takes round-robin across actors,
    in order within each; the counters agree with JAX's on the same
    sequence of events."""
    from kubedl_tpu.rl.metrics import rl_metrics as jm

    a, b = QueueChannel(), QueueChannel()
    pa = trajectory.TrajectoryProducer(a, "actor-0", job="j")
    pb = trajectory.TrajectoryProducer(b, "actor-1", job="j")
    for s in (1, 2):
        j = _jtraj(seed=s)
        for p in (pa, pb):
            p.send(trajectory.decode_trajectory(jtraj.encode_trajectory(j)))
    consumer = trajectory.TrajectoryConsumer({"actor-1": b, "actor-0": a}, job="j")
    got = [consumer.take(timeout=1.0) for _ in range(4)]
    assert [(g.actor, g.seq) for g in got] == [("actor-0", 1), ("actor-1", 1),
                                               ("actor-0", 2), ("actor-1", 2)]
    assert consumer.take(timeout=0.05) is None
    jm.reset()
    for _ in range(4):
        jm.on_produced("j")
    tm = tmetrics.rl_metrics
    tm.on_consumed("j", weight_lag=1)
    tm.on_stale_dropped("j", weight_lag=3)
    jm.on_consumed("j", weight_lag=1)
    jm.on_stale_dropped("j", weight_lag=3)
    for m in (tm, jm):
        m.on_weights_published("j", 2)
        m.observe_learn("j", 0.5, 1.25)
    assert tm.snapshot() == jm.snapshot()
    jm.reset()
