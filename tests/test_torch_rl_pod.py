"""The port's RL fleet pod entry point (kubedl_tpu_torch/train/rl_pod.py) on
the CPU: the roleless and invalid-config refusals; the socket lane's
channels from the injected env and its refusals (no learner address, an
actor address list of the wrong length, no token); the injected fleet
shape validated with the JAX package's messages (api/validation.py
against kubedl_tpu's over the spec.rl validation matrix); an actor and a
learner as two processes on the dir lane at `tiny`, their spans under one
trace id, and over loopback sockets with the serving rollout engine;
SIGTERM to the learner -> a checkpoint and exit 113, and the rerun
resumes from it; the purge of a crashed incarnation's messages."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from kubedl_tpu.api import validation as jvalidation
from kubedl_tpu.train import rl_pod as jrl_pod
from kubedl_tpu_torch.api import validation
from kubedl_tpu_torch.train import rl_pod
from kubedl_tpu_torch.utils import exit_codes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_ENV = ("KUBEDL_RL_ACTORS", "KUBEDL_RL_ACTOR_INDEX", "KUBEDL_RL_GROUP_SIZE",
             "KUBEDL_RL_PROMPTS_PER_STEP", "KUBEDL_RL_MAX_NEW_TOKENS", "KUBEDL_RL_TEMPERATURE",
             "KUBEDL_RL_MAX_WEIGHT_LAG", "KUBEDL_RL_BROADCAST_INTERVAL", "KUBEDL_RL_REWARD",
             "KUBEDL_RL_EOS_ID", "KUBEDL_RL_ENGINE", "KUBEDL_TRANSPORT", "KUBEDL_RL_ROLE")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in FLEET_ENV:
        monkeypatch.delenv(k, raising=False)


def test_roleless_invocation_exits_2(capsys):
    assert rl_pod.main([]) == 2
    assert "KUBEDL_RL_ROLE must be actor|learner" in capsys.readouterr().err


@pytest.mark.parametrize("env,want", [
    ({"KUBEDL_RL_GROUP_SIZE": "1"}, "rl config invalid: KUBEDL_RL.groupSize"),
    ({"KUBEDL_RL_ENGINE": "vllm"}, "rl config invalid: KUBEDL_RL.rolloutEngine"),
])
def test_refusals_exit_2(monkeypatch, capsys, env, want):
    monkeypatch.setenv("KUBEDL_RL_ROLE", "actor")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert rl_pod.main(["--device", "cpu"]) == 2
    assert want in capsys.readouterr().err


def test_serving_engine_and_socket_transport_accepted(monkeypatch):
    """KUBEDL_RL_ENGINE=serving and KUBEDL_TRANSPORT=socket pass the env
    config as the JAX pod's do."""
    monkeypatch.setenv("KUBEDL_RL_ENGINE", "serving")
    monkeypatch.setenv("KUBEDL_TRANSPORT", "socket")
    cfg = rl_pod._rl_env_config(rl_pod.parse_args([]))
    assert cfg == jrl_pod._rl_env_config(jrl_pod.parse_args([]))
    assert cfg["engine"] == "serving"


SOCKET_ENV = {"KUBEDL_TRANSPORT": "socket", "KUBEDL_TRANSPORT_TOKEN": "tok",
              "KUBEDL_TRANSPORT_BIND": "127.0.0.1:0"}


@pytest.mark.parametrize("role,env,match", [
    ("actor", {}, "KUBEDL_RL_LEARNER_ADDR"),
    ("learner", {"KUBEDL_RL_ACTOR_ADDRS": "127.0.0.1:1"}, "has 1 entries for 2 actors"),
    ("learner", {}, "has 0 entries for 2 actors"),
    ("actor", {"KUBEDL_RL_LEARNER_ADDR": "127.0.0.1:1", "KUBEDL_TRANSPORT_TOKEN": ""},
     "KUBEDL_TRANSPORT_TOKEN"),
])
def test_socket_lane_refusals(role, env, match):
    ids = ["actor-0"] if role == "actor" else ["actor-0", "actor-1"]
    with pytest.raises(ValueError, match=match):
        rl_pod.channels_from_env(role, ids, env={**SOCKET_ENV, **env})


def test_socket_lane_channels():
    """The socket lane: the actor sends trajectories to the learner's
    address and receives weights on its own plane; the learner receives
    each actor's trajectories and dials every actor's address. The
    channel names are the JAX pod's, so either package's pod can sit on
    either end."""
    from kubedl_tpu_torch.transport import SocketChannel, TransportPlane

    plane, traj, weights = rl_pod.channels_from_env(
        "actor", ["actor-0"], env={**SOCKET_ENV, "KUBEDL_RL_LEARNER_ADDR": "10.0.0.1:7000",
                                   "POD_NAME": "rl-actor-0"})
    try:
        assert isinstance(plane, TransportPlane) and plane.bound_addr
        assert plane.service == "rl-actor-0"
        assert isinstance(traj, SocketChannel) and isinstance(weights, SocketChannel)
        assert (traj.name, traj.peer_addr) == ("rl-traj.actor-0", "10.0.0.1:7000")
        assert (weights.name, weights.peer_addr) == ("rl-weights", "")
    finally:
        plane.close()
    plane, traj, weights = rl_pod.channels_from_env(
        "learner", ["actor-0", "actor-1"],
        env={**SOCKET_ENV, "KUBEDL_RL_ACTOR_ADDRS": "10.0.0.2:1,10.0.0.3:2"})
    try:
        assert plane.service == "rl-learner"
        assert {a: c.name for a, c in traj.items()} == {
            "actor-0": "rl-traj.actor-0", "actor-1": "rl-traj.actor-1"}
        assert [(w.name, w.peer_addr) for w in weights] == [
            ("rl-weights", "10.0.0.2:1"), ("rl-weights", "10.0.0.3:2")]
    finally:
        plane.close()
    plane, traj, weights = rl_pod.channels_from_env(
        "actor", ["actor-0"], env={"KUBEDL_RL_QUEUE_DIR": "/nonexistent-q"})
    assert plane is None


# the shape cases of tests/test_rl.py's spec.rl validation matrix, as the
# operator injects them into the pod's env (2 actors, lag 1 as its baseline)
ENV_CASES = [
    {},
    {"KUBEDL_RL_GROUP_SIZE": "1"},
    {"KUBEDL_RL_MAX_WEIGHT_LAG": "-1"},
    {"KUBEDL_RL_TEMPERATURE": "0.0"},
    {"KUBEDL_RL_REWARD": "nope"},
    {"KUBEDL_RL_REWARD": "length"},
    {"KUBEDL_RL_REWARD": "length", "KUBEDL_RL_EOS_ID": "2"},
    {"KUBEDL_RL_REWARD": "mod.path:fn"},
    {"KUBEDL_RL_ENGINE": "vllm"},
    {"KUBEDL_RL_BROADCAST_INTERVAL": "5"},
    {"KUBEDL_RL_BROADCAST_INTERVAL": "4"},
    {"KUBEDL_RL_BROADCAST_INTERVAL": "0"},
    {"KUBEDL_RL_ACTORS": "1", "KUBEDL_RL_MAX_WEIGHT_LAG": "0",
     "KUBEDL_RL_BROADCAST_INTERVAL": "2"},
    {"KUBEDL_RL_ACTORS": "0", "KUBEDL_RL_PROMPTS_PER_STEP": "0",
     "KUBEDL_RL_MAX_NEW_TOKENS": "0"},
]


@pytest.mark.parametrize("case", range(len(ENV_CASES)))
def test_env_config_errors_equal_jax(monkeypatch, case):
    env = {"KUBEDL_RL_ACTORS": "2", "KUBEDL_RL_GROUP_SIZE": "4",
           "KUBEDL_RL_MAX_WEIGHT_LAG": "1", **ENV_CASES[case]}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    results = []
    for mod in (jrl_pod, rl_pod):
        args = mod.parse_args([])
        try:
            results.append(("ok", mod._rl_env_config(args)))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[1] == results[0]
    if case in (1, 2, 3, 4, 5, 8, 9, 11, 12, 13):
        assert results[1][0] == "error"


def test_validate_rl_shapes_equal_jax():
    grid = [dict(actor_replicas=a, learner_replicas=lr_, group_size=g, max_weight_lag=lag,
                 broadcast_interval=bi, reward=rw, eos_id=eos, rollout_engine=eng)
            for a in (0, 1, 3) for lr_ in (1, 2) for g in (1, 4) for lag in (-1, 0, 2)
            for bi in (1, 7) for rw, eos in (("token-match", -1), ("length", -1), ("x:y", 0))
            for eng in ("decode", "serving", "vllm")]
    for kw in grid:
        assert validation.validate_rl_shapes(**kw) == jvalidation.validate_rl_shapes(**kw)
    assert validation.RL_REWARDS == jvalidation.RL_REWARDS
    assert validation.RL_ROLLOUT_ENGINES == jvalidation.RL_ROLLOUT_ENGINES


def test_dir_lane_purges_stale_incarnation_messages(tmp_path):
    """Each side purges the dirs it RECEIVES on, never its peer's inbox."""
    root = tmp_path / "q"
    for d in ("traj-actor-0", "weights-actor-0"):
        (root / d).mkdir(parents=True)
    (root / "traj-actor-0" / "actor-0.00000001.msg").write_bytes(b"stale")
    (root / "weights-actor-0" / "w.00000001.msg").write_bytes(b"stale")
    env = {"KUBEDL_RL_QUEUE_DIR": str(root)}
    rl_pod.channels_from_env("learner", ["actor-0"], env=env)
    assert not list((root / "traj-actor-0").glob("*.msg"))
    assert list((root / "weights-actor-0").glob("*.msg"))
    rl_pod.channels_from_env("actor", ["actor-0"], env=env)
    assert not list((root / "weights-actor-0").glob("*.msg"))
    with pytest.raises(ValueError, match="KUBEDL_RL_QUEUE_DIR"):
        rl_pod.channels_from_env("actor", ["actor-0"], env={})


def _pod(role, tmp_path, steps, trace_id="rl-trace", **extra):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               KUBEDL_RL_ROLE=role, KUBEDL_RL_QUEUE_DIR=str(tmp_path / "q"),
               KUBEDL_RL_GROUP_SIZE="2", KUBEDL_RL_PROMPTS_PER_STEP="2",
               KUBEDL_RL_MAX_NEW_TOKENS="4", KUBEDL_RL_MAX_WEIGHT_LAG="1",
               KUBEDL_TRACE_DIR=str(tmp_path / "trace"), KUBEDL_TRACE_ID=trace_id,
               POD_NAME=f"rl-{role}", OMP_NUM_THREADS="1")
    for k in ("KUBEDL_TRANSPORT", "KUBEDL_RL_ENGINE", "KUBEDL_RL_ACTORS"):
        env.pop(k, None)
    env.update(extra)
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.train.rl_pod", "--device", "cpu",
           "--model", "tiny", "--steps", str(steps), "--log-every", "1", "--lr", "1e-4",
           "--checkpoint-path", str(tmp_path / "ckpt")]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait_for(proc, text, timeout=120):
    deadline, seen = time.monotonic() + timeout, []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        if text in line:
            return "".join(seen)
    raise AssertionError(f"{text!r} never printed:\n{''.join(seen)}")


def _fleet(tmp_path, steps):
    """A learner, then (once it has purged its inbox and is waiting) an
    actor: (learner, actor, the learner's output so far)."""
    learner = _pod("learner", tmp_path, steps)
    try:
        head = _wait_for(learner, f"learner: {steps} updates over 1 actors")
    except BaseException:
        learner.kill()
        learner.wait()
        raise
    return learner, _pod("actor", tmp_path, steps), head


def _finish(*procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_fleet_on_the_dir_lane(tmp_path):
    """An actor and a learner process, 3 learner steps: every group is
    consumed once and none is stale, the lag stays within 1, the actor
    ends on the learner's last version, the learner checkpoints, and both
    processes' rl.* spans carry the one trace id."""
    learner, actor, head = _fleet(tmp_path, 3)
    lout, aout = _finish(learner, actor)
    lout = head + lout
    assert (learner.returncode, actor.returncode) == (0, 0), lout + aout
    assert "consumed=6 stale_dropped=0" in lout and "published_version=3" in lout
    assert "max_weight_lag_observed=" in lout and "max_weight_lag_observed=2" not in lout
    assert "final weight version 3 (step 3)" in aout
    assert sorted(os.listdir(tmp_path / "ckpt" / "learner")) == ["3"]
    spans = []
    for name in os.listdir(tmp_path / "trace"):
        with open(tmp_path / "trace" / name) as f:
            spans += [json.loads(line) for line in f]
    rl_spans = [s for s in spans if s["name"].startswith("rl.")]
    assert {s["service"] for s in rl_spans} == {"rl-actor", "rl-learner"}
    assert {s["trace_id"] for s in spans} == {"rl-trace"}
    assert {"rl.rollout", "rl.learn", "rl.weight_sync"} <= {s["name"] for s in rl_spans}


def test_sigterm_learner_checkpoints_exits_113_and_resumes(tmp_path):
    """SIGTERM reaches the learner while it waits for its first groups; it
    finishes that step, saves it and exits 113 (retryable). The rerun
    gang restores step 1, runs steps 2-4 and exits 0 on both roles."""
    learner = _pod("learner", tmp_path, 4)
    actor = None
    try:
        head = _wait_for(learner, "learner: 4 updates over 1 actors")
        learner.send_signal(signal.SIGTERM)
        actor = _pod("actor", tmp_path, 4)
        lout = head + learner.communicate(timeout=240)[0]
    finally:
        for p in (learner, actor):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    assert learner.returncode == exit_codes.EXIT_TPU_PREEMPTED == 113, lout
    assert "learner: preempted at step 1; exiting retryable" in lout
    assert "saved policy checkpoint at step 1" in lout
    assert sorted(os.listdir(tmp_path / "ckpt" / "learner")) == ["1"]
    learner, actor, head = _fleet(tmp_path, 4)
    lout, aout = _finish(learner, actor)
    lout = head + lout
    assert (learner.returncode, actor.returncode) == (0, 0), lout + aout
    assert "learner: restored policy checkpoint at step 1" in lout
    assert "learner: done — 3 steps" in lout and "consumed=6" in lout
    assert "final weight version 3 (step 4)" in aout
    assert sorted(os.listdir(tmp_path / "ckpt" / "learner")) == ["1", "4"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_fleet_over_sockets_with_the_serving_engine(tmp_path):
    """The kube-mode lane: KUBEDL_TRANSPORT=socket with one shared token,
    the actor dialing the learner's address and the learner the actor's,
    and the actor rolling out through the paged serving plane
    (KUBEDL_RL_ENGINE=serving). 3 learner steps: every group consumed
    once, none stale, the actor ends on the learner's last version."""
    l_addr, a_addr = f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"
    common = dict(KUBEDL_TRANSPORT="socket", KUBEDL_TRANSPORT_TOKEN="fleet-tok",
                  KUBEDL_RL_ENGINE="serving", KUBEDL_RL_MAX_NEW_TOKENS="16",
                  KUBEDL_RL_LEARNER_ADDR=l_addr, KUBEDL_RL_ACTOR_ADDRS=a_addr)
    learner = _pod("learner", tmp_path, 3, KUBEDL_TRANSPORT_BIND=l_addr, **common)
    actor = _pod("actor", tmp_path, 3, KUBEDL_TRANSPORT_BIND=a_addr, **common)
    lout, aout = _finish(learner, actor)
    assert (learner.returncode, actor.returncode) == (0, 0), lout + aout
    assert "consumed=6 stale_dropped=0" in lout and "published_version=3" in lout
    assert "engine=serving" in aout and "final weight version 3 (step 3)" in aout
    assert not (tmp_path / "q").exists()  # nothing rode the dir lane
