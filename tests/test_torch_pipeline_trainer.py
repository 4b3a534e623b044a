"""The MPMD stage trainer (kubedl_tpu_torch.train.pipeline_trainer) as two
processes on the CPU, one a stage, and the SPMD trainer on a stage mesh.

* two `pipeline_trainer --device cpu` processes at tiny train 3 steps over
  the DirChannel transport and over the socket plane; both exit 0 with
  stage-0/ and stage-1/ checkpoints, and the last stage prints the same
  losses on both transports (the boundary bytes are transport-opaque);
* SIGTERM to both stages mid-run: both exit 113 with a checkpoint at the
  same step, and the rerun restores that step on both and exits 0;
* `_common_restore_step` against the reference's on the same directories;
* `runtime_from_env` purges a dead incarnation's message and keeps one
  written after the process started;
* `trainer` with KUBEDL_PP_STAGES=2 and KUBEDL_MESH=stage=2 on a gloo gang
  of 2 trains and prints the bubble line, and refuses one microbatch for
  two stages with the reference's message."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel import optim, pipeline_mpmd
from kubedl_tpu_torch.train import pipeline_runtime
from kubedl_tpu_torch.train.pipeline_trainer import _common_restore_step
from kubedl_tpu_torch.utils import exit_codes
from torch_gang import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMD = [sys.executable, "-m", "kubedl_tpu_torch.train.pipeline_trainer", "--device", "cpu",
       "--model", "tiny", "--batch", "8", "--seq-len", "33", "--log-every", "1"]


def _stage_envs(tmp, transport):
    base = dict(os.environ, OMP_NUM_THREADS="1", KUBEDL_PP_STAGES="2",
                KUBEDL_PP_MICROBATCHES="4",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    extra = [{}, {}]
    if transport == "dir":
        base["KUBEDL_PP_BOUNDARY_DIR"] = str(tmp / "boundary")
    else:
        ports = [free_port(), free_port()]
        base.update(KUBEDL_TRANSPORT="socket", KUBEDL_TRANSPORT_TOKEN="pp-test-token")
        extra = [{"KUBEDL_TRANSPORT_BIND": f"127.0.0.1:{ports[0]}",
                  "KUBEDL_PP_NEXT_ADDR": f"127.0.0.1:{ports[1]}"},
                 {"KUBEDL_TRANSPORT_BIND": f"127.0.0.1:{ports[1]}",
                  "KUBEDL_PP_PREV_ADDR": f"127.0.0.1:{ports[0]}"}]
    return [dict(base, KUBEDL_PP_STAGE=str(s), **extra[s]) for s in range(2)]


def _start(envs, argv, logs):
    return [subprocess.Popen(CMD + argv, cwd=ROOT, env=env, stdout=open(log, "w"),
                             stderr=subprocess.STDOUT) for env, log in zip(envs, logs)]


def _finish(procs, logs, timeout=180):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], [open(log).read() for log in logs]


def _steps(path):
    try:
        return sorted(int(d) for d in os.listdir(path) if d.isdigit())
    except OSError:
        return []


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for transport in ("dir", "socket"):
        tmp = tmp_path_factory.mktemp(transport)
        ckpt = tmp / "ckpt"
        logs = [tmp / "stage0.log", tmp / "stage1.log"]
        procs = _start(_stage_envs(tmp, transport),
                       ["--steps", "3", "--checkpoint-path", str(ckpt)], logs)
        out[transport] = _finish(procs, logs) + (ckpt,)
    return out


@pytest.mark.parametrize("transport", ["dir", "socket"])
def test_two_stage_processes_train(transport, runs):
    rcs, outs, ckpt = runs[transport]
    assert rcs == [0, 0], outs
    assert "stage 0/2: layers (0, 1) of 2, microbatches=4, endpoint (drives data)" in outs[0]
    assert "stage 1: done at step 3" in outs[1] and "stage 0: done at step 3" in outs[0]
    losses = re.findall(r"step \d+: loss=([0-9.]+) step_s=[0-9.]+ wait_s=[0-9.]+", outs[1])
    assert len(losses) == 3 and all(np.isfinite(float(x)) for x in losses)
    assert "loss=" not in outs[0]  # the last stage reports the loss
    assert _steps(ckpt / "stage-0") == _steps(ckpt / "stage-1") == [3]


def test_both_transports_give_the_same_losses(runs):
    got = {t: re.findall(r"loss=([0-9.]+)", runs[t][1][1]) for t in runs}
    assert got["dir"] == got["socket"] and len(got["dir"]) == 3, got


@pytest.mark.parametrize("transport", ["dir"])
def test_sigterm_stops_both_stages_at_one_step_and_resumes(tmp_path, transport):
    ckpt = tmp_path / "ckpt"
    envs = _stage_envs(tmp_path, transport)
    logs = [tmp_path / "s0.log", tmp_path / "s1.log"]
    procs = _start(envs, ["--steps", "100000", "--checkpoint-path", str(ckpt)], logs)
    try:
        deadline = time.monotonic() + 120
        while "step 3:" not in open(logs[1]).read():
            assert time.monotonic() < deadline and procs[1].poll() is None, open(logs[1]).read()
            time.sleep(0.05)
        for p in procs:
            p.send_signal(signal.SIGTERM)
    finally:
        rcs, outs = _finish(procs, logs)
    assert rcs == [exit_codes.EXIT_TPU_PREEMPTED] * 2 == [113, 113], outs
    saved = [re.findall(r"stage \d: saved final checkpoint at step (\d+)", o) for o in outs]
    assert saved[0] == saved[1] and len(saved[0]) == 1, outs
    n = int(saved[0][0])
    assert n >= 4 and _steps(ckpt / "stage-0")[-1] == _steps(ckpt / "stage-1")[-1] == n
    assert _common_restore_step(str(ckpt), 2) == n
    logs = [tmp_path / "r0.log", tmp_path / "r1.log"]
    rcs, outs = _finish(_start(envs, ["--steps", str(n + 2), "--checkpoint-path",
                                      str(ckpt)], logs), logs)
    assert rcs == [0, 0], outs
    for s in range(2):
        assert f"stage {s}: restored gang-common checkpoint at step {n}" in outs[s]
        assert f"stage {s}: done at step {n + 2}" in outs[s]
    assert re.findall(r"step (\d+): loss=", outs[1]) == [str(n), str(n + 1)]


def test_common_restore_step_matches_the_reference(tmp_path):
    from kubedl_tpu.train.pipeline_trainer import _common_restore_step as reference

    for s, steps in ((0, (80, 90, 100)), (1, (70, 80, 90))):
        for st in steps:
            (tmp_path / f"stage-{s}" / str(st)).mkdir(parents=True)
    (tmp_path / "stage-1" / ".tmp-100-7").mkdir()  # a save in flight is no step
    for n_stages, want in ((2, 90), (1, 100), (3, None)):
        assert _common_restore_step(str(tmp_path), n_stages) == want
        assert reference(str(tmp_path), n_stages) == want


def test_runtime_from_env_purges_stale_messages(tmp_path, capsys):
    config = llama.LlamaConfig.tiny(n_layers=4)
    params = llama.init(config, device="cpu")
    edge = pipeline_mpmd.DirChannel(str(tmp_path / "pp" / "act0"))
    edge.send("a7.0", pipeline_mpmd.encode_boundary([np.zeros((2,), np.float32)],
                                                    meta={"boot": "dead"}))
    started = time.time() + 0.01
    time.sleep(0.05)
    edge.send("a1.0", pipeline_mpmd.encode_boundary([np.zeros((2,), np.float32)],
                                                    meta={"boot": "alive"}))
    env = {"KUBEDL_PP_STAGE": "1", "KUBEDL_PP_STAGES": "2",
           "KUBEDL_PP_MICROBATCHES": "4", "KUBEDL_PP_BOUNDARY_DIR": str(tmp_path / "pp")}
    rt = pipeline_runtime.runtime_from_env(config, params, optim.sgd(0.0), env=env,
                                           started_at=started)
    try:
        left = sorted(f for f in os.listdir(tmp_path / "pp" / "act0") if f.endswith(".msg"))
        assert left == ["a1.0.msg"]
        assert "stage 1: purged 1 stale boundary message(s)" in capsys.readouterr().out
        assert rt.plan.layer_range(1) == (2, 4) and len(rt.params["layers"]) == 2
    finally:
        rt.close()
    rt = pipeline_runtime.runtime_from_env(config, params, optim.sgd(0.0), env=env)
    rt.close()  # without a start time every pending message goes
    assert not [f for f in os.listdir(tmp_path / "pp" / "act0") if f.endswith(".msg")]
    with pytest.raises(ValueError, match="KUBEDL_PP_BOUNDARY_DIR is required"):
        pipeline_runtime.runtime_from_env(config, params, optim.sgd(0.0),
                                          env=dict(env, KUBEDL_PP_BOUNDARY_DIR=""))
    with pytest.raises(ValueError, match="KUBEDL_PP_PREV_ADDR/NEXT_ADDR"):
        pipeline_runtime.runtime_from_env(config, params, optim.sgd(0.0),
                                          env=dict(env, KUBEDL_TRANSPORT="socket"))


def _spmd_trainer(micro):
    """The SPMD trainer as a gloo gang of 2 on KUBEDL_MESH=stage=2."""
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", KUBEDL_MESH="stage=2",
                   KUBEDL_PP_STAGES="2", KUBEDL_PP_MICROBATCHES=str(micro),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KUBEDL_NUM_PROCESSES="2", KUBEDL_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubedl_tpu_torch.train.trainer", "--device", "cpu",
             "--model", "tiny", "--steps", "2", "--batch", "8", "--seq-len", "33",
             "--log-every", "1"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def test_spmd_trainer_trains_a_stage_mesh():
    rcs, outs = _spmd_trainer(4)
    assert rcs == [0, 0], outs
    assert "pipeline: 1f1b stages=2 microbatches=4 interleave=1 (bubble 0.200)" in outs[0]
    losses = re.findall(r"step \d+: loss=([0-9.]+)", outs[0])
    assert len(losses) == 2 and all(np.isfinite(float(x)) for x in losses)


def test_spmd_trainer_refuses_too_few_microbatches():
    """The reference's message, on every rank: fewer microbatches than
    stages can never fill the pipeline."""
    rcs, outs = _spmd_trainer(1)
    assert rcs == [2, 2], outs
    assert all("pipeline config invalid: spec.pipeline.microbatches: need >= stages (2) "
               "to fill the pipeline, got 1" in o for o in outs)
