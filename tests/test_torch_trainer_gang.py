"""kubedl_tpu_torch.train.trainer as a gang on the CPU: processes of
`python -m kubedl_tpu_torch.train.trainer --device cpu --model tiny`, one
rank each, forming their gloo group from the operator's env.

* On KUBEDL_MESH=fsdp=2,tensor=2 (4 processes) rank 0's losses equal a
  one-device step's on the same global batches (f32, 1e-5 relative), and
  the sharded checkpoints land in digit-named step directories;
* SIGTERM to one rank makes every rank save the same step and exit 113, and
  the rerun resumes from that sharded checkpoint and exits 0;
* on data=4 the ranks read the JAX package loader's rank-strided batch ids
  (step * 4 + rank): the losses equal a one-device step's on those rows;
* a JAXJob of 2 Workers on spec.mesh fsdp=2 running the port's trainer
  reaches Succeeded with the final step's sharded checkpoint.

The gang runs the tiny config in f32 (a wrapper swaps the dtype), so the
sharded and one-device losses can be held to 1e-5."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.native import loader as tloader
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.parallel.train_step import make_train_step
from kubedl_tpu_torch.utils import exit_codes
from torch_gang import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--model", "tiny", "--batch", "2", "--seq-len", "17"]
# the trainer with LlamaConfig.tiny in f32
F32_TRAINER = (
    "import sys, torch\n"
    "from kubedl_tpu_torch.models import llama\n"
    "tiny = llama.LlamaConfig.tiny\n"
    "llama.LlamaConfig.tiny = staticmethod(lambda **kw: tiny(**{'dtype': torch.float32, **kw}))\n"
    "from kubedl_tpu_torch.train import trainer\n"
    "sys.exit(trainer.main(sys.argv[1:]))\n")


def _steps(path):
    try:
        return sorted(int(d) for d in os.listdir(path) if d.isdigit())
    except OSError:
        return []


def _start(world, argv, mesh, trace_dir=None, port=None):
    port = port or free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", KUBEDL_MESH=mesh,
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KUBEDL_NUM_PROCESSES=str(world), KUBEDL_PROCESS_ID=str(rank),
                   POD_NAME=f"worker-{rank}")
        if trace_dir:
            env["KUBEDL_TRACE_DIR"] = str(trace_dir)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", F32_TRAINER, *argv], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, timeout=120):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _losses(trace_dir, pod="worker-0"):
    from kubedl_tpu.obs import load_spans

    spans = [s for s in load_spans(str(trace_dir)) if s["service"] == pod
             and s["name"] in ("train.compile", "train.step")]
    return [s["attrs"]["loss"] for s in sorted(spans, key=lambda s: s["attrs"]["step"])]


def _one_device_losses(global_batches):
    """The trainer's step on one device (seed-0 init, AdamW 3e-4, decay
    0.01) over the given global batches, in f32."""
    config = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init(config, torch.Generator().manual_seed(0), device="cpu")
    init_state, step = make_train_step(lambda p, b: llama.loss_fn(p, b, config),
                                       optim.adamw(3e-4, weight_decay=0.01))
    state = init_state(params)
    out = []
    for b in global_batches:
        state, m = step(state, torch.from_numpy(np.ascontiguousarray(b)))
        out.append(float(m["loss"]))
    return out


def _shard(tmp_path, n=6000, seed=0):
    path = str(tmp_path / "shard-0.bin")
    tloader.write_shard(path, np.random.default_rng(seed).integers(0, 256, n))
    return str(tmp_path / "shard-*.bin")


def test_fsdp_tensor_gang_trains_as_one_device_and_saves_sharded(tmp_path):
    data = _shard(tmp_path)
    ckpt, trace = tmp_path / "ckpt", tmp_path / "trace"
    rcs, outs = _finish(_start(4, TINY + ["--steps", "4", "--log-every", "2",
                                          "--data-path", data,
                                          "--checkpoint-path", str(ckpt),
                                          "--checkpoint-interval", "2"],
                               "fsdp=2,tensor=2", trace))
    assert rcs == [0] * 4, outs
    assert "mesh: {'data': 1, 'fsdp': 2, 'stage': 1, 'tensor': 2, 'context': 1, " \
           "'expert': 1} devices=4 model=tiny" in outs[0]
    assert "done: 4 steps" in outs[0] and "done:" not in outs[1]  # rank 0 prints
    assert _steps(ckpt) == [2, 4]
    assert os.path.isfile(ckpt / "4" / ".metadata")
    # tokens blocks over fsdp: rank (fsdp f, tensor t) reads id step * 2 + f
    loader = tloader.PyTokenLoader([str(tmp_path / "shard-0.bin")], batch=2, seq_len=17, seed=0)
    want = _one_device_losses([np.concatenate([loader.batch_at(s * 2 + f) for f in (0, 1)])
                               for s in range(4)])
    got = _losses(trace)
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sigterm_to_one_rank_saves_one_step_on_every_rank_then_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    argv = TINY + ["--log-every", "1000", "--checkpoint-path", ckpt,
                   "--checkpoint-interval", "5"]
    procs = _start(4, argv + ["--steps", "400"], "fsdp=2,tensor=2")
    try:
        deadline = time.monotonic() + 120
        while not _steps(ckpt) and all(p.poll() is None for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert all(p.poll() is None for p in procs) and _steps(ckpt), "no checkpoint"
        procs[1].send_signal(signal.SIGTERM)
        rcs, outs = _finish(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert rcs == [exit_codes.EXIT_TPU_PREEMPTED] * 4, outs
    at = _steps(ckpt)[-1]
    assert 5 <= at < 400
    assert f"saved final checkpoint at step {at}" in outs[0]
    assert "preempted: checkpoint saved, exiting retryable" in outs[0]
    assert os.path.isfile(os.path.join(ckpt, str(at), ".metadata"))
    rcs, outs = _finish(_start(4, argv + ["--steps", str(at + 2)], "fsdp=2,tensor=2"))
    assert rcs == [0] * 4, outs
    assert f"restored checkpoint at step {at}" in outs[0] and "done: 2 steps" in outs[0]
    assert _steps(ckpt)[-1] == at + 2


def test_data4_ranks_read_the_jax_loaders_rank_strided_ids(tmp_path):
    from kubedl_tpu.native import loader as jloader

    data = _shard(tmp_path, seed=3)
    trace = tmp_path / "trace"
    rcs, outs = _finish(_start(4, TINY + ["--steps", "3", "--log-every", "100",
                                          "--data-path", data], "data=4", trace))
    assert rcs == [0] * 4, outs
    ref = jloader.TokenLoader([str(tmp_path / "shard-0.bin")], batch=2, seq_len=17, seed=0,
                              n_threads=0)
    try:
        batches = [np.concatenate([ref.batch_at(s * 4 + p) for p in range(4)])
                   for s in range(3)]
    finally:
        ref.close()
    np.testing.assert_allclose(_losses(trace), _one_device_losses(batches), rtol=1e-5)


def test_two_worker_jaxjob_trains_the_port_on_an_fsdp_mesh(tmp_path):
    """The operator's env (KUBEDL_NUM_PROCESSES, KUBEDL_PROCESS_ID,
    KUBEDL_MESH from spec.mesh) forms the gang; the container sets the
    store address to loopback itself, so no service name is looked up."""
    from kubedl_tpu.operator import Operator, OperatorConfig
    from kubedl_tpu.workloads.jaxjob import JAXJobController

    steps, interval = 12, 4
    ckpt = str(tmp_path / "ckpt")
    op = Operator(OperatorConfig())
    op.register(JAXJobController())
    op.start()
    try:
        job = op.apply({
            "apiVersion": "kubedl-tpu.io/v1alpha1",
            "kind": "JAXJob",
            "metadata": {"name": "torch-gang-e2e"},
            "spec": {
                "mesh": {"fsdp": 2},
                "jaxReplicaSpecs": {"Worker": {
                    "replicas": 2,
                    "restartPolicy": "ExitCode",
                    "template": {"spec": {"containers": [{
                        "name": "jax",
                        "command": [
                            sys.executable, "-m", "kubedl_tpu_torch.train.trainer",
                            "--device", "cpu", "--model", "tiny", "--steps", str(steps),
                            "--batch", "2", "--seq-len", "17",
                            "--checkpoint-path", ckpt,
                            "--checkpoint-interval", str(interval),
                            "--log-every", "1000",
                        ],
                        "env": {"OMP_NUM_THREADS": "1",
                                "KUBEDL_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}"},
                    }]}},
                }},
            },
        })
        assert op.wait_for_condition(job, "Succeeded", timeout=120), (
            f"job did not succeed; checkpoints {_steps(ckpt)}")
    finally:
        op.stop()
    assert _steps(ckpt)[-1] == steps
    assert os.path.isfile(os.path.join(ckpt, str(steps), ".metadata"))


@pytest.mark.parametrize("world,mesh", [(2, "fsdp=4"), (4, "data=2,tensor=4")])
def test_a_mesh_unlike_the_gang_exits_2_before_the_rendezvous(world, mesh):
    rcs, outs = _finish(_start(world, TINY + ["--steps", "1"], mesh), timeout=60)
    assert rcs == [2] * world
    assert all("devices are visible" in o and "one device per process" in o for o in outs)
