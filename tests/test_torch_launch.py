"""kubedl_tpu_torch/train/launch.py on the CPU: two "pods" of
`python -m kubedl_tpu_torch.train.launch --device cpu --local-devices 2`,
each given the operator's env for a gang of two processes, form one gang
of four trainer processes (tests/torch_trainer_f32.py: LlamaConfig.tiny in
f32) on KUBEDL_MESH=data=2,context=2 — one process per local device and
context parallelism in one gang.

* Rank p * 2 + l reads, at step s, columns l of the rows the JAX trainer's
  process p reads (kubedl_tpu.native.loader TokenLoader.batch_at(s * 2 + p)),
  and rank 0's losses equal a one-device step's on those global batches
  (1e-5 relative);
* SIGTERM to one launcher makes every rank save the same step and exit
  113, both launchers exit 113, and the rerun resumes and exits 0;
* a child that dies takes the others down, and the launcher exits with its
  code; the children's env and the exit code's rule;
* the trainer exits 2 before any rendezvous when its positions do not
  split over the context axis, and ViT still refuses the axis;
* without --local-devices the launcher counts the cards through the CUDA
  driver, never importing torch."""
import os
import signal
import subprocess
import sys
import time

import numpy as np

from kubedl_tpu_torch.native import loader as tloader
from kubedl_tpu_torch.train import launch
from kubedl_tpu_torch.utils import exit_codes
from test_torch_trainer_gang import _losses, _one_device_losses, _shard, _steps
from torch_gang import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--model", "tiny", "--batch", "2", "--seq-len", "17"]
MESH = "data=2,context=2"


def _start(argv, port, trace_dir=None, record=None):
    """The two pods' launchers, each starting two trainer processes."""
    procs = []
    for pod in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", KUBEDL_MESH=MESH,
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests"),
                                               os.environ.get("PYTHONPATH", "")]),
                   KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KUBEDL_NUM_PROCESSES="2", KUBEDL_PROCESS_ID=str(pod),
                   POD_NAME=f"worker-{pod}")
        if trace_dir:
            env["KUBEDL_TRACE_DIR"] = str(trace_dir)
        if record:
            env["KUBEDL_TEST_BATCH_DIR"] = str(record)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubedl_tpu_torch.train.launch", "--device", "cpu",
             "--local-devices", "2", "--", "torch_trainer_f32", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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


def test_two_pods_of_two_train_on_data_context_as_one_device(tmp_path):
    from kubedl_tpu.native import loader as jloader

    data = _shard(tmp_path, seed=5)
    trace, record = tmp_path / "trace", tmp_path / "batches"
    record.mkdir()
    rcs, outs = _finish(_start(TINY + ["--steps", "3", "--log-every", "100",
                                       "--data-path", data], free_port(), trace, record))
    assert rcs == [0, 0], outs
    assert "mesh: {'data': 2, 'fsdp': 1, 'stage': 1, 'tensor': 1, 'context': 2, " \
           "'expert': 1} devices=4" in outs[0]
    ref = jloader.TokenLoader([str(tmp_path / "shard-0.bin")], batch=2, seq_len=17, seed=0,
                              n_threads=0)
    try:
        rows = [[ref.batch_at(s * 2 + p) for p in range(2)] for s in range(3)]
    finally:
        ref.close()
    # 16 positions over context 2: rank (pod p, child l) holds 8 of them and
    # the next token
    for pod in range(2):
        for l in range(2):
            for s in range(3):
                got = np.load(record / f"rank{pod * 2 + l}-{s}.npy")
                np.testing.assert_array_equal(got, rows[s][pod][:, l * 8:(l + 1) * 8 + 1])
    want = _one_device_losses([np.concatenate(r) for r in rows])
    np.testing.assert_allclose(_losses(trace), want, rtol=1e-5)


def test_sigterm_to_one_launcher_preempts_every_rank_then_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    argv = TINY + ["--log-every", "1000", "--checkpoint-path", ckpt,
                   "--checkpoint-interval", "5"]
    procs = _start(argv + ["--steps", "400"], free_port())
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
    assert rcs == [exit_codes.EXIT_TPU_PREEMPTED] * 2, outs
    for r in range(4):
        assert f"launch: rank {r} exited 113" in outs[r // 2], outs
    at = _steps(ckpt)[-1]
    assert 5 <= at < 400
    assert f"saved final checkpoint at step {at}" in outs[0]
    assert os.path.isfile(os.path.join(ckpt, str(at), ".metadata"))
    rcs, outs = _finish(_start(argv + ["--steps", str(at + 1)], free_port()))
    assert rcs == [0, 0], outs
    assert f"restored checkpoint at step {at}" in outs[0] and "done: 1 steps" in outs[0]


def test_child_envs_and_exit_codes():
    env = {"KUBEDL_COORDINATOR_ADDRESS": "10.0.0.1:8471", "KUBEDL_NUM_PROCESSES": "3",
           "KUBEDL_PROCESS_ID": "2", "CUDA_VISIBLE_DEVICES": "4,6"}
    got = [(e["KUBEDL_PROCESS_ID"], e["KUBEDL_NUM_PROCESSES"], e["CUDA_VISIBLE_DEVICES"],
            e["KUBEDL_COORDINATOR_ADDRESS"]) for e in launch.child_envs(2, "cuda", env)]
    assert got == [("4", "6", "4", "10.0.0.1:8471"), ("5", "6", "6", "10.0.0.1:8471")]
    cpu = launch.child_envs(2, "cpu", {"KUBEDL_NUM_PROCESSES": "1"})
    assert [e["KUBEDL_PROCESS_ID"] for e in cpu] == ["0", "1"]
    assert cpu[0]["KUBEDL_COORDINATOR_ADDRESS"].startswith("127.0.0.1:")  # a pod of one
    assert "CUDA_VISIBLE_DEVICES" not in cpu[0]
    assert launch.exit_code([0, 1, 113]) == 113  # any preempted child: retryable
    assert launch.exit_code([0, 3, -9]) == 3     # else the first failure
    assert launch.exit_code([-9, 0]) == 137
    assert launch.exit_code([0, 0]) == 0
    assert launch.parse_args(["--local-devices", "2", "--", "mod", "--x"]).command == \
        ["mod", "--x"]


def test_a_context_axis_the_sequence_cannot_split_exits_2(monkeypatch, capsys):
    """Before any rendezvous: the trainer's positions must split over the
    context axis; the programs without a sequence to split (ViT, the sparse
    model) still refuse the axis."""
    from kubedl_tpu_torch.train import trainer, vision

    for k, v in (("KUBEDL_MESH", "context=2"), ("KUBEDL_NUM_PROCESSES", "2"),
                 ("KUBEDL_PROCESS_ID", "0"), ("KUBEDL_COORDINATOR_ADDRESS", "127.0.0.1:1")):
        monkeypatch.setenv(k, v)
    assert trainer.main(TINY + ["--seq-len", "18", "--steps", "1"]) == 2
    assert "17 positions do not split over the mesh context axis (2)" in capsys.readouterr().err
    assert vision.main(["--device", "cpu", "--steps", "1"]) == 2
    assert "mesh context=2: context parallelism is not ported" in capsys.readouterr().err


def test_a_child_that_dies_takes_the_others_down(tmp_path):
    (tmp_path / "child_fails.py").write_text(
        "import os, sys, time\n"
        "if os.environ['KUBEDL_PROCESS_ID'] == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(120)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-m", "kubedl_tpu_torch.train.launch", "--device",
                          "cpu", "--local-devices", "2", "--", "child_fails"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 3, out.stderr
    assert "launch: rank 1 exited 3" in out.stderr and "launch: rank 0 exited -9" in out.stderr


def test_the_launcher_counts_cards_through_the_driver(monkeypatch, capsys):
    """Without --local-devices the launcher asks the CUDA driver for the
    count (torch is never imported for it); no driver means no card, and
    the launcher exits 2 before starting a child."""
    import ctypes

    code = ("import sys\nfrom kubedl_tpu_torch.train import launch\n"
            "launch.cuda_device_count()\nprint('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr

    class Driver:
        def cuInit(self, flags):
            return 0

        def cuDeviceGetCount(self, ref):
            ref._obj.value = 3
            return 0

    monkeypatch.setattr(ctypes, "CDLL", lambda name: Driver())
    assert launch.cuda_device_count() == 3

    def missing(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", missing)
    assert launch.cuda_device_count() == 0
    assert launch.main(["--", "kubedl_tpu_torch.train.trainer"]) == 2
    assert "no CUDA device is visible" in capsys.readouterr().err
