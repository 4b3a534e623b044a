"""kubedl_tpu_torch.train.trainer on the CPU (--device cpu, LlamaConfig.tiny):
the printed lines, checkpoint interval, resume and pruning, the SIGTERM ->
checkpoint -> exit 113 contract in a subprocess and through the operator,
token shards bit-identical to the JAX package's loader, trace spans the
JAX package's readers load, the options the port refuses (and --lora-rank,
refused until it was ported, training), and meshes whose
size is not the gang's (exit 2). The trainer as a gang:
tests/test_torch_trainer_gang.py."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.native import loader as tloader
from kubedl_tpu_torch.train import checkpoint, trainer
from kubedl_tpu_torch.utils import exit_codes
from torch_gang import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--model", "tiny", "--batch", "2", "--seq-len", "17"]


def _steps(path):
    try:
        return sorted(int(d) for d in os.listdir(path) if d.isdigit())
    except OSError:
        return []


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def test_main_runs_and_prints_the_trainer_lines(capsys):
    rc = trainer.main(TINY + ["--steps", "4", "--log-every", "2", "--eval-every", "2",
                              "--eval-batches", "1", "--grad-clip", "1.0",
                              "--lr-schedule", "cosine", "--warmup-steps", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "mesh: {'data': 1, 'fsdp': 1, 'stage': 1, 'tensor': 1, 'context': 1, " \
           "'expert': 1} devices=1 model=tiny params≈2L/128d" in out
    for line in ("step 2: loss=", "step 4: loss=", "step/s=", "tok/s=",
                 "eval step 2: loss=", "(1 probe batches)", "done: 4 steps in"):
        assert line in out, line


def test_checkpoint_interval_resume_and_keep(tmp_path, capsys):
    """Token shards make each step's batch a function of the step, so a run
    checkpointed at 6 and resumed to 8 ends on the same parameters, bit for
    bit, as one run of 8; --checkpoint-keep 2 keeps the newest two."""
    shard = str(tmp_path / "shard-0.bin")
    tloader.write_shard(shard, np.random.default_rng(0).integers(0, 256, 5000))
    data = ["--data-path", str(tmp_path / "shard-*.bin"), "--log-every", "100"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    assert trainer.main(TINY + data + ["--steps", "8", "--checkpoint-path", straight]) == 0
    assert trainer.main(TINY + data + ["--steps", "6", "--checkpoint-path", resumed,
                                       "--checkpoint-interval", "2",
                                       "--checkpoint-keep", "2"]) == 0
    assert _steps(resumed) == [4, 6]
    capsys.readouterr()
    assert trainer.main(TINY + data + ["--steps", "8", "--checkpoint-path", resumed,
                                       "--checkpoint-interval", "2",
                                       "--checkpoint-keep", "2"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 6" in out and "done: 2 steps" in out
    assert "data: 1 shards" in out
    assert _steps(resumed) == [6, 8]
    a = torch.load(os.path.join(straight, "8", checkpoint.STATE_FILE), weights_only=True)
    b = torch.load(os.path.join(resumed, "8", checkpoint.STATE_FILE), weights_only=True)
    assert a["step"] == b["step"] == 8
    for x, y in zip(trainer_leaves(a["params"]), trainer_leaves(b["params"])):
        assert torch.equal(x, y)
    # KUBEDL_CHECKPOINT_RESTORE=0 starts fresh over an existing directory
    os.environ["KUBEDL_CHECKPOINT_RESTORE"] = "0"
    try:
        assert trainer.main(TINY + ["--steps", "1", "--checkpoint-path", resumed]) == 0
    finally:
        del os.environ["KUBEDL_CHECKPOINT_RESTORE"]
    assert "restored" not in capsys.readouterr().out


def trainer_leaves(tree):
    from kubedl_tpu_torch.models.llama import tree_leaves

    return list(tree_leaves(tree))


def test_sigterm_saves_then_exits_113(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.train.trainer", *TINY,
           "--steps", "400", "--log-every", "1000", "--checkpoint-path", ckpt,
           "--checkpoint-interval", "10"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not _steps(ckpt) and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        assert proc.poll() is None and _steps(ckpt), "no checkpoint before the end"
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == exit_codes.EXIT_TPU_PREEMPTED == 113
    assert exit_codes.is_retryable_exit_code(proc.returncode)
    at = _steps(ckpt)[-1]
    assert 10 <= at < 400
    assert f"saved final checkpoint at step {at}" in out
    assert "preempted: checkpoint saved, exiting retryable" in out
    # the resume path itself: test_checkpoint_interval_resume_and_keep and the
    # operator test below


def test_data_path_batches_equal_the_jax_loader(tmp_path):
    from kubedl_tpu.native import loader as jloader

    rng = np.random.default_rng(1)
    paths = []
    for i, n in enumerate((3000, 1234, 77)):
        paths.append(str(tmp_path / f"shard-{i}.bin"))
        tloader.write_shard(paths[-1], rng.integers(0, 32000, n))
    for seed in (0, 5):
        mine = tloader.PyTokenLoader(paths, batch=3, seq_len=33, seed=seed)
        ref_py = jloader.PyTokenLoader(paths, batch=3, seq_len=33, seed=seed)
        ref = jloader.TokenLoader(paths, batch=3, seq_len=33, seed=seed, n_threads=0)
        assert mine.n_windows == ref.n_windows
        for i in (0, 1, 7, 2**20, 123457):
            got = mine.batch_at(i)
            assert got.dtype == np.int32
            assert np.array_equal(got, ref_py.batch_at(i))
            assert np.array_equal(got, ref.batch_at(i))
        ref.close()


def test_spans_and_step_records_load_with_the_jax_readers(tmp_path, monkeypatch):
    from kubedl_tpu.obs import goodput, load_spans, load_step_records

    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("KUBEDL_TRACE_DIR", str(trace_dir))
    monkeypatch.setenv("KUBEDL_TRACE_ID", "abc123")
    monkeypatch.setenv("POD_NAME", "worker-0")
    ckpt = str(tmp_path / "ckpt")
    args = TINY + ["--log-every", "100", "--checkpoint-path", ckpt]
    assert trainer.main(args + ["--steps", "3"]) == 0
    assert trainer.main(args + ["--steps", "4"]) == 0
    spans = load_spans(str(trace_dir))
    names = [s["name"] for s in spans]
    for name in ("trainer.init", "train.compile", "train.step", "ckpt.save",
                 "ckpt.restore", "trainer.done"):
        assert name in names, name
    assert all(s["trace_id"] == "abc123" and s["service"] == "worker-0" for s in spans)
    steps = [s for s in spans if s["name"] in ("train.compile", "train.step")]
    assert [s["attrs"]["step"] for s in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(s["attrs"]["loss"]) for s in steps)
    report = goodput(spans)
    assert report["buckets"]["init_compile"] > 0 and report["buckets"]["checkpoint"] > 0
    recs = load_step_records(str(trace_dir / "worker-0.steps.jsonl"))
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert [r["compile"] for r in recs] == [True, False, False, True]


def test_profile_window_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert trainer.main(TINY + ["--steps", "3", "--log-every", "100", "--profile-dir",
                                str(prof), "--profile-steps", "1"]) == 0
    assert f"profile written to {prof}" in capsys.readouterr().out
    assert len(list(prof.glob("trace-*.json"))) == 1


# the last four: a mesh whose size is not the gang's (one device a
# process), refused before any rendezvous with build_mesh's messages.
# "lora" was refused until LoRA was ported, "hf_model" until Hugging Face
# import was, "live_reshard" until live reshard was; their cases now check
# that the same flags train (tests/test_torch_lora.py holds the step to
# JAX's; KUBEDL_LIVE_RESHARD=1 without a control endpoint trains to its
# end, as the reference does with no control channel, and
# tests/test_torch_reshard_trainer.py drives the resize ladder).
# "pp_stages" was refused until pipeline parallelism was ported; one
# process has a stage axis of 1, which the reference's message refuses
# (tests/test_torch_pipeline_trainer.py trains a stage mesh). "pp_mpmd"
# names the port's stage program.
REFUSED = {
    "lora": (["--lora-rank", "4"], {}),
    "hf_model": (["--hf-model", "/models/llama"], {}),
    "pp_stages": ([], {"KUBEDL_PP_STAGES": "2"}),
    "pp_mpmd": ([], {"KUBEDL_PP_MPMD": "1"}),
    "live_reshard": ([], {"KUBEDL_LIVE_RESHARD": "1"}),
    "processes": ([], {"KUBEDL_NUM_PROCESSES": "2", "KUBEDL_PROCESS_ID": "0",
                       "KUBEDL_MESH": "data=4"}),
    "mesh": ([], {"KUBEDL_MESH": "data=2"}),
    "mesh_fsdp": ([], {"KUBEDL_MESH": "data=-1,fsdp=4"}),
    "dcn_mesh": ([], {"KUBEDL_DCN_MESH": "data=2"}),
}
MISMATCH = {
    "processes": "multiply to 4, but 2 devices are visible",
    "mesh": "multiply to 2, but 1 devices are visible",
    "mesh_fsdp": "1 devices not divisible by fixed axes product 4",
    "dcn_mesh": "1 devices not divisible by DCN axes",
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_options_exit_2(name, monkeypatch, capsys, tmp_path):
    flags, env = REFUSED[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if name == "hf_model":  # a missing directory raises naming it; a real one trains
        pytest.importorskip("transformers")
        from hf_dirs import GEMMA2, save_hf

        with pytest.raises(FileNotFoundError, match="/models/llama"):
            trainer.main(TINY + ["--steps", "1"] + flags)
        save_hf(str(tmp_path), *GEMMA2)
        flags = ["--hf-model", str(tmp_path), "--lora-rank", "2"]
    rc = trainer.main(TINY + ["--steps", "1"] + flags)
    out, err = capsys.readouterr()
    if name == "lora":
        assert rc == 0 and "lora: rank 4, 16384 adapter params (4.54% of base)" in out
        return
    if name == "hf_model":
        assert rc == 0 and f"base weights: {tmp_path} (3L/64d)" in out
        assert f"model={tmp_path}" in out and "lora: rank 2" in out
        return
    if name == "live_reshard":
        assert rc == 0 and "done: 1 steps in" in out
        return
    assert rc == 2
    if name == "pp_mpmd":  # the JAX trainer's message: run the stage program
        assert "python -m kubedl_tpu_torch.train.pipeline_trainer" in err
    elif name == "pp_stages":
        assert ("KUBEDL_PP_STAGES=2 but the mesh stage axis is 1 (spec.mesh.stage "
                "must match spec.pipeline.stages)") in err
    else:
        assert MISMATCH[name] in err and "one device per process" in err


def test_out_of_memory_building_the_state_exits_114(monkeypatch, capsys):
    """A state that does not fit is permanent (EXIT_XLA_COMPILE_ERROR), as
    an XLA RESOURCE_EXHAUSTED is for the JAX trainer."""
    from kubedl_tpu_torch.models import llama

    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(llama, "init", oom)
    assert trainer.main(TINY + ["--steps", "1"]) == exit_codes.EXIT_XLA_COMPILE_ERROR == 114
    assert not exit_codes.is_retryable_exit_code(114)
    assert "compile/alloc failure" in capsys.readouterr().err


def test_a_one_device_mesh_is_accepted(monkeypatch):
    monkeypatch.setenv("KUBEDL_MESH", "data=-1,fsdp=1")
    assert trainer.mesh_from_env(1)["data"] == 1
    monkeypatch.setenv("KUBEDL_MESH", "data=-1")
    assert trainer.mesh_from_env(4)["data"] == 4  # -1 takes the whole gang
    monkeypatch.setenv("KUBEDL_MESH", "data=2,fsdp=4")
    with pytest.raises(ValueError, match="multiply to 8, but 4 devices are visible"):
        trainer.mesh_from_env(4)


def test_operator_preempts_and_resumes_the_port_trainer(tmp_path):
    """tests/test_preemption_resume.py with the port's trainer as the pod
    command: SIGTERM after the first interval checkpoint, the ExitCode
    restart policy brings the pod back, the job ends Succeeded with the
    final step's checkpoint."""
    from kubedl_tpu.operator import Operator, OperatorConfig
    from kubedl_tpu.workloads.jaxjob import JAXJobController

    steps, interval = 150, 5
    ckpt = str(tmp_path / "ckpt")
    op = Operator(OperatorConfig())
    op.register(JAXJobController())
    op.start()
    try:
        job = op.apply({
            "apiVersion": "kubedl-tpu.io/v1alpha1",
            "kind": "JAXJob",
            "metadata": {"name": "torch-preempt-e2e"},
            "spec": {
                "mesh": {"data": -1},
                "jaxReplicaSpecs": {"Worker": {
                    "replicas": 1,
                    "restartPolicy": "ExitCode",
                    "template": {"spec": {"containers": [{
                        # the JAXJob default container: its exit code drives the policy
                        "name": "jax",
                        "command": [
                            sys.executable, "-m", "kubedl_tpu_torch.train.trainer",
                            "--device", "cpu", "--model", "tiny", "--steps", str(steps),
                            "--batch", "4", "--seq-len", "33",
                            "--checkpoint-path", ckpt,
                            "--checkpoint-interval", str(interval),
                            "--log-every", "1000",
                        ],
                        # one OpenMP thread: the tiny model gains nothing from
                        # more, and a thread per core makes the pod crawl (7x
                        # measured) when other test workers load every core.
                        # The pod joins a group of one at the store address;
                        # loopback here, so no service name is looked up
                        "env": {"OMP_NUM_THREADS": "1",
                                "KUBEDL_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}"},
                    }]}},
                }},
            },
        })
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            s = _steps(ckpt)
            if s and s[-1] < steps:
                break
            time.sleep(0.02)
        else:
            pytest.fail("trainer never wrote an interval checkpoint")
        entry = next((e for key, e in list(op.executor._running.items())
                      if "torch-preempt-e2e" in key), None)
        assert entry is not None, "pod process not found"
        for proc in entry.procs.values():
            os.kill(proc.pid, signal.SIGTERM)
        assert op.wait_for_condition(job, "Succeeded", timeout=180), (
            f"job did not succeed after preemption; checkpoints {_steps(ckpt)}")
        assert op.metrics_registry.get("JAXJob").restarted >= 1
        assert _steps(ckpt)[-1] == steps
    finally:
        op.stop()
