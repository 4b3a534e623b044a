"""The port's dpo and evaluate programs as gloo gangs of 2 on fsdp=2 (one
device a process, the rows split over the token blocks, the weights
sharded), held to the same program run once in this process at the gang's
global batch: every DPO step's loss and metrics within 1e-4 relative, and
evaluate's token count equal with its NLL within 1e-4. Both sides run
LlamaConfig.tiny in f32 (tests/torch_post_training_f32.py in the gang).
Then a DPO gang checkpointing through the sharded CheckpointManager: SIGTERM
to rank 1 stops both ranks at one step with exit 113, and a rerun restores
that step and ends on the straight run's losses."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.native.loader import write_shard
from kubedl_tpu_torch.train import dpo, evaluate, grpo, preference
from torch_gang import ROOT, free_port

REL = 1e-4
MESH = "fsdp=2"
DPO_ARGS = ["--model", "tiny", "--batch", "4", "--seq-len", "24", "--lr", "1e-3",
            "--log-every", "1"]


def _start(program, argv, tmp, tag, env=None):
    """A gang of 2 of `program` under the f32 wrapper; (processes, log paths)."""
    port = free_port()
    logs = [str(tmp / f"{tag}-rank{r}.log") for r in range(2)]
    tests = os.path.join(ROOT, "tests")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_post_training_f32", program, *argv, "--device", "cpu"],
        cwd=ROOT, stdout=open(logs[r], "w"), stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + tests,
                 KUBEDL_MESH=MESH, KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 KUBEDL_NUM_PROCESSES="2", KUBEDL_PROCESS_ID=str(r), **(env or {})))
        for r in range(2)]
    return procs, logs


def _wait(procs, logs, timeout=180):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], [open(x).read() for x in logs]


def _metrics(path, rank=0):
    with open(f"{path}.rank{rank}") as f:
        return [json.loads(line) for line in f]


@pytest.fixture
def f32(monkeypatch):
    """LlamaConfig.tiny in f32 for this process's runs; every DPO step's
    metrics recorded."""
    tiny = llama.LlamaConfig.tiny
    monkeypatch.setattr(llama.LlamaConfig, "tiny",
                        staticmethod(lambda **kw: tiny(**{"dtype": torch.float32, **kw})))
    seen = []
    make = preference.make_dpo_step

    def recording(*a, **kw):
        init, ref_fn, step = make(*a, **kw)

        def recorded(state, batch):
            state, m = step(state, batch)
            seen.append({k: float(v) for k, v in m.items()})
            return state, m
        return init, ref_fn, recorded
    monkeypatch.setattr(preference, "make_dpo_step", recording)
    for name in ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES", "KUBEDL_MESH"):
        monkeypatch.delenv(name, raising=False)
    return seen


def _close(got, want):
    assert abs(got - want) <= REL * max(abs(want), 1e-3), (got, want)


def test_dpo_and_evaluate_gangs_equal_one_process_at_the_global_batch(tmp_path, f32, capsys):
    rng = np.random.default_rng(0)
    for i in range(2):
        write_shard(str(tmp_path / f"shard-{i}.bin"), rng.integers(1, 256, 400))
    eval_args = ["--model", "tiny", "--allow-fresh-init", "--seq-len", "33", "--log-every", "0",
                 "--data-path", str(tmp_path / "shard-*.bin")]
    dpo_steps = DPO_ARGS + ["--steps", "3"]
    d_procs, d_logs = _start("dpo", dpo_steps, tmp_path, "dpo",
                             {"KUBEDL_TEST_METRICS": str(tmp_path / "dpo.jsonl")})
    e_procs, e_logs = _start("evaluate", eval_args + ["--batch", "2"], tmp_path, "eval")

    # meanwhile, each program once at the gang's global batch
    assert dpo.main(dpo_steps + ["--device", "cpu"]) == 0
    want_dpo = list(f32)
    assert evaluate.main(eval_args + ["--batch", "4", "--device", "cpu"]) == 0
    want_eval = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    rcs, texts = _wait(d_procs + e_procs, d_logs + e_logs)
    assert rcs == [0, 0, 0, 0], texts
    for r, text in enumerate(texts):
        assert f"process {r % 2}/2: process group backend gloo" in text
    # every rank computes the global metrics; rank 0 prints
    got = [_metrics(tmp_path / "dpo.jsonl", r) for r in range(2)]
    assert got[0] == got[1]
    assert len(got[0]) == len(want_dpo) == 3
    for g, w in zip(got[0], want_dpo):
        for k in ("loss", "grad_norm", "reward_margin", "preference_accuracy"):
            _close(g[k], w[k])
    assert "step 3: loss=" in texts[0] and "step 3:" not in texts[1]
    line = json.loads(texts[2].strip().splitlines()[-1])
    assert "eval_perplexity" not in texts[3]
    assert line["tokens"] == want_eval["tokens"] > 0
    assert abs(line["nll"] - want_eval["nll"]) <= REL, (line, want_eval)


def test_dpo_gang_resumes_from_its_sharded_checkpoint(tmp_path):
    """SIGTERM to rank 1 once rank 0 has printed step 2: both ranks save
    one step through DCP and exit 113; the rerun restores that step and
    its losses equal the straight run's."""
    ckpt = str(tmp_path / "ckpt")
    argv = DPO_ARGS + ["--steps", "10", "--checkpoint-path", ckpt]
    straight = _start("dpo", DPO_ARGS + ["--steps", "10"], tmp_path, "straight",
                      {"KUBEDL_TEST_METRICS": str(tmp_path / "straight.jsonl")})
    procs, logs = _start("dpo", argv, tmp_path, "cut",
                         {"KUBEDL_TEST_METRICS": str(tmp_path / "cut.jsonl")})
    deadline = time.monotonic() + 120
    while "step 2:" not in open(logs[0]).read():
        assert time.monotonic() < deadline and procs[0].poll() is None, open(logs[0]).read()
        time.sleep(0.05)
    procs[1].send_signal(signal.SIGTERM)
    rcs, texts = _wait(procs, logs)
    assert rcs == [113, 113], texts
    stopped = len(_metrics(tmp_path / "cut.jsonl"))
    assert 2 <= stopped < 10
    assert f"preempted at step {stopped}: saved policy checkpoint; exit 113" in texts[0]

    procs, logs = _start("dpo", argv, tmp_path, "resumed",
                         {"KUBEDL_TEST_METRICS": str(tmp_path / "resumed.jsonl")})
    rcs, texts = _wait(procs, logs)
    assert rcs == [0, 0], texts
    assert f"restored policy checkpoint at step {stopped}" in texts[0]
    rcs, _ = _wait(*straight)
    assert rcs == [0, 0]
    want = [m["loss"] for m in _metrics(tmp_path / "straight.jsonl")]
    got = [m["loss"] for name in ("cut", "resumed")
           for m in _metrics(tmp_path / f"{name}.jsonl")]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("program,argv", [
    (dpo, ["--batch", "3"]),
    (grpo, ["--prompts-per-step", "3", "--group-size", "3"]),
])
def test_rows_that_do_not_split_over_the_token_blocks_exit_2(program, argv, monkeypatch,
                                                              capsys):
    """A gang of 2 on data=2 whose global batch is odd exits 2 on every rank
    before the rendezvous, with the reason."""
    monkeypatch.setenv("KUBEDL_NUM_PROCESSES", "2")
    monkeypatch.setenv("KUBEDL_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("KUBEDL_MESH", "data=2")
    assert program.main(["--device", "cpu", "--model", "tiny"] + argv) == 2
    assert "do not split over the mesh's 2 token blocks" in capsys.readouterr().err
