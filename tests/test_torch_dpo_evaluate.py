"""The port's dpo and evaluate workloads (kubedl_tpu_torch/train/dpo.py,
evaluate.py) on the CPU: evaluate's JSON line against the JAX workload's on
the same Hugging Face directory (bf16, synthetic batches and token shards:
NLL within 1e-4, the same token count); dpo on id-list and text JSONL
(text pairs equal to JAX's load_pairs through the same tokenizer, the first
step at the DPO fixed point), a run cut at step 2 and resumed equal bit for
bit to one run straight through, its checkpoint read back by generate; and
both workloads' guards."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from kubedl_tpu.train import dpo as jdpo
from kubedl_tpu.train import evaluate as jevaluate
from kubedl_tpu.train import generate as jgenerate
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.native.loader import write_shard
from kubedl_tpu_torch.train import checkpoint, dpo, evaluate, generate
from hf_dirs import GEMMA2, save_hf, save_word_tokenizer

NLL_TOL = 1e-4


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gemma2-dpo"))
    save_hf(path, *GEMMA2, seed=5)
    save_word_tokenizer(path, GEMMA2[1]["vocab_size"])
    return path


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("data", ["synthetic", "shards"])
def test_evaluate_json_line_equals_jax(hf_dir, tmp_path, monkeypatch, capsys, data):
    """evaluate --hf-model DIR: the JAX workload on a data4·tensor2 CPU mesh,
    the port on one device; the same batches, NLL within 1e-4."""
    args = ["--hf-model", hf_dir, "--batch", "4", "--seq-len", "32", "--log-every", "0"]
    if data == "shards":
        rng = np.random.default_rng(0)
        for i in range(2):
            write_shard(str(tmp_path / f"shard-{i}.bin"),
                        rng.integers(1, GEMMA2[1]["vocab_size"], 300))
        args += ["--data-path", str(tmp_path / "shard-*.bin"), "--max-batches", "3"]
    monkeypatch.setenv("KUBEDL_MESH", "data=4,tensor=2")
    assert jevaluate.main(args) == 0
    want = _json_line(capsys.readouterr().out)
    monkeypatch.delenv("KUBEDL_MESH")
    assert evaluate.main(args + ["--device", "cpu"]) == 0
    got = _json_line(capsys.readouterr().out)
    assert got["tokens"] == want["tokens"] == (3 if data == "shards" else 8) * 4 * 31
    assert abs(got["nll"] - want["nll"]) <= NLL_TOL, (got, want)
    assert got["metric"] == "eval_perplexity"
    assert abs(got["perplexity"] - want["perplexity"]) <= 2 * NLL_TOL * want["perplexity"]


def _mesh_message():
    """The reference's error for KUBEDL_MESH over one device."""
    import jax

    from kubedl_tpu.parallel.mesh import build_mesh_from_env

    with pytest.raises(ValueError) as e:
        build_mesh_from_env(devices=jax.devices()[:1])
    return str(e.value)


def test_evaluate_guards(tmp_path, monkeypatch, capsys):
    """The reference's exits: no shards, no checkpoint, fewer windows than a
    batch (exit 1); a mesh whose size is not the gang's, data=2 on one
    process (exit 2, the reference's message)."""
    tiny = ["--device", "cpu", "--model", "tiny"]
    assert evaluate.main(tiny + ["--allow-fresh-init", "--data-path",
                                 str(tmp_path / "none-*.bin")]) == 1
    assert "no shards match" in capsys.readouterr().err
    assert evaluate.main(tiny + ["--checkpoint-path", str(tmp_path / "nope")]) == 1
    assert "error: no checkpoint under" in capsys.readouterr().err
    write_shard(str(tmp_path / "small-0.bin"), np.arange(1, 40))
    assert evaluate.main(tiny + ["--allow-fresh-init", "--batch", "64", "--seq-len", "33",
                                 "--data-path", str(tmp_path / "small-*.bin")]) == 1
    assert "shrink --batch" in capsys.readouterr().err
    monkeypatch.setenv("KUBEDL_MESH", "data=2")
    assert evaluate.main(tiny + ["--allow-fresh-init"]) == 2
    assert _mesh_message() in capsys.readouterr().err


def _write_pairs(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _id_pairs(n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(1, vocab, 4).tolist(),
             "chosen": rng.integers(1, vocab, 6).tolist(),
             "rejected": rng.integers(1, vocab, 5).tolist()} for _ in range(n)]


def test_dpo_id_lists_resume_equals_a_straight_run(tmp_path, capsys):
    """dpo on id-list pairs: 3 steps straight, and 2 steps then a rerun to 3
    that restores step 2; the step-3 checkpoints are equal bit for bit, and
    generate --checkpoint-path reads the policy back."""
    pairs = _id_pairs(6, 256, 0) + [{"prompt": [1] * 30, "chosen": [2], "rejected": [3]}]
    data = _write_pairs(tmp_path / "pairs.jsonl", pairs)
    base = ["--device", "cpu", "--model", "tiny", "--data-path", data, "--batch", "2",
            "--seq-len", "16", "--lr", "1e-3", "--log-every", "1"]
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    assert dpo.main(base + ["--steps", "3", "--checkpoint-path", straight]) == 0
    out = capsys.readouterr().out
    assert "data: skipped 1 pairs exceeding --seq-len 16" in out
    assert "data: 6 pairs from" in out and "step 1: loss=0.6931 margin=0.000" in out
    assert "saved policy checkpoint at step 3" in out
    assert dpo.main(base + ["--steps", "2", "--checkpoint-path", cut]) == 0
    assert dpo.main(base + ["--steps", "3", "--checkpoint-path", cut]) == 0
    out = capsys.readouterr().out
    assert "restored policy checkpoint at step 2" in out and "done: 1 steps" in out
    a = torch.load(f"{straight}/3/{checkpoint.STATE_FILE}", weights_only=True)
    b = torch.load(f"{cut}/3/{checkpoint.STATE_FILE}", weights_only=True)
    for x, y in zip(llama.tree_leaves(a["params"]), llama.tree_leaves(b["params"])):
        assert torch.equal(x, y)
    restored = generate.restore_params(straight, device="cpu")
    fresh = llama.init(llama.LlamaConfig.tiny(), torch.Generator().manual_seed(0),
                       device="cpu")
    moved = [not torch.equal(x, y) for x, y in zip(llama.tree_leaves(restored),
                                                    llama.tree_leaves(fresh))]
    assert any(moved)


def test_dpo_text_pairs_through_the_tokenizer(hf_dir, tmp_path, capsys):
    """Text JSONL: load_pairs through the directory's tokenizer equals the
    JAX workload's arrays; dpo --hf-model DIR trains on them from the
    fixed point."""
    rows = [{"prompt": "w25 w26 w27", "chosen": "w28 w29", "rejected": "w10"},
            {"prompt": "user w11", "chosen": "w12 w13 w14", "rejected": "w15 w16"},
            {"prompt": [1, 20, 21], "chosen": [22, 23], "rejected": [24]}]
    data = _write_pairs(tmp_path / "text.jsonl", rows)
    want = jdpo.load_pairs(data, 12, tokenizer=jgenerate.load_tokenizer(hf_dir))
    tok = generate.load_tokenizer(hf_dir)
    got = dpo.load_pairs(data, 12, tokenizer=tok)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the prompt gets <bos>; continuations do not
    assert got[0][0, 0, 0] == tok.bos_token_id and tok.bos_token_id not in got[0][0, 0, 4:]
    assert dpo.main(["--device", "cpu", "--hf-model", hf_dir, "--data-path", data,
                     "--batch", "2", "--seq-len", "12", "--steps", "2", "--lr", "1e-3",
                     "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "step 1: loss=0.6931 margin=0.000" in out and "done: 2 steps" in out


def test_dpo_guards(tmp_path, monkeypatch, capsys):
    """Text without a tokenizer and a file of no usable pair raise the
    reference's errors; an empty --ref-checkpoint-path exits 1 unless
    --allow-fresh-init; a mesh whose size is not the gang's, data=2 on one
    process, exits 2 with the reference's message."""
    text = _write_pairs(tmp_path / "t.jsonl", [{"prompt": "hi", "chosen": "a",
                                                 "rejected": "b"}])
    with pytest.raises(ValueError) as jerr:
        jdpo.load_pairs(text, 16)
    with pytest.raises(ValueError) as terr:
        dpo.load_pairs(text, 16)
    assert str(terr.value) == str(jerr.value) and "no tokenizer" in str(terr.value)
    unusable = _write_pairs(tmp_path / "u.jsonl", [{"prompt": [1], "chosen": [],
                                                     "rejected": [2]}])
    with pytest.raises(ValueError, match="no usable pairs"):
        dpo.load_pairs(unusable, 16)
    tiny = ["--device", "cpu", "--model", "tiny", "--steps", "1", "--batch", "2",
            "--seq-len", "16"]
    assert dpo.main(tiny + ["--ref-checkpoint-path", str(tmp_path / "empty")]) == 1
    assert "error: no checkpoint under" in capsys.readouterr().err
    monkeypatch.setenv("KUBEDL_MESH", "data=2")
    assert dpo.main(tiny) == 2
    assert _mesh_message() in capsys.readouterr().err
