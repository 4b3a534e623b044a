"""Checkpoint-loaded weights for the port's entry points: a tiny trainer
run of kubedl_tpu_torch with --checkpoint-path, then train/serve.py and
train/generate.py main with --checkpoint-path (and as a speculative
draft): the restored params equal the saved ones bit for bit, and the
tokens equal those of the trained params in memory. An empty checkpoint
directory exits 1 with the reference's error unless --allow-fresh-init is
given, as does an adapter directory with no adapters; --hf-model, once
refused, generates from a Hugging Face directory and raises naming a
missing one."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import copy
import json
import threading
import urllib.request

import pytest
import torch

from kubedl_tpu_torch.models import decode, llama
from kubedl_tpu_torch.train import checkpoint, generate, serve, trainer

TINY = ["--device", "cpu", "--model", "tiny", "--batch", "2", "--seq-len", "17"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint dir, the params the trainer saved at its last step)."""
    path = str(tmp_path_factory.mktemp("ckpt"))
    kept = {}
    save = checkpoint.CheckpointManager.save

    def keep(self, step, state):
        kept[step] = copy.deepcopy(state.params)
        return save(self, step, state)

    checkpoint.CheckpointManager.save = keep
    try:
        assert trainer.main(TINY + ["--steps", "3", "--log-every", "100",
                                    "--checkpoint-path", path]) == 0
    finally:
        checkpoint.CheckpointManager.save = save
    assert checkpoint.latest_step(path) == 3
    return path, kept[3]


def _equal(a, b):
    la, lb = list(llama.tree_leaves(a)), list(llama.tree_leaves(b))
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_restore_params_reads_the_newest_step(trained, capsys):
    path, params = trained
    got = generate.restore_params(path, device="cpu")
    assert _equal(got, params) and not any(t.requires_grad for t in llama.tree_leaves(got))
    assert "restored params params from checkpoint step 3" in capsys.readouterr().out
    fresh = llama.init(llama.LlamaConfig.tiny(), torch.Generator().manual_seed(0), device="cpu")
    assert not _equal(got, fresh)  # training moved them


def test_restore_params_reads_a_sharded_step(tmp_path):
    """A gloo gang of two ranks (tests/torch_gang.py) takes one fsdp2 step
    and saves its DTensor state through CheckpointManager, each rank its
    own shards, asynchronously: a second step runs in place over the live
    state while the write is in flight. The published step restores into
    the gang (a fresh sharded state) and, through restore_params in a
    process with no group, whole: the gang's parameters after the first
    step, bit for bit, not the live state's after the second."""
    from torch_gang import run_gang

    from kubedl_tpu_torch.utils.convert import params_from_numpy

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
    fields["dtype"] = "float32"
    path = str(tmp_path / "sharded")
    batch = torch.randint(0, cfg.vocab_size, (4, 17),
                          generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    case = dict(name="ckpt", ici={"fsdp": 2}, dcn=None, config=fields,
                params=llama.tree_map(lambda t: t.numpy(), params),
                batches=[batch.numpy()], accum=1, lr=1e-3, clip=1.0, checkpoint=path)
    got, _ = run_gang([case], 2, tmp_path)
    step_dir = tmp_path / "sharded" / "1"
    assert (step_dir / checkpoint.SHARDED_FILE).is_file()
    assert not (step_dir / checkpoint.STATE_FILE).exists()
    assert len(list(step_dir.glob("*.distcp"))) == 2  # one shard file a rank
    restored = generate.restore_params(path, device="cpu")
    saved = params_from_numpy(got["ckpt"]["params"])
    assert _equal(restored, saved)
    assert not _equal(restored, params)  # the step moved them
    assert not any(t.requires_grad for t in llama.tree_leaves(restored))
    gang = got["ckpt"]["restored"]
    assert gang["step"] == 1 and _equal(params_from_numpy(gang["params"]), saved)
    assert not _equal(params_from_numpy(gang["moved"]), saved)  # the live state moved on


def _prompt(seed):
    return torch.randint(0, 256, (1, 32), generator=torch.Generator().manual_seed(seed + 1),
                         dtype=torch.int32)


def test_generate_main_serves_the_checkpoint(trained, capsys):
    path, params = trained
    cfg = llama.LlamaConfig.tiny()
    want = decode.generate(params, _prompt(0), cfg, 8)[0].tolist()
    assert generate.main(["--device", "cpu", "--checkpoint-path", path, "--batch", "1",
                          "--max-new-tokens", "8"]) == 0
    out = capsys.readouterr().out
    assert f"sample[0,:8]={want}" in out and "restored target params" in out
    # the checkpoint as a speculative draft of itself: the same tokens
    assert generate.main(["--device", "cpu", "--checkpoint-path", path, "--batch", "1",
                          "--max-new-tokens", "8", "--speculative-k", "3",
                          "--draft-checkpoint-path", path]) == 0
    out = capsys.readouterr().out
    assert f"sample[0,:8]={want}" in out and "restored draft params" in out
    assert "speculative: rounds=" in out and "acceptance=1.00" in out


def test_empty_checkpoint_dir_is_an_error(tmp_path, capsys):
    empty = str(tmp_path)
    assert generate.main(["--device", "cpu", "--checkpoint-path", empty]) == 1
    assert (f"error: no checkpoint under {empty} (pass --allow-fresh-init to serve random "
            f"weights)") in capsys.readouterr().err
    assert generate.main(["--device", "cpu", "--checkpoint-path", empty, "--allow-fresh-init",
                          "--batch", "1", "--max-new-tokens", "2"]) == 0
    assert f"no checkpoint under {empty}; using fresh init" in capsys.readouterr().out
    assert generate.main(["--device", "cpu", "--batch", "1", "--speculative-k", "2",
                          "--draft-checkpoint-path", empty]) == 1
    assert "pass --allow-fresh-init for a random draft" in capsys.readouterr().err
    assert serve.main(["--device", "cpu", "--checkpoint-path", empty]) == 1
    assert f"error: no checkpoint under {empty}" in capsys.readouterr().err
    # a draft with no weights: exit 1 unless --allow-fresh-init
    assert serve.main(["--device", "cpu", "--draft-model", "tiny"]) == 1
    assert "--draft-model needs weights" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--hf-model", "x"], ["--lora-checkpoint-path", "x"],
                                  ["--speculative-k", "1", "--batch", "1"],
                                  ["--speculative-k", "2", "--batch", "2"]])
def test_generate_refusals_exit_2(argv, capsys, tmp_path):
    """--lora-checkpoint-path was refused (exit 2) until LoRA was ported:
    now a directory with no adapters is the reference's error, exit 1, as
    a missing checkpoint is (tests/test_torch_lora.py merges a real one).
    --hf-model was refused until Hugging Face import was ported: now a
    missing directory raises naming it, and a real one generates
    (tests/test_torch_import_hf.py holds the tree and the tokens to JAX)."""
    if argv[0] == "--hf-model":
        pytest.importorskip("transformers")
        from hf_dirs import GEMMA2, save_hf

        with pytest.raises(FileNotFoundError, match="x: not a Hugging Face checkpoint"):
            generate.main(["--device", "cpu"] + argv)
        save_hf(str(tmp_path), *GEMMA2)
        assert generate.main(["--device", "cpu", "--hf-model", str(tmp_path), "--batch",
                              "1", "--prompt-len", "4", "--max-new-tokens", "2"]) == 0
        assert "done: generated 1x2 tokens" in capsys.readouterr().out
        return
    rc = generate.main(["--device", "cpu"] + argv)
    err = capsys.readouterr().err
    assert "error:" in err
    if argv[0] == "--lora-checkpoint-path":
        assert rc == 1 and "error: no adapter checkpoint under 'x'" in err
        return
    assert rc == 2


def _post(base, body):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_the_checkpoint_with_itself_as_draft(trained):
    """serve --checkpoint-path DIR --draft-model tiny --draft-checkpoint-path
    DIR: the restored trees equal the saved ones, the engine speculates, and
    the answer is the trained params' greedy continuation."""
    path, params = trained
    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--port", "0",
                             "--bind", "127.0.0.1", "--max-len", "64",
                             "--checkpoint-path", path, "--draft-model", "tiny",
                             "--draft-checkpoint-path", path, "--spec-k", "3"])
    httpd, svc = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        eng = svc.engine
        assert _equal(eng.params, params) and _equal(eng.draft_params, params)
        assert eng._spec and eng.spec_k == 3
        prompt = _prompt(4)
        got = _post(base, {"tokens": prompt[0].tolist(), "max_new_tokens": 9})
        assert got["tokens"] == decode.generate(params, prompt, llama.LlamaConfig.tiny(),
                                                9)[0].tolist()
        assert eng.stats()["spec_rounds"] > 0 and eng.stats()["spec_acceptance"] > 0.9
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        httpd.server_close()
        svc.stop()
