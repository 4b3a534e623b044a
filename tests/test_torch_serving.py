"""kubedl_tpu_torch/models/serving.py and train/serve.py: the port's engine
gives the JAX engine's greedy tokens on the same f32 parameters across
bucket clusters and slot reuse; EOS, step_block, sampling semantics and
failure isolation; one HTTP round trip through the port's server on the
CPU. Ring caches, chunked prefill, prefixes and speculative serving have
files of their own (tests/test_torch_{ring_cache,chunked_prefill,
prefix_cache,speculative}.py)."""
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models.serving import ServingEngine as JaxEngine
from kubedl_tpu_torch.models import decode, serving
from kubedl_tpu_torch.models.serving import ServingEngine, _bucket, sample_tokens
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=True)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams))


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in lengths]


def _generate(tp, tcfg, prompt, n):
    out = decode.generate(tp, torch.from_numpy(prompt)[None], tcfg, n)
    return out[0].tolist()


def test_bucket_selection():
    assert _bucket(3, [16, 32]) == 16
    assert _bucket(16, [16, 32]) == 16
    assert _bucket(17, [16, 32]) == 32
    with pytest.raises(ValueError):
        _bucket(33, [16, 32])


def test_serve_all_matches_jax_engine(model):
    """7 prompts over 3 slots (slot reuse) in two bucket clusters
    (16..64 and 128): greedy tokens equal the JAX engine's."""
    jcfg, jp, tcfg, tp = model
    prompts = _prompts((3, 7, 12, 20, 33, 70, 90))
    j = JaxEngine(jp, jcfg, slots=3, max_len=128).serve_all(prompts, 6)
    eng = ServingEngine(tp, tcfg, slots=3, max_len=128)
    t = eng.serve_all(prompts, 6)
    assert t == [list(map(int, x)) for x in j]
    st = eng.stats()
    assert st["admitted"] == 7 and st["tokens_out"] == 42 and st["slots_busy"] == 0


def test_eos_and_slot_reuse(model):
    _, _, tcfg, tp = model
    prompts = _prompts((5, 9, 14, 6), 1)
    refs = [_generate(tp, tcfg, p, 8) for p in prompts]
    eos = refs[1][3]  # the 4th token of request 1 ends it
    eng = ServingEngine(tp, tcfg, slots=2, max_len=32)
    outs = eng.serve_all(prompts, 8, eos_token=eos)
    for out, ref in zip(outs, refs):
        stop = ref.index(eos) + 1 if eos in ref else len(ref)
        assert out == ref[:stop]


def test_step_block_equals_single_steps(model):
    _, _, tcfg, tp = model
    prompts = _prompts((4, 11, 17, 2, 25), 2)
    a = ServingEngine(tp, tcfg, slots=2, max_len=64)
    b = ServingEngine(tp, tcfg, slots=2, max_len=64)
    ra = [a.submit(p, 7) for p in prompts]
    rb = [b.submit(p, 7) for p in prompts]
    while a.has_pending():
        a.step()
    while b.has_pending():
        b.step_block(8)
    assert [r.tokens for r in ra] == [r.tokens for r in rb]
    assert b.stats()["ticks"] >= a.stats()["ticks"]


def test_sampling_semantics(model):
    """top_k=1 at any temperature is greedy; temp-0 rows stay greedy in a
    batch whose other rows sample; logprobs are the model's."""
    _, _, tcfg, tp = model
    prompts = _prompts((6, 13, 9), 3)
    refs = [_generate(tp, tcfg, p, 5) for p in prompts]
    eng = ServingEngine(tp, tcfg, slots=3, max_len=32, seed=1)
    r0 = eng.submit(prompts[0], 5, temperature=1.3, top_k=1, logprobs=True)
    r1 = eng.submit(prompts[1], 5, temperature=0.0)
    r2 = eng.submit(prompts[2], 5, temperature=2.0, top_p=0.9)
    while eng.has_pending():
        eng.step_block()
    assert r0.tokens == refs[0] and r1.tokens == refs[1]
    assert len(r2.tokens) == 5 and all(0 <= t < 256 for t in r2.tokens)
    assert len(r0.token_logprobs) == 5 and all(lp <= 0 for lp in r0.token_logprobs)


def test_sample_tokens_modes():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 0.0, 0.0, 0.0]])
    g = torch.Generator().manual_seed(0)
    temps = torch.tensor([1.0, 0.0])
    zk, onep = torch.zeros(2, dtype=torch.int32), torch.ones(2)
    assert sample_tokens(logits, g, temps, zk, onep, "greedy", 4).tolist() == [1, 0]
    topk1 = torch.ones(2, dtype=torch.int32)
    for _ in range(5):
        assert sample_tokens(logits, g, temps, topk1, onep, "filtered", 4).tolist() == [1, 0]
        tiny_p = torch.full((2,), 1e-3)
        assert sample_tokens(logits, g, temps, zk, tiny_p, "filtered", 4).tolist() == [1, 0]
    draws = {sample_tokens(logits, g, torch.tensor([5.0, 0.0]), zk, onep,
                           "plain", 4)[0].item() for _ in range(60)}
    assert len(draws) > 1  # a hot temperature spreads the draws


def test_prefill_failure_fails_only_its_cluster(model, monkeypatch):
    _, _, tcfg, tp = model
    prompts = _prompts((5, 100), 4)
    real = decode._prefill

    def flaky(params, tokens, cache, config, lengths=None, par=None):
        if tokens.shape[1] == 128:
            raise RuntimeError("injected prefill failure")
        return real(params, tokens, cache, config, lengths, par)

    monkeypatch.setattr(serving.decode, "_prefill", flaky)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=128)
    good, bad = eng.submit(prompts[0], 4), eng.submit(prompts[1], 4)
    while eng.has_pending():
        eng.step()
    assert bad.done and bad.tokens == [] and "injected" in bad.error
    assert good.error is None and good.tokens == _generate(tp, tcfg, prompts[0], 4)


def test_wave_sync_failure_isolates_clusters(model):
    _, _, tcfg, tp = model
    prompts = _prompts((5, 100), 5)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=128)
    calls = []

    def poisoned(tensors):
        # 1: the whole wave; 2, 3: each cluster alone, in wave order (the
        # 16-token bucket, then the 128 one); 4: the live-cache check
        calls.append(1)
        if len(calls) in (1, 3):
            raise RuntimeError("poisoned")
        return serving._to_host(tensors)

    eng._wave_sync = poisoned
    short, long_ = (eng.submit(p, 3) for p in prompts)
    while eng.has_pending():
        eng.step()
    assert len(calls) >= 4
    assert eng.stats()["wave_failures"] == 1 and eng.stats()["wave_resets"] == 0
    assert long_.done and long_.tokens == [] and "poisoned" in long_.error
    assert short.error is None
    assert short.tokens == _generate(tp, tcfg, prompts[0], 3)


def test_unported_features_are_refused(model):
    """The ring cache, chunked prefill, speculative serving and LoRA
    adapters this test once pinned as refused are ported
    (tests/test_torch_{ring_cache,chunked_prefill,speculative,
    lora_serving}.py hold them against JAX): the first three serve the
    plain engine's tokens here, and an adapter id that names no registered
    adapter is the reference's ValueError."""
    _, _, tcfg, tp = model
    prompt = _prompts((9,), 10)[0]
    want = ServingEngine(tp, tcfg, slots=1, max_len=32).serve_all([prompt], 4)
    windowed = dataclasses.replace(tcfg, sliding_window=64)  # wider than the prompt
    for cfg, kw in ((windowed, dict(ring=True, max_len=64)), (tcfg, dict(prefill_chunk=8)),
                    (tcfg, dict(draft_params=tp, draft_config=tcfg))):
        eng = ServingEngine(tp, cfg, slots=1, **{"max_len": 32, **kw})
        assert eng.serve_all([prompt], 4) == want, kw
    eng = ServingEngine(tp, tcfg, slots=1, max_len=32)
    with pytest.raises(ValueError, match=r"unknown adapter_id 1 \(0 registered; 0 = base\)"):
        eng.submit([1, 2], 2, adapter_id=1)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit([1, 2], 2, prefix_id=0)
    with pytest.raises(ValueError):
        eng.submit([1] * 40, 2)  # past max_len
    with pytest.raises(ValueError):
        eng.submit([1, 2], 2, top_p=0.0)


@pytest.fixture
def server():
    from kubedl_tpu_torch.train import serve

    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--port", "0",
                             "--bind", "127.0.0.1", "--max-len", "64"])
    httpd, svc = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", svc
    httpd.shutdown()
    t.join(timeout=30)
    httpd.server_close()
    svc.stop()
    assert not t.is_alive()


def _post(base, body):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_round_trip_on_cpu(server):
    """Port 0 binds a free port; single and batch forms return the greedy
    tokens of the same fresh-init weights (seed 0)."""
    base, svc = server
    from kubedl_tpu_torch.train.generate import resolve_params

    tp, tcfg = resolve_params("tiny", device="cpu")
    prompts = _prompts((4, 30), 6)
    single = _post(base, {"tokens": prompts[0].tolist(), "max_new_tokens": 5})
    batch = _post(base, {"requests": [{"tokens": p.tolist(), "max_new_tokens": 5}
                                      for p in prompts]})
    want = [_generate(tp, tcfg, p, 5) for p in prompts]
    assert single["tokens"] == want[0] and "error" not in single
    assert [r["tokens"] for r in batch["results"]] == want
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}
    with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["admitted"] == 3 and stats["tokens_out"] == 15
    # stream: true is ported (tests/test_torch_serve_stream.py); only its
    # batch form stays refused, as the reference refuses it. Text needs a
    # tokenizer, which a --model server has none of (the reference's 422;
    # tests/test_torch_serve_text.py serves text)
    for bad in ({"text": "hi"}, {"tokens": [1], "prefix_id": 2},
                {"requests": [{"tokens": [1]}], "stream": True}, {"tokens": []}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, bad)
        assert e.value.code == 422
    assert svc.engine.has_pending() is False


def test_serve_refuses_unported_flags_and_missing_card(monkeypatch, tmp_path, capsys):
    """--draft-hf-model and --hf-model, refused until Hugging Face import
    was ported, now read checkpoint directories, and a missing one raises
    naming it (tests/test_torch_serve_text.py serves real ones); --adapter
    and --lora-checkpoint-path, refused until LoRA was ported, now read
    adapter checkpoints, and a path with none exits 1 with the reference's
    error (tests/test_torch_serve_stream.py and test_torch_lora.py serve
    real ones)."""
    from kubedl_tpu_torch.train import serve

    for flags in (["--draft-hf-model", "x"], ["--hf-model", "x"]):
        with pytest.raises(FileNotFoundError, match="x: not a Hugging Face checkpoint"):
            serve.build_server(serve.parse_args(["--device", "cpu"] + flags))
    for flags, said in ((["--adapter", "x"], "error: --adapter 'x': no adapter checkpoint"),
                        (["--lora-checkpoint-path", "x"], "error: no adapter checkpoint")):
        assert serve.main(["--device", "cpu", "--port", "0", "--bind", "127.0.0.1"]
                          + flags) == 1
        assert f"{said} under 'x'" in capsys.readouterr().err
    # checkpoints are ported: an empty path is the reference's error, exit 1
    assert serve.main(["--device", "cpu", "--checkpoint-path", str(tmp_path)]) == 1
    assert f"error: no checkpoint under {tmp_path}" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.build_server(serve.parse_args(["--port", "0"]))


def test_moe_engine_matches_jax_engine():
    """A tiny MoE llama (4 experts, top 2, f32): the port's engine gives the
    JAX engine's greedy tokens over two bucket clusters and slot reuse."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=True, n_experts=4,
                                   expert_top_k=2)
    jp = jllama.init(jcfg, jax.random.PRNGKey(5))
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    tp = params_from_numpy(jax.device_get(jp))
    prompts = _prompts((3, 12, 40, 70), 7)
    j = JaxEngine(jp, jcfg, slots=2, max_len=128).serve_all(prompts, 5)
    t = ServingEngine(tp, tcfg, slots=2, max_len=128).serve_all(prompts, 5)
    assert t == [list(map(int, x)) for x in j]


def test_http_round_trip_int8_on_cpu():
    """--int8: the server quantizes the fresh-init tree and answers with the
    greedy tokens of quant.quantize_params of the same weights."""
    from kubedl_tpu_torch.models import quant
    from kubedl_tpu_torch.train import serve
    from kubedl_tpu_torch.train.generate import resolve_params

    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--port", "0",
                             "--bind", "127.0.0.1", "--max-len", "64", "--int8"])
    httpd, svc = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert quant.is_quantized(svc.engine.params["layers"][0]["wq"])
        tp, tcfg = resolve_params("tiny", device="cpu")
        qp = quant.quantize_params(tp)
        prompt = _prompts((9,), 8)[0]
        got = _post(base, {"tokens": prompt.tolist(), "max_new_tokens": 5})
        assert got["tokens"] == _generate(qp, tcfg, prompt, 5)
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        httpd.server_close()
        svc.stop()


def test_http_round_trip_kv_int8_on_cpu():
    """--kv-int8: the engine keeps an int8 cache and answers with the greedy
    tokens of decode.generate(kv_dtype="int8") on the same weights; /stats
    reports the cache's bytes."""
    from kubedl_tpu_torch.train import serve
    from kubedl_tpu_torch.train.generate import resolve_params

    args = serve.parse_args(["--model", "tiny", "--device", "cpu", "--port", "0",
                             "--bind", "127.0.0.1", "--max-len", "64", "--kv-int8"])
    httpd, svc = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert svc.engine.cache["k"][0].dtype == torch.int8
        tp, tcfg = resolve_params("tiny", device="cpu")
        prompt = _prompts((9,), 9)[0]
        got = _post(base, {"tokens": prompt.tolist(), "max_new_tokens": 5})
        want = decode.generate(tp, torch.from_numpy(prompt)[None], tcfg, 5, kv_dtype="int8")
        assert got["tokens"] == want[0].tolist()
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        # 8 slots, 2 KV heads, 64 positions: int8 codes of head_dim 32 + bf16 scales
        assert stats["kv_cache_bytes"] == tcfg.n_layers * 2 * (8 * 2 * 64 * 32 + 8 * 2 * 64 * 2)
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        httpd.server_close()
        svc.stop()
