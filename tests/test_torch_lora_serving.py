"""Multi-adapter serving in kubedl_tpu_torch/models/serving.py against the
JAX engine (tests/test_serving.py's LoRA tests): LlamaConfig.tiny in f32,
the same parameters and the same adapters (JAX's `lora_init` with seeded
noise, carried across with utils/convert.py). Two adapters and the base in
one batch give the JAX engine's greedy tokens, plainly, with chunked
prefill and with a self-draft speculative engine; requests naming adapter
0 give the no-adapter engine's tokens bit for bit; the registry and
`submit` raise the JAX engine's messages; adapters compose with sampling
and logprobs; an int8 tree and a mesh are refused."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import lora as jlora
from kubedl_tpu.models.serving import ServingEngine as JaxEngine
from kubedl_tpu_torch.models import decode, llama, lora, quant
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(config_from_fields(**dataclasses.asdict(jcfg)), use_flash=True)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp))


def _adapter(jp, seed, targets=("wq", "wv", "w2"), rank=4, scale=0.05):
    """(JAX adapters, the port's): lora_init's layout, every leaf seeded
    noise so each adapter moves greedy tokens."""
    ad = jlora.lora_init(jax.random.PRNGKey(seed), jp, rank=rank, targets=targets)
    rng = np.random.default_rng(seed)
    ad = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * scale, jnp.float32), ad)
    return ad, params_from_numpy(jax.device_get(ad))


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in lengths]


def _run(eng, jobs, block=True):
    reqs = [eng.submit(p, n, adapter_id=a, **kw) for p, n, a, kw in jobs]
    while not all(r.done for r in reqs):
        eng.step_block() if block else eng.step()
    return reqs


# (engine options, prompt lengths): plain waves across bucket clusters and
# slot reuse; a prompt past the largest bucket chunk-prefills under its
# adapter; a self-draft verifies with the slots' adapters
ENGINES = {
    "plain": (dict(slots=3, max_len=64), (5, 9, 7, 20, 12, 6)),
    "chunked": (dict(slots=3, max_len=128, prefill_chunk=16, prompt_buckets=[16, 32]),
                (40, 5, 9, 37, 7, 50)),
    "speculative": (dict(slots=3, max_len=64, spec_k=3, draft="self"), (5, 9, 7, 11)),
}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_two_adapters_and_the_base_in_one_batch_match_jax(model, kind):
    jcfg, jp, tcfg, tp = model
    kw, lengths = ENGINES[kind]
    kw = dict(kw)
    if kw.pop("draft", None):
        jkw = dict(kw, draft_params=jp, draft_config=jcfg)
        tkw = dict(kw, draft_params=tp, draft_config=tcfg)
    else:
        jkw = tkw = kw
    (ja1, ta1), (ja2, ta2) = _adapter(jp, 1), _adapter(jp, 2)
    jobs = [(p, 6, i % 3, {}) for i, p in enumerate(_prompts(lengths, 21))]
    j = JaxEngine(jp, jcfg, **jkw)
    assert (j.register_adapter(ja1), j.register_adapter(ja2, alpha=8.0)) == (1, 2)
    want = [r.tokens for r in _run(j, jobs)]
    eng = ServingEngine(tp, tcfg, **tkw)
    assert (eng.register_adapter(ta1), eng.register_adapter(ta2, alpha=8.0)) == (1, 2)
    got = _run(eng, jobs)
    assert [r.tokens for r in got] == [list(map(int, w)) for w in want]
    assert eng.stats()["adapters_registered"] == 2
    if kind == "chunked":
        assert eng.stats()["chunked_prefills"] == j.stats()["chunked_prefills"] == 3
    if kind == "speculative":
        assert eng.stats()["spec_rounds"] > 0
    # each adapter's requests decode as the merged model does, alone
    merged = {1: lora.merge(tp, ta1), 2: lora.merge(tp, ta2, alpha=8.0), 0: tp}
    for (p, n, a, _), r in zip(jobs, got):
        ref = decode.generate(merged[a], torch.from_numpy(p)[None], tcfg, n)[0].tolist()
        assert r.tokens == ref, a


def test_adapter_zero_is_the_base_engine_bit_for_bit(model):
    """With adapters registered, requests naming adapter 0 (the zero row)
    give the no-adapter engine's tokens and logprobs exactly."""
    _, jp, tcfg, tp = model
    prompts = _prompts((5, 9, 13), 3)
    plain = _run(ServingEngine(tp, tcfg, slots=3, max_len=64),
                 [(p, 6, 0, {"logprobs": True}) for p in prompts])
    eng = ServingEngine(tp, tcfg, slots=3, max_len=64)
    eng.register_adapter(_adapter(jp, 4)[1])
    got = _run(eng, [(p, 6, 0, {"logprobs": True}) for p in prompts])
    assert eng.lora is not None
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    assert [r.token_logprobs for r in got] == [r.token_logprobs for r in plain]


def _errors(fn_j, fn_t):
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_registry_and_submit_errors_match_jax(model):
    """Every registry and submit refusal carries the JAX engine's words, and
    a failed registration leaves the registry unchanged."""
    jcfg, jp, tcfg, tp = model
    j = JaxEngine(jp, jcfg, slots=2, max_len=32, max_adapters=2)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=32, max_adapters=2)

    def both(ja, ta, **kw):
        return _errors(lambda: j.register_adapter(ja, **kw),
                       lambda: eng.register_adapter(ta, **kw))

    assert "unknown adapter_id 1 (0 registered" in _errors(
        lambda: j.submit([1, 2], 4, adapter_id=1), lambda: eng.submit([1, 2], 4, adapter_id=1))
    ja, ta = _adapter(jp, 0, targets=("wq",))
    short_j, short_t = {"layers": ja["layers"][:1]}, {"layers": ta["layers"][:1]}
    assert "adapter has 1 layers, model has 2" == both(short_j, short_t)
    mixed_j = jax.tree.map(lambda x: x, ja)
    mixed_j["layers"][1] = _adapter(jp, 9, targets=("wq",), rank=2)[0]["layers"][1]
    mixed_t = params_from_numpy(jax.device_get(mixed_j))
    assert "mixed ranks within adapter" in both(mixed_j, mixed_t)
    bad_j = {"layers": [{"wz": e["wq"]} for e in ja["layers"]]}
    bad_t = {"layers": [{"wz": e["wq"]} for e in ta["layers"]]}
    assert "has no such projection" in both(bad_j, bad_t)
    ocfg = jllama.LlamaConfig.tiny(d_model=64, use_flash=False, dtype=jnp.float32)
    other = jllama.init(ocfg, jax.random.PRNGKey(5))
    wide_j = jlora.lora_init(jax.random.PRNGKey(0), other, rank=4, targets=("wq",))
    assert "wrong checkpoint/model pairing" in both(
        wide_j, params_from_numpy(jax.device_get(wide_j)))
    assert eng.lora is None and not eng._adapter_rows
    assert eng.register_adapter(ta) == j.register_adapter(ja) == 1
    # stacks live in the model dtype, row 0 zeros
    stack = eng.lora["layers"][0]["wq"]
    assert stack["a"].dtype == tcfg.dtype and stack["a"].shape == (2, 128, 4)
    assert float(stack["a"][0].abs().max()) == float(stack["b"][0].abs().max()) == 0.0
    for targets, rank in ((("wq",), 8), (("wv",), 4)):
        assert "rank/targets differ" in both(*_adapter(jp, 3, targets=targets, rank=rank))
    assert j.register_adapter(ja) == eng.register_adapter(ta) == 2
    assert "adapter registry full (2)" == both(ja, ta)
    pj = j.register_prefix(np.ones(4, np.int32))
    pt = eng.register_prefix(np.ones(4, np.int32))
    assert "cannot combine with prefix_id" in _errors(
        lambda: j.submit([1, 2], 4, adapter_id=1, prefix_id=pj),
        lambda: eng.submit([1, 2], 4, adapter_id=1, prefix_id=pt))


def test_adapters_compose_with_sampling_and_logprobs(model):
    """A greedy base request with logprobs, a top_k=1 adapter request (an
    argmax despite temperature) and a nucleus-sampled base request in one
    batch: tokens and logprobs per request, of its own weights."""
    jcfg, jp, tcfg, tp = model
    ja, ta = _adapter(jp, 3, targets=("wq", "w2"))
    eng = ServingEngine(tp, tcfg, slots=3, max_len=64)
    aid = eng.register_adapter(ta)
    p1, p2, p3 = _prompts((6, 9, 4), 31)
    r1, r2, r3 = _run(eng, [(p1, 5, 0, {"logprobs": True}),
                            (p2, 5, aid, {"temperature": 3.0, "top_k": 1, "logprobs": True}),
                            (p3, 5, 0, {"temperature": 1.0, "top_p": 0.9})])
    merged_j = jlora.merge(jp, ja)

    def teacher(params, prompt, tokens):
        full = np.concatenate([prompt, np.asarray(tokens, np.int32)])
        logits = np.asarray(jllama.forward(params, jnp.asarray(full[None]), jcfg), np.float64)
        logp = logits - logits.max(-1, keepdims=True)
        logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
        return [float(logp[0, len(prompt) - 1 + i, t]) for i, t in enumerate(tokens)]

    def greedy(params, prompt):  # the port's merge is held to JAX's in test_torch_lora.py
        return decode.generate(params, torch.from_numpy(prompt)[None], tcfg, 5)[0].tolist()

    assert r1.tokens == greedy(tp, p1) and r2.tokens == greedy(lora.merge(tp, ta), p2)
    for got, want in ((r1.token_logprobs, teacher(jp, p1, r1.tokens)),
                      (r2.token_logprobs, teacher(merged_j, p2, r2.tokens))):
        assert len(got) == 5 and np.allclose(got, want, atol=2e-4, rtol=0)
    assert not r3.token_logprobs and len(r3.tokens) == 5


def test_int8_tree_and_mesh_are_refused(model, monkeypatch):
    """Adapters on an int8 weight tree are a ValueError (the reference
    would read the shape of a {"q", "s"} leaf); under a mesh the engine
    refuses with NotImplementedError naming ROADMAP.md."""
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel.mesh import build_mesh, shard_tree
    from torch_gang import free_port

    jcfg, jp, tcfg, tp = model
    _, ta = _adapter(jp, 1)
    q = ServingEngine(quant.quantize_params(tp), tcfg, slots=1, max_len=32)
    with pytest.raises(ValueError, match="int8 weight"):
        q.register_adapter(ta)
    assert q.lora is None
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = build_mesh({"tensor": 1}, device_type="cpu")
        sharded = shard_tree(tp, mesh, llama.param_specs(tcfg))
        eng = ServingEngine(sharded, tcfg, slots=1, max_len=32, mesh=mesh)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            eng.register_adapter(ta)
        assert eng.serve_all([np.arange(1, 6, dtype=np.int32)], 3)[0] == \
            decode.generate(tp, torch.arange(1, 6, dtype=torch.int32)[None], tcfg, 3)[0].tolist()
    finally:
        dist.destroy_process_group()
