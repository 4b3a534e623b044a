"""Chunked prefill of kubedl_tpu_torch (decode.prefill_chunked and the
engine's chunker) and generate(with_logprobs=True) against the JAX
package's (tests/test_decode.py and tests/test_serving.py hold the JAX side
to its own one-pass paths): the same f32 parameters, inputs from a numpy
seed. Logits within 1e-4 of max|JAX|, greedy tokens equal, the routing
integers (which prompts chunk, how many chunked prefills, how many wave
prefills) equal, and the errors JAX raises raised the same way."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import decode as jdecode
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models.serving import ServingEngine as JaxEngine
from kubedl_tpu_torch.models import decode as tdecode
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.parallel import mesh as tmesh
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(use_flash=False, dtype=jnp.float32)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(config_from_fields(**dataclasses.asdict(jcfg)), use_flash=True)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp))


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def _toks(b, t, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 256, size=n).astype(np.int32)


@pytest.mark.parametrize("t,chunk", [(12, 4), (5, 8), (10, 4)])
def test_prefill_chunked_matches_jax(model, t, chunk):
    """One pass, a prompt shorter than a chunk, and a trailing partial
    chunk: logits and every written cache row as JAX's, then one decode
    step on."""
    jcfg, jp, tcfg, tp = model
    toks = _toks(2, t, t)
    jl, jc = jdecode.prefill_chunked(jp, jnp.asarray(toks),
                                     jdecode.init_kv_cache(jcfg, 2, 16, uniform=True),
                                     jcfg, chunk_size=chunk)
    tl, tc = tdecode.prefill_chunked(tp, torch.from_numpy(toks),
                                     tdecode.init_kv_cache(tcfg, 2, 16, uniform=True,
                                                           device="cpu"),
                                     tcfg, chunk_size=chunk)
    _close(tl, jl)
    assert int(tc["lengths"]) == int(jc["lengths"]) == t
    for i in range(tcfg.n_layers):
        _close(tc["k"][i][:, :, :t], np.asarray(jc["k"][i])[:, :, :t])
        _close(tc["v"][i][:, :, :t], np.asarray(jc["v"][i])[:, :, :t])
    one, _ = tdecode.prefill(tp, torch.from_numpy(toks),
                             tdecode.init_kv_cache(tcfg, 2, 16, uniform=True, device="cpu"),
                             tcfg)
    _close(tl, np.asarray(one))
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl2, _ = jdecode.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl2, _ = tdecode.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl2, jl2)


def test_prefill_chunked_appends_like_jax(model):
    """The multi-turn use: turn 2 appended in chunks of 2 to a cache that
    holds turn 1."""
    jcfg, jp, tcfg, tp = model
    turn1, turn2 = _toks(2, 6, 8), _toks(2, 4, 9)
    jc = jdecode.init_kv_cache(jcfg, 2, 16, uniform=True)
    _, jc = jdecode.prefill(jp, jnp.asarray(turn1), jc, jcfg)
    jl, jc = jdecode.prefill_chunked(jp, jnp.asarray(turn2), jc, jcfg, chunk_size=2)
    tc = tdecode.init_kv_cache(tcfg, 2, 16, uniform=True, device="cpu")
    _, tc = tdecode.prefill(tp, torch.from_numpy(turn1), tc, tcfg)
    tl, tc = tdecode.prefill_chunked(tp, torch.from_numpy(turn2), tc, tcfg, chunk_size=2)
    _close(tl, jl)
    assert int(tc["lengths"]) == 10
    ref, _ = tdecode.prefill(tp, torch.from_numpy(np.concatenate([turn1, turn2], 1)),
                             tdecode.init_kv_cache(tcfg, 2, 16, uniform=True, device="cpu"),
                             tcfg)
    _close(tl, np.asarray(ref))


def test_prefill_chunked_errors_match_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _toks(2, 10, 7)
    with pytest.raises(ValueError, match="uniform cache") as je:
        jdecode.prefill_chunked(jp, jnp.asarray(toks), jdecode.init_kv_cache(jcfg, 2, 16), jcfg)
    with pytest.raises(ValueError, match="uniform cache") as te:
        tdecode.prefill_chunked(tp, torch.from_numpy(toks),
                                tdecode.init_kv_cache(tcfg, 2, 16, device="cpu"), tcfg)
    assert str(te.value) == str(je.value)
    _, jc = jdecode.prefill_chunked(jp, jnp.asarray(toks),
                                    jdecode.init_kv_cache(jcfg, 2, 16, uniform=True), jcfg,
                                    chunk_size=4)
    tc = tdecode.init_kv_cache(tcfg, 2, 16, uniform=True, device="cpu")
    _, tc = tdecode.prefill_chunked(tp, torch.from_numpy(toks), tc, tcfg, chunk_size=4)
    with pytest.raises(ValueError, match="overflows") as je:
        jdecode.prefill_chunked(jp, jnp.asarray(toks), jc, jcfg, chunk_size=4)
    with pytest.raises(ValueError, match="overflows") as te:
        tdecode.prefill_chunked(tp, torch.from_numpy(toks), tc, tcfg, chunk_size=4)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_generate_with_logprobs(model, temperature):
    """Greedy: JAX's tokens and log-probs (1e-4). Sampled: each log-prob is
    log_softmax of a teacher-forced forward at the drawn token."""
    from kubedl_tpu_torch.models import llama as tllama

    jcfg, jp, tcfg, tp = model
    prompt = _toks(2, 7, 3)
    gen = torch.Generator().manual_seed(1)
    toks, lps = tdecode.generate(tp, torch.from_numpy(prompt), tcfg, 6,
                                 temperature=temperature, generator=gen, with_logprobs=True)
    assert toks.shape == lps.shape == (2, 6) and lps.dtype == torch.float32
    if temperature == 0:
        jt, jl = jdecode.generate(jp, jnp.asarray(prompt), jcfg, 6, with_logprobs=True)
        assert toks.tolist() == np.asarray(jt).tolist()
        _close(lps, jl)
    full = torch.cat([torch.from_numpy(prompt), toks], 1)
    logp = torch.log_softmax(tllama.forward(tp, full, tcfg).float(), -1)
    want = logp[:, 6:-1].gather(-1, toks[:, :, None].long())[..., 0]
    np.testing.assert_allclose(lps.numpy(), want.numpy(), atol=1e-4)
    plain = tdecode.generate(tp, torch.from_numpy(prompt), tcfg, 6, temperature=temperature,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(plain, toks)


def _ref(tp, tcfg, prompt, n):
    return tdecode.generate(tp, torch.from_numpy(prompt)[None], tcfg, n)[0].tolist()


def _run(eng, reqs, block=False):
    while not all(r.done for r in reqs):
        eng.step_block() if block else eng.step()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("block", [False, True])
def test_engine_chunked_prefill_matches_jax(model, block):
    """A prompt past the largest bucket chunks (one chunk an engine step)
    beside a decoding short request; tokens and routing counts as the JAX
    engine's, step() and step_block() alike."""
    jcfg, jp, tcfg, tp = model
    long_p, short = _prompt(40, 7), _prompt(5, 8)
    kw = dict(slots=3, max_len=128, prefill_chunk=16, prompt_buckets=[16, 32])
    j = JaxEngine(jp, jcfg, **kw)
    want = _run(j, [j.submit(short, 12), j.submit(long_p, 6)], block)
    eng = ServingEngine(tp, tcfg, **kw)
    got = _run(eng, [eng.submit(short, 12), eng.submit(long_p, 6)], block)
    assert got == [list(map(int, x)) for x in want]
    assert got == [_ref(tp, tcfg, short, 12), _ref(tp, tcfg, long_p, 6)]
    for key in ("chunked_prefills", "prefill_batches", "admitted", "tokens_out"):
        assert eng.stats()[key] == j.stats()[key], key
    assert eng.stats()["chunked_prefills"] == 1


def test_chunked_prefill_interleaves_with_decode(model):
    """The short request decodes through each of the 3 chunks."""
    _, _, tcfg, tp = model
    short, long_p = _prompt(4, 8), _prompt(48, 9)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=128, prefill_chunk=16,
                        prompt_buckets=[16, 32])
    r_short = eng.submit(short, 20)
    eng.step()
    r_long = eng.submit(long_p, 4)
    before = None
    while not r_long.done:
        eng.step()
        if before is None and r_long.tokens:
            before = len(r_short.tokens)
    assert before is not None and before >= 3
    _run(eng, [r_short])
    assert r_short.tokens == _ref(tp, tcfg, short, 20)
    assert r_long.tokens == _ref(tp, tcfg, long_p, 4)


def test_failed_chunk_frees_slot(model, monkeypatch):
    _, _, tcfg, tp = model
    eng = ServingEngine(tp, tcfg, slots=2, max_len=128, prefill_chunk=16,
                        prompt_buckets=[16, 32])

    def boom(*a, **k):
        raise RuntimeError("synthetic chunk failure")

    monkeypatch.setattr(eng, "_append_block", boom)
    longp = _prompt(40, 12)
    req = eng.submit(longp, 4)
    eng.step()
    assert req.done and "synthetic" in req.error
    assert eng._chunking is None and eng._slot_req == [None, None]
    monkeypatch.undo()
    req2 = eng.submit(longp, 4)
    _run(eng, [req2])
    assert req2.tokens == _ref(tp, tcfg, longp, 4)


def test_chunking_lifts_the_bucket_cap(model):
    jcfg, jp, tcfg, tp = model
    longp = _prompt(50, 13)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=128, prompt_buckets=[16, 32],
                        prefill_chunk=16)
    assert _run(eng, [eng.submit(longp, 4)]) == [_ref(tp, tcfg, longp, 4)]
    kw = dict(slots=2, max_len=128, prompt_buckets=[16, 32], prefill_chunk=0)
    with pytest.raises(ValueError, match="largest") as je:
        JaxEngine(jp, jcfg, **kw).submit(longp, 4)
    with pytest.raises(ValueError, match="largest") as te:
        ServingEngine(tp, tcfg, **kw).submit(longp, 4)
    assert str(te.value) == str(je.value)


def test_misaligned_max_len_falls_back_to_the_wave(model):
    """max_len 20, chunk 8, an 18-token prompt: the padded last chunk would
    pass max_len, so it takes the wave, as in JAX, with JAX's tokens."""
    jcfg, jp, tcfg, tp = model
    prompt = _prompt(18, 14)
    want = JaxEngine(jp, jcfg, slots=1, max_len=20, prefill_chunk=8).serve_all([prompt], 2)
    eng = ServingEngine(tp, tcfg, slots=1, max_len=20, prefill_chunk=8)
    got = eng.serve_all([prompt], 2)
    assert eng.stats()["chunked_prefills"] == 0
    assert got == [list(map(int, x)) for x in want] == [_ref(tp, tcfg, prompt, 2)]


def test_misaligned_without_a_bucket_is_rejected_at_submit(model):
    jcfg, jp, tcfg, tp = model
    kw = dict(slots=1, max_len=20, prefill_chunk=8, prompt_buckets=[8])
    with pytest.raises(ValueError, match="max_len") as je:
        JaxEngine(jp, jcfg, **kw).submit(np.ones(18, np.int32), 2)
    with pytest.raises(ValueError, match="max_len") as te:
        ServingEngine(tp, tcfg, **kw).submit(np.ones(18, np.int32), 2)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [dict(max_len=20, prefill_chunk=8, prompt_buckets=[8]),
                                dict(max_len=128, prefill_chunk=16, prompt_buckets=[16, 32]),
                                dict(max_len=64, prefill_chunk=0, prompt_buckets=[16]),
                                dict(max_len=100, prefill_chunk=24, prompt_buckets=[16, 32])])
def test_chunk_routing_equals_jax(model, kw):
    jcfg, jp, tcfg, tp = model
    j, t = JaxEngine(jp, jcfg, slots=1, **kw), ServingEngine(tp, tcfg, slots=1, **kw)
    assert [t._chunk_eligible(n) for n in range(1, kw["max_len"] + 1)] == \
        [j._chunk_eligible(n) for n in range(1, kw["max_len"] + 1)]


def test_mid_length_prompts_keep_wave_admission(model):
    jcfg, jp, tcfg, tp = model
    prompts = [_prompt(20, 15 + i) for i in range(3)]
    eng = ServingEngine(tp, tcfg, slots=3, max_len=64, prefill_chunk=8)
    j = JaxEngine(jp, jcfg, slots=3, max_len=64, prefill_chunk=8)
    got = _run(eng, [eng.submit(p, 3) for p in prompts])
    want = _run(j, [j.submit(p, 3) for p in prompts])
    assert got == [list(map(int, x)) for x in want]
    assert eng.stats()["chunked_prefills"] == 0 and eng.stats()["prefill_batches"] == 1


def test_engine_defaults_equal_jax(model):
    jcfg, jp, tcfg, tp = model
    j, t = JaxEngine(jp, jcfg, slots=1, max_len=64), ServingEngine(tp, tcfg, slots=1, max_len=64)
    for name in ("prefill_chunk", "max_prefixes", "ring", "prompt_buckets", "max_top_k"):
        assert getattr(t, name) == getattr(j, name), name


def test_chunked_prefill_under_a_mesh_is_refused(model):
    _, _, tcfg, tp = model
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER,
                                 mesh=np.zeros([1] * len(tmesh.AXIS_ORDER)),
                                 get_local_rank=lambda axis: 0)
    eng = ServingEngine(tp, tcfg, slots=1, max_len=64, prompt_buckets=[16],
                        prefill_chunk=16, mesh=mesh)
    with pytest.raises(NotImplementedError, match="chunked prefill under a mesh.*ROADMAP.md"):
        eng.submit(np.ones(40, np.int32), 2)
    with pytest.raises(NotImplementedError, match="with_logprobs.*ROADMAP.md"):
        tdecode.generate(tp, torch.ones((1, 4), dtype=torch.int32), tcfg, 2,
                         with_logprobs=True, mesh=mesh)
