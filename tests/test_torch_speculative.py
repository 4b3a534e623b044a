"""Speculative decoding in kubedl_tpu_torch: decode.generate_speculative
and the engine's speculative rounds, against the JAX package's
(tests/test_decode.py and tests/test_serving_spec.py hold the JAX side to
plain decoding): the same f32 parameters, prompts from a numpy seed.
Greedy tokens and greedy stats (rounds, acceptance) equal JAX's; the
sampled scheme is held by a distribution test, since the two RNGs differ:
a fixed target/draft pair, 1500 seeded draws, the total-variation distance
of the second token's marginal to the exact one below 0.09, as the JAX
test bounds its own."""
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
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.parallel import mesh as tmesh
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


def _port_cfg(jcfg):
    return dataclasses.replace(config_from_fields(**dataclasses.asdict(jcfg)), use_flash=True)


def _tree(jp):
    return params_from_numpy(jax.device_get(jp))


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(use_flash=False, dtype=jnp.float32)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    jd = jllama.init(jcfg, jax.random.PRNGKey(42))  # a draft of other weights
    return jcfg, jp, jd, _port_cfg(jcfg), _tree(jp), _tree(jd)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 256, size=n).astype(np.int32)


@pytest.mark.parametrize("draft", ["other", "self"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_greedy_speculative_matches_jax(models, draft, k):
    """The target's greedy continuation, and JAX's rounds and acceptance
    (a self-draft accepts every draft: acceptance 1.0)."""
    jcfg, jp, jd, tcfg, tp, td = models
    prompt = _prompt(7, k)[None]
    jdraft, tdraft = (jd, td) if draft == "other" else (jp, tp)
    jt, js = jdecode.generate_speculative(jp, jdraft, jnp.asarray(prompt), jcfg, jcfg, 9,
                                          k=k, return_stats=True)
    tt, ts = tdecode.generate_speculative(tp, tdraft, torch.from_numpy(prompt), tcfg, tcfg,
                                          9, k=k, return_stats=True)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tt.tolist() == tdecode.generate(tp, torch.from_numpy(prompt), tcfg, 9).tolist()
    assert ts["rounds"] == int(js["rounds"])
    assert ts["acceptance"] == pytest.approx(float(js["acceptance"]), abs=1e-6)
    if draft == "self":
        assert ts["acceptance"] == 1.0
    plain = tdecode.generate_speculative(tp, tdraft, torch.from_numpy(prompt), tcfg, tcfg, 9, k=k)
    assert torch.equal(plain, tt)


def test_small_draft_and_int8_kv_match_jax(models):
    jcfg, jp, _, tcfg, tp, _ = models
    jdc = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, n_layers=1)
    jdp = jllama.init(jdc, jax.random.PRNGKey(7))
    prompt = _prompt(6, 1)[None]
    jt = jdecode.generate_speculative(jp, jdp, jnp.asarray(prompt), jcfg, jdc, 6, k=4,
                                      kv_dtype="int8")
    tt = tdecode.generate_speculative(tp, _tree(jdp), torch.from_numpy(prompt), tcfg,
                                      _port_cfg(jdc), 6, k=4, kv_dtype="int8")
    assert tt.tolist() == np.asarray(jt).tolist()
    want = tdecode.generate(tp, torch.from_numpy(prompt), tcfg, 6, kv_dtype="int8")
    assert tt.tolist() == want.tolist()


def test_speculative_errors_match_jax(models):
    jcfg, jp, _, tcfg, tp, _ = models
    two = np.ones((2, 5), np.int32)
    other = jllama.LlamaConfig.tiny(dtype=jnp.float32, vocab_size=128)
    for args, kw in (((two, jcfg), {}), ((two[:1], jcfg), dict(k=1)),
                     ((two[:1], other), {})):
        with pytest.raises(ValueError) as je:
            jdecode.generate_speculative(jp, jp, jnp.asarray(args[0]), jcfg, args[1], 4, **kw)
        with pytest.raises(ValueError) as te:
            tdecode.generate_speculative(tp, tp, torch.from_numpy(args[0]), tcfg,
                                         config_from_fields(**dataclasses.asdict(args[1])),
                                         4, **kw)
        assert str(te.value) == str(je.value)


def test_sampled_speculative_samples_the_target_distribution():
    """A mismatched draft, vocabulary 8, temperature 0.7: the second
    token's marginal over 1500 seeded draws against the exact marginal
    sum_t1 p(t1|prompt) p(t2|prompt, t1) from the target's forward (TV <
    0.09); plain sampled generate passes the same check, and the third
    token's marginals of the two samplers agree (TV < 0.12). The draft's
    own exact marginal reads TV > 0.27 (3x the bound), so a sampler that
    accepts every draft fails the bound. The plain draws are one call of
    N rows (each row its own samples from one generator)."""
    V, T, N = 8, 0.7, 1500
    cfg = tllama.LlamaConfig(vocab_size=V, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
                             d_ff=64, max_seq_len=64, dtype=torch.float32, remat=False)
    params = tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    draft = tllama.init(cfg, torch.Generator().manual_seed(99), device="cpu")
    prompt = torch.tensor([[1, 2, 3]], dtype=torch.int32)

    def exact_marginal(p):
        with torch.no_grad():
            p1 = torch.softmax(tllama.forward(p, prompt, cfg)[0, -1] / T, -1)
            seqs = torch.cat([prompt.expand(V, 3),
                              torch.arange(V, dtype=torch.int32)[:, None]], 1)
            p2 = torch.softmax(tllama.forward(p, seqs, cfg)[:, -1] / T, -1)
        return (p1 @ p2).numpy()

    exact = exact_marginal(params)
    assert 0.5 * np.abs(exact_marginal(draft) - exact).sum() > 3 * 0.09
    gen_s, gen_v = torch.Generator().manual_seed(7), torch.Generator().manual_seed(8)
    # generate_speculative is batch 1: N calls on tensors of a few dozen
    # elements, where intra-op threads cost more than the math (and contend
    # with other processes' threads); plain generate takes the N rows at once
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spec = np.stack([tdecode.generate_speculative(params, draft, prompt, cfg, cfg, 3, k=3,
                                                      temperature=T, generator=gen_s)[0].numpy()
                         for _ in range(N)])
        van = tdecode.generate(params, prompt.expand(N, 3), cfg, 3, temperature=T,
                               generator=gen_v).numpy()
    finally:
        torch.set_num_threads(threads)
    assert spec.shape == van.shape == (N, 3)

    def marginal(toks, i):
        return np.bincount(toks[:, i], minlength=V) / len(toks)

    assert 0.5 * np.abs(marginal(spec, 1) - exact).sum() < 0.09
    assert 0.5 * np.abs(marginal(van, 1) - exact).sum() < 0.09
    assert 0.5 * np.abs(marginal(spec, 2) - marginal(van, 2)).sum() < 0.12


# -- the engine's speculative rounds ---------------------------------------------


def _serve(eng, prompts, n, block=False, **kw):
    reqs = [eng.submit(p, n, **kw) for p in prompts]
    while not all(r.done for r in reqs):
        eng.step_block() if block else eng.step()
    return [list(map(int, r.tokens)) for r in reqs]


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("block", [False, True])
def test_spec_engine_matches_jax(models, kv, block):
    """Four prompts over three slots with the other-weights draft: JAX's
    spec engine's tokens, rounds and acceptance, and the plain engine's
    tokens."""
    jcfg, jp, jd, tcfg, tp, td = models
    prompts = [_prompt(n, i) for i, n in enumerate((3, 7, 12, 5))]
    kw = dict(slots=3, max_len=64, kv_dtype=kv)
    j = JaxEngine(jp, jcfg, draft_params=jd, draft_config=jcfg, spec_k=4, **kw)
    want = _serve(j, prompts, 8, block)
    eng = ServingEngine(tp, tcfg, draft_params=td, draft_config=tcfg, spec_k=4, **kw)
    assert _serve(eng, prompts, 8, block) == want
    assert _serve(ServingEngine(tp, tcfg, **kw), prompts, 8, block) == want
    st, js = eng.stats(), j.stats()
    assert st["spec_rounds"] == js["spec_rounds"] > 0
    assert st["spec_acceptance"] == js["spec_acceptance"]


def test_spec_self_draft_full_acceptance(models):
    jcfg, jp, _, tcfg, tp, _ = models
    prompt = _prompt(6, 1)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=64, draft_params=tp, draft_config=tcfg)
    got = _serve(eng, [prompt], 12)
    assert got == _serve(ServingEngine(tp, tcfg, slots=2, max_len=64), [prompt], 12)
    st = eng.stats()
    assert st["spec_acceptance"] > 0.9 and st["spec_rounds"] <= 5, st


def test_spec_midflight_admission_and_eos(models):
    jcfg, jp, jd, tcfg, tp, td = models
    p1, p2 = _prompt(4, 2), _prompt(9, 3)
    eos = _serve(ServingEngine(tp, tcfg, slots=2, max_len=64), [p1], 10)[0][4]

    def drive(eng):
        r1 = eng.submit(p1, 10, eos_token=eos)
        eng.step()
        r2 = eng.submit(p2, 6)
        while not (r1.done and r2.done):
            eng.step()
        return [list(map(int, r1.tokens)), list(map(int, r2.tokens))]

    want = drive(JaxEngine(jp, jcfg, slots=2, max_len=64, draft_params=jd, draft_config=jcfg,
                           spec_k=3))
    assert drive(ServingEngine(tp, tcfg, slots=2, max_len=64, draft_params=td,
                               draft_config=tcfg, spec_k=3)) == want
    assert drive(ServingEngine(tp, tcfg, slots=2, max_len=64)) == want


def test_spec_falls_back_and_resyncs_the_draft(models):
    """A sampled co-tenant forces plain ticks; the greedy request resumes
    speculation with the draft in step (self-draft acceptance stays > 0.9)
    and keeps the plain engine's tokens."""
    _, _, _, tcfg, tp, _ = models
    pg, ps = _prompt(3, 9), _prompt(3, 10)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=64, draft_params=tp, draft_config=tcfg,
                        spec_k=3)
    r_g = eng.submit(pg, 14)
    r_s = eng.submit(ps, 3, temperature=0.9)
    while not (r_g.done and r_s.done):
        eng.step()
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["spec_acceptance"] > 0.9, st
    assert len(r_s.tokens) == 3
    assert r_g.tokens == _serve(ServingEngine(tp, tcfg, slots=2, max_len=64), [pg], 14)[0]
    mixed = ServingEngine(tp, tcfg, slots=2, max_len=64, draft_params=tp, draft_config=tcfg,
                          spec_k=3)
    mixed.submit(pg, 6)
    mixed.submit(ps, 6, temperature=0.9)
    while mixed.has_pending():
        mixed.step()
    assert mixed.stats()["spec_rounds"] == 0  # sampled traffic the whole way


def test_spec_near_capacity_and_chunked_admission(models):
    """26 + 6 == max_len 32: the last rounds lack spec_k headroom and fall
    back to ticks; a prompt past the largest bucket chunks on a spec
    engine and the draft prefills it whole. JAX's tokens both times."""
    jcfg, jp, jd, tcfg, tp, td = models
    for kw, prompt, n in ((dict(max_len=32), _prompt(26, 5), 6),
                          (dict(max_len=64, prefill_chunk=8, prompt_buckets=[8]),
                           _prompt(14, 8), 5)):
        j = JaxEngine(jp, jcfg, slots=2, draft_params=jd, draft_config=jcfg, spec_k=4, **kw)
        eng = ServingEngine(tp, tcfg, slots=2, draft_params=td, draft_config=tcfg, spec_k=4,
                            **kw)
        assert _serve(eng, [prompt], n) == _serve(j, [prompt], n)
        assert eng.stats()["chunked_prefills"] == j.stats()["chunked_prefills"]


def test_spec_engine_refusals(models):
    jcfg, jp, jd, tcfg, tp, td = models
    j = JaxEngine(jp, jcfg, slots=2, max_len=64, draft_params=jd, draft_config=jcfg)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=64, draft_params=td, draft_config=tcfg)
    assert eng.spec_k == j.spec_k == 4
    with pytest.raises(ValueError, match="prefix") as je:
        j.submit(np.array([1, 2], np.int32), 4, prefix_id=0)
    with pytest.raises(ValueError, match="prefix") as te:
        eng.submit(np.array([1, 2], np.int32), 4, prefix_id=0)
    assert str(te.value) == str(je.value)
    ring = dataclasses.replace(tcfg, sliding_window=8)
    bad = [(dict(draft_params=td, draft_config=ring, cfg=ring), "ring"),
           (dict(draft_params=td), "draft_config"),
           (dict(draft_params=td, draft_config=tcfg, spec_k=1), "spec_k"),
           (dict(draft_params=td, draft_config=dataclasses.replace(tcfg, vocab_size=128)),
            "vocab")]
    for kw, match in bad:
        cfg = kw.pop("cfg", tcfg)
        with pytest.raises(ValueError, match=match):
            ServingEngine(tp, cfg, slots=2, max_len=64, **kw)
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER,
                                 mesh=np.zeros([1] * len(tmesh.AXIS_ORDER)),
                                 get_local_rank=lambda axis: 0)
    with pytest.raises(NotImplementedError, match="speculative serving under a mesh"):
        ServingEngine(tp, tcfg, slots=2, max_len=64, draft_params=td, draft_config=tcfg,
                      mesh=mesh)
