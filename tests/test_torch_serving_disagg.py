"""The port's disaggregated serving plane (kubedl_tpu_torch/serving/) on the
CPU, held to the JAX package's kubedl_tpu/serving/ on the same f32
weights (utils/convert.py) and to the port's own monolithic ServingEngine:

  * the facade's greedy tokens equal the JAX `DisaggregatedEngine`'s and
    the port `ServingEngine`'s, dense and MoE (4 experts, top 2), bucketed
    and chunked; its sampled tokens equal the port engine's for one seed
    (the JAX engine draws from another generator, so sampled tokens are
    compared within the port);
  * prefix sharing, eviction under pool pressure: tokens unchanged, pool
    and prefix statistics equal to JAX's;
  * the handoff npz is byte for byte the JAX package's both ways, f32 and
    bf16 (one zip timestamp for both);
  * the router: cross-pod parity in memory, over a DirChannel and over the
    port's socket plane, drain migration, hard-failure reroute, overlong
    submits refused, pool-pressure eviction, a weight rollout adopted from
    a JAX weight record;
  * the rollout engine: behavior logprobs against a teacher-forced
    `sequence_logprobs`, a second wave of the same prompts admitted on
    the first's prompt blocks, pool statistics equal to JAX's.

The JAX side runs plain attention (use_flash=False, as
tests/test_serving_disagg.py does); the port's flash wrapper takes its
plain version on CPU tensors. Greedy tokens are compared exactly."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses
import zipfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.serving import DisaggregatedEngine as JaxDisagg
from kubedl_tpu.serving import handoff as jhandoff
from kubedl_tpu.serving.rollout import RolloutEngine as JaxRollout
from kubedl_tpu.serving.router import DecodePod as JaxDecodePod
from kubedl_tpu.serving.router import PrefillPod as JaxPrefillPod
from kubedl_tpu.serving.router import ServingRouter as JaxRouter
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.serving import (
    DisaggregatedEngine,
    HandoffItem,
    HandoffQueue,
    RolloutEngine,
    deserialize_item,
    serialize_item,
)
from kubedl_tpu_torch.serving.disaggregated import serving_env
from kubedl_tpu_torch.serving.router import (
    DecodePod,
    PrefillPod,
    ServingRouter,
    adopt_weight_payload,
)
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


def _pair(seed=0, **kw):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, **kw)
    jp = jllama.init(jcfg, jax.random.PRNGKey(seed))
    tcfg = config_from_fields(**dict(dataclasses.asdict(jcfg), use_flash=True))
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp))


@pytest.fixture(scope="module")
def model():
    return _pair()


def _ints(rows):
    return [list(map(int, r)) for r in rows]


@pytest.fixture(scope="module")
def baseline(model):
    """Mixed-length greedy traffic and the port's monolithic engine's
    tokens (checked against the JAX facade's in the first test). Greedy
    outputs are schedule-independent, so this one baseline checks the
    facade, undersized pools and every router topology."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tcfg.vocab_size, size=s).astype(np.int32)
               for s in (3, 7, 12, 5, 20, 9)]
    want = ServingEngine(tp, tcfg, slots=3, max_len=64).serve_all(prompts, 8)
    return prompts, want


def test_facade_greedy_tokens_equal_jax_and_the_port_engine(model, baseline):
    jcfg, jp, tcfg, tp = model
    prompts, want = baseline
    jeng = JaxDisagg(jp, jcfg, slots=3, max_len=64, block_size=8)
    jax_tokens = _ints(jeng.serve_all(prompts, max_new_tokens=8))
    eng = DisaggregatedEngine(tp, tcfg, slots=3, max_len=64, block_size=8)
    got = eng.serve_all(prompts, max_new_tokens=8)
    assert got == jax_tokens == want
    st, jst = eng.stats(), jeng.stats()
    assert st["handoffs"] == len(prompts) and st["evictions"] == 0
    # drained: the trash block plus the prompt blocks the index keeps
    assert st["kv_blocks_in_use"] == 1 + len(eng.decode.prefix_index)
    for key in ("kv_blocks_in_use", "alloc_count", "cow_copies", "prefix_entries",
                "prefix_hit_tokens", "admitted", "ticks", "tokens_out"):
        assert st[key] == jst[key], key


def test_facade_sampled_tokens_equal_the_port_engine(model):
    """Plain and filtered sampling with one seed: the facade draws from its
    generator as the monolithic engine does (one draw a prefill cluster,
    one a tick), so the tokens and their logprobs match."""
    _, _, tcfg, tp = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, tcfg.vocab_size, size=s).astype(np.int32)
               for s in (4, 11, 6, 17, 30)]

    def run(eng):
        reqs = []
        for j, p in enumerate(prompts):
            kw = ({"temperature": 0.8} if j % 2 == 0
                  else {"temperature": 0.9, "top_k": 8, "top_p": 0.9})
            reqs.append(eng.submit(p, 8, logprobs=True, **kw))
        while not all(r.done for r in reqs):
            eng.step_block()
        return [r.tokens for r in reqs], [r.token_logprobs for r in reqs]

    want = run(ServingEngine(tp, tcfg, slots=2, max_len=64, seed=7))
    got = run(DisaggregatedEngine(tp, tcfg, slots=2, max_len=64, block_size=8, seed=7))
    assert got[0] == want[0]
    np.testing.assert_allclose(np.concatenate(got[1]), np.concatenate(want[1]),
                               rtol=0, atol=1e-6)


def test_facade_chunked_prompts(model):
    """Chunked prefill at a chunk that does not divide max_len beside a
    short wave-mate: greedy tokens equal the JAX facade's and the port
    engine's; the long prompt sampled alone with one seed equals the port
    engine's (no decode draw falls between its chunks)."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(2)
    long_p = rng.integers(1, tcfg.vocab_size, size=40).astype(np.int32)
    short_p = rng.integers(1, tcfg.vocab_size, size=5).astype(np.int32)
    kw = dict(slots=2, max_len=64, prompt_buckets=[16], prefill_chunk=12)
    want = ServingEngine(tp, tcfg, **kw).serve_all([long_p, short_p], max_new_tokens=6)
    jax_tokens = _ints(JaxDisagg(jp, jcfg, block_size=8, **kw)
                       .serve_all([long_p, short_p], max_new_tokens=6))
    dis = DisaggregatedEngine(tp, tcfg, block_size=8, **kw)
    assert dis.serve_all([long_p, short_p], max_new_tokens=6) == jax_tokens == want
    assert dis.stats()["chunked_prefills"] == 1

    def run_sampled(eng):
        r = eng.submit(long_p, 6, temperature=0.7)
        while not r.done:
            eng.step_block()
        return r.tokens

    assert run_sampled(DisaggregatedEngine(tp, tcfg, block_size=8, seed=3, **kw)) == \
        run_sampled(ServingEngine(tp, tcfg, seed=3, **kw))


def test_prefix_sharing_tokens_and_hit_rate_equal_jax(model):
    """Shared system prompts: sharing never changes tokens, and the hit
    statistics and block accounting equal the JAX facade's."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(4)
    sys_p = rng.integers(1, tcfg.vocab_size, size=24).astype(np.int32)
    full = [np.concatenate([sys_p, rng.integers(1, tcfg.vocab_size, size=5).astype(np.int32)])
            for _ in range(3)]
    kw = dict(slots=2, max_len=64, block_size=8)
    want = DisaggregatedEngine(tp, tcfg, share_prefixes=False, **kw).serve_all(full, 6)
    shared = DisaggregatedEngine(tp, tcfg, **kw)
    jshared = JaxDisagg(jp, jcfg, **kw)
    assert shared.serve_all(full, 6) == want == _ints(jshared.serve_all(full, 6))
    st, jst = shared.stats(), jshared.stats()
    assert st["prefix_hit_tokens"] >= 24 and st["prefix_hit_rate"] > 0
    for key in ("prefix_hit_tokens", "prefix_hit_rate", "prefix_entries",
                "kv_blocks_in_use", "alloc_count", "cow_copies"):
        assert st[key] == jst[key], key
    assert shared.decode.pool.blocks_in_use == 1 + len(shared.decode.prefix_index)


def test_eviction_under_pool_pressure(model, baseline):
    """An undersized pool degrades (evicts the youngest stream, re-prefills
    it later), never corrupts: greedy tokens exact, the same evictions and
    requeues as the JAX facade."""
    jcfg, jp, tcfg, tp = model
    prompts, want = baseline
    kw = dict(slots=3, max_len=64, block_size=8, num_blocks=8, share_prefixes=False)
    eng = DisaggregatedEngine(tp, tcfg, **kw)
    jeng = JaxDisagg(jp, jcfg, **kw)
    assert eng.serve_all(prompts, max_new_tokens=8) == want
    assert _ints(jeng.serve_all(prompts, max_new_tokens=8)) == want
    st, jst = eng.stats(), jeng.stats()
    assert st["evictions"] + st["requeues"] > 0 and st["kv_blocks_in_use"] == 1
    assert (st["evictions"], st["requeues"], st["alloc_count"]) == \
        (jst["evictions"], jst["requeues"], jst["alloc_count"])


def test_moe_facade_greedy_equals_jax():
    """A tiny MoE llama (4 experts, top 2): the facade's greedy tokens
    equal the JAX facade's over two bucket clusters and slot reuse."""
    jcfg, jp, tcfg, tp = _pair(5, n_experts=4, expert_top_k=2)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (3, 12, 40, 70)]
    want = _ints(JaxDisagg(jp, jcfg, slots=2, max_len=128).serve_all(prompts, 5))
    assert DisaggregatedEngine(tp, tcfg, slots=2, max_len=128).serve_all(prompts, 5) == want


@pytest.mark.parametrize("kw,match", [({"kv_dtype": "int8"}, "int8"), ({"ring": True}, "ring")])
def test_facade_refuses_int8_kv_and_ring_caches(model, kw, match):
    _, _, tcfg, tp = model
    with pytest.raises(ValueError, match=match):
        DisaggregatedEngine(tp, tcfg, slots=2, max_len=64, **kw)


def test_serving_env_and_from_env(model, monkeypatch):
    from kubedl_tpu.serving.disaggregated import serving_env as jserving_env

    _, _, tcfg, tp = model
    env = {"KUBEDL_SERVING_ROLE": "decode", "KUBEDL_SERVING_SLOTS": "3",
           "KUBEDL_SERVING_MAX_LEN": "64", "KUBEDL_SERVING_BLOCK_SIZE": "8",
           "KUBEDL_SERVING_KV_BLOCKS": "20", "KUBEDL_SERVING_SHARE_PREFIXES": "0"}
    assert serving_env(env) == jserving_env(env)
    assert serving_env({}) == jserving_env({})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = DisaggregatedEngine.from_env(tp, tcfg, slots=2)
    assert (eng.role, eng.slots, eng.max_len, eng.decode.pool.num_blocks,
            eng.decode.prefix_index) == ("decode", 2, 64, 20, None)


# ---------------------------------------------------------------------------
# handoff wire
# ---------------------------------------------------------------------------


def _items(dtype):
    """The same handoff item in both packages' forms."""
    rng = np.random.default_rng(5)
    ks = [rng.normal(size=(8, 2, 4)).astype(np.float32) for _ in range(2)]
    vs = [rng.normal(size=(8, 2, 4)).astype(np.float32) for _ in range(2)]
    meta = {"request_id": 3, "max_new_tokens": 8, "temperature": 0.5, "top_k": 0,
            "top_p": 1.0, "eos_token": None, "model_version": 0}
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    common = dict(request=object(), prompt=np.arange(7, dtype=np.int32), total_len=7,
                  start=0, first_token=42, first_logprob=-1.5, meta=meta)
    j = jhandoff.HandoffItem(rows_k=[jnp.asarray(a, jd) for a in ks],
                             rows_v=[jnp.asarray(a, jd) for a in vs], **common)
    t = HandoffItem(rows_k=[torch.from_numpy(a).to(td) for a in ks],
                    rows_v=[torch.from_numpy(a).to(td) for a in vs], **common)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_handoff_npz_byte_identical_both_ways(dtype):
    """Under one zip timestamp the port's payload IS the JAX package's; a
    JAX payload decodes in the port (bf16 without ml_dtypes) and the
    port's decodes in JAX, rows bit for bit."""
    jitem, titem = _items(dtype)
    with mock.patch.object(zipfile.time, "time", lambda: 1.7e9):
        jbytes, tbytes = jhandoff.serialize_item(jitem), serialize_item(titem)
    assert tbytes == jbytes
    back = deserialize_item(jbytes)
    jback = jhandoff.deserialize_item(tbytes)
    assert back.request is None and back.meta == titem.meta == jback.meta
    assert (back.total_len, back.start, back.first_token, back.first_logprob) == \
        (7, 0, 42, -1.5)
    for a, b, c in zip(titem.rows_k + titem.rows_v, back.rows_k + back.rows_v,
                       jback.rows_k + jback.rows_v):
        assert b.dtype == a.dtype and torch.equal(a, b)
        assert str(c.dtype) == dtype
        np.testing.assert_array_equal(np.asarray(c, np.float32), a.float().numpy())


def test_handoff_refusals_and_queue(model):
    _, titem = _items("float32")
    titem.matched_blocks = [3]
    with pytest.raises(ValueError, match="prefix"):  # sender-pool block ids
        serialize_item(titem)
    titem.matched_blocks = []
    titem.rows_k = [titem.rows_k[0], titem.rows_k[1].to(torch.bfloat16)]
    with pytest.raises(ValueError, match="mixed"):
        serialize_item(titem)
    q = HandoffQueue(maxlen=1)
    q.put(titem)
    with pytest.raises(RuntimeError, match="full"):
        q.put(titem)
    assert q.get() is titem and q.get() is None
    q.requeue(titem)
    assert len(q) == 1 and q.put_count == 1


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


@pytest.fixture
def handoff_transport(request, tmp_path):
    """The cross-pod hop: the in-memory round trip, a DirChannel, and a
    SocketChannel over the port's authenticated plane (TCP loopback)."""
    kind = request.param
    if kind == "memory":
        yield None
        return
    if kind == "dir":
        from kubedl_tpu_torch.parallel.pipeline_mpmd import DirChannel

        yield DirChannel(str(tmp_path / "kv-hop"))
        return
    from kubedl_tpu_torch.transport import TransportPlane

    plane = TransportPlane(token="serve-tok", service="router", latch=False)
    addr = plane.listen("127.0.0.1:0")
    try:
        yield plane.channel("kv", peer_addr=addr)
    finally:
        plane.close()


def _router(tp, tcfg, slots=2, **kw):
    return ServingRouter(
        [PrefillPod("p0", tp, tcfg, max_len=64)],
        [DecodePod("d0", tp, tcfg, slots=slots, max_len=64, block_size=8),
         DecodePod("d1", tp, tcfg, slots=slots, max_len=64, block_size=8)], **kw)


@pytest.mark.parametrize("handoff_transport", ["memory", "dir", "socket"], indirect=True)
def test_router_cross_pod_parity(model, baseline, handoff_transport):
    """1 prefill pod + 2 decode pods with every handoff serialized: the
    tokens equal the monolithic engine's, and the JAX router's on the
    in-memory hop, with the payload carried over a real channel too."""
    jcfg, jp, tcfg, tp = model
    prompts, want = baseline
    router = _router(tp, tcfg, cross_pod=True, transport=handoff_transport)
    got = router.serve_all(prompts, max_new_tokens=8, k=2)
    assert got == want
    st = router.stats()
    assert st["serialized_bytes"] > 0 and st["handoffs_total"] == len(prompts)
    assert all(p["admitted"] > 0 for p in st["decode_pods"])
    if handoff_transport is None:
        jr = JaxRouter([JaxPrefillPod("p0", jp, jcfg, max_len=64)],
                       [JaxDecodePod(n, jp, jcfg, slots=2, max_len=64, block_size=8)
                        for n in ("d0", "d1")], cross_pod=True)
        assert _ints(jr.serve_all(prompts, max_new_tokens=8, k=2)) == want
        assert [p["admitted"] for p in jr.stats()["decode_pods"]] == \
            [p["admitted"] for p in st["decode_pods"]]


def test_router_transport_requires_cross_pod(model):
    _, _, tcfg, tp = model
    with pytest.raises(ValueError, match="cross_pod"):
        _router(tp, tcfg, cross_pod=False, transport=object())
    with pytest.raises(ValueError, match=">= 1 prefill"):
        ServingRouter([], [DecodePod("d0", tp, tcfg, max_len=64, block_size=8)])


def test_router_drain_migrates_mid_stream(model, baseline):
    """Draining a decode pod mid-stream migrates its requests (prompt +
    emitted tokens re-prefilled elsewhere) with token-exact greedy
    continuations; the drained pod takes no new work."""
    _, _, tcfg, tp = model
    prompts, want = baseline
    router = _router(tp, tcfg, cross_pod=True)
    pods = router.decode_pods
    reqs = [router.submit(p, 8) for p in prompts]
    for _ in range(3):
        router.step_all(k=2)
    victim = "d0" if pods[0].in_flight() else "d1"
    moved = router.drain(victim)
    assert moved > 0
    while not all(r.done for r in reqs):
        router.step_all(k=2)
    assert [r.tokens for r in reqs] == want
    assert router.stats()["migrations"] == moved
    assert not router._find(victim).in_flight()


def test_router_hard_failure_reroutes(model, baseline):
    _, _, tcfg, tp = model
    prompts, want = baseline
    router = _router(tp, tcfg, slots=3)
    reqs = [router.submit(p, 8) for p in prompts]
    for _ in range(2):
        router.step_all(k=2)
    router.fail("d0")
    while not all(r.done for r in reqs):
        router.step_all(k=2)
    assert [r.tokens for r in reqs] == want
    # a failed prefill pod with no replacement fails its queue loudly
    r = router.submit(prompts[0], 4)
    router.fail("p0")
    assert r.done and "no eligible replacement" in r.error


def test_router_rejects_overlong_submit(model):
    _, _, tcfg, tp = model
    router = _router(tp, tcfg)
    with pytest.raises(ValueError, match="exceeds max_len"):
        router.submit(np.arange(1, 60, dtype=np.int32), 8)
    with pytest.raises(ValueError, match="empty"):
        router.submit(np.asarray([], np.int32), 8)
    with pytest.raises(ValueError, match="top_k"):
        router.submit(np.arange(1, 5, dtype=np.int32), 4, top_k=10**6)


def test_router_pool_pressure_evicts_and_reroutes(model, baseline):
    """An undersized decode pool: the pod evicts its youngest stream and
    the router re-routes it as a continuation; un-evicted streams stay
    token-exact, evicted ones keep their emitted prefix."""
    _, _, tcfg, tp = model
    prompts, want = baseline
    router = ServingRouter(
        [PrefillPod("p0", tp, tcfg, max_len=64)],
        [DecodePod("d0", tp, tcfg, slots=3, max_len=64, block_size=8, num_blocks=7)])
    evicted = {}
    inner = router._resubmit

    def spy(req):
        evicted[req.request_id] = list(req.tokens)
        inner(req)

    router._resubmit = spy
    reqs = [router.submit(p, 8) for p in prompts]
    while not all(r.done for r in reqs):
        router.step_all(k=2)
    assert router.migrations > 0 and evicted
    for r, w in zip(reqs, want):
        assert len(r.tokens) == 8 and r.error is None
        if r.request_id in evicted:
            assert r.tokens[: len(evicted[r.request_id])] == evicted[r.request_id]
        else:
            assert r.tokens == w


def test_router_adopts_a_jax_weight_record(model, baseline):
    """A weight record made by the JAX package (its leaf order) rolls out
    through `adopt_weight_payload`: idle pods commit at once, and the
    fleet serves the new weights' greedy tokens."""
    from kubedl_tpu.rl.weights import encode_weights as jencode

    jcfg, _, tcfg, tp = model
    _, jp2, _, tp2 = _pair(seed=9)
    prompts, _ = baseline
    router = _router(tp, tcfg)
    assert adopt_weight_payload(router, bytes(jencode(jp2, version=1))) == 1
    assert router.rollout_status() == {"target_version": 1, "pods": {
        "p0": 1, "d0": 1, "d1": 1}, "pending": []}
    for a, b in zip(llama.tree_leaves(router.prefill_pods[0].engine.params),
                    llama.tree_leaves(tp2)):
        assert torch.equal(a, b)
    want = ServingEngine(tp2, tcfg, slots=3, max_len=64).serve_all(prompts[:3], 6)
    assert router.serve_all(prompts[:3], 6) == want
    with pytest.raises(ValueError, match="forward"):
        router.begin_weight_rollout(1, tp2)


# ---------------------------------------------------------------------------
# rollout mode
# ---------------------------------------------------------------------------


def test_rollout_logprobs_shared_prompt_blocks_and_pool_equal_jax(model):
    """G samples a prompt with behavior logprobs within 1e-4 of the
    training forward's recompute (f32); the pool's statistics after each
    wave equal the JAX RolloutEngine's on the same shapes; a second wave
    of the same prompts is admitted on the first wave's prompt blocks."""
    from kubedl_tpu_torch.train.preference import sequence_logprobs

    jcfg, jp, tcfg, tp = model
    G, K = 2, 4
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, tcfg.vocab_size, 20)) for _ in range(2)]
    eng = RolloutEngine(tp, tcfg, slots=4, max_len=32, temperature=1.0, seed=0,
                        block_size=8)
    jeng = JaxRollout(jp, jcfg, slots=4, max_len=32, temperature=1.0, seed=0, block_size=8)
    pool_keys = ("kv_blocks_in_use", "alloc_count", "cow_copies", "prefix_entries",
                 "prefix_hit_tokens", "admitted")
    for wave in range(2):
        waves = eng.rollout(prompts, G, K)
        jeng.rollout(prompts, G, K)
        st, jst = eng.stats(), jeng.stats()
        assert {k: st[k] for k in pool_keys} == {k: jst[k] for k in pool_keys}
        assert len(waves) == 2 and all(len(g) == G for g in waves)
        for p, grp in zip(prompts, waves):
            for toks, lps in grp:
                assert len(toks) == K and len(lps) == K
                full = torch.tensor([p + toks], dtype=torch.int32)
                with torch.no_grad():
                    (grid, _), _ = sequence_logprobs(
                        tp, full, torch.tensor([len(p)]), torch.tensor([len(p) + K]),
                        tcfg, with_aux=True, per_token=True)
                np.testing.assert_allclose(grid[0, len(p) - 1:len(p) - 1 + K].numpy(),
                                           lps, rtol=0, atol=1e-4)
    # wave 2: each of the 4 requests matched its prompt's 2 full blocks
    assert st["prefix_hit_tokens"] == 2 * G * 16
    assert st["kv_blocks_in_use"] == 1 + st["prefix_entries"] == 1 + 2 * 2
    eng.swap_params(llama.tree_map(lambda t: t.clone(), tp))
    eng.engine.submit(prompts[0], 2)
    with pytest.raises(RuntimeError, match="in flight"):
        eng.swap_params(tp)
    with pytest.raises(ValueError, match="temperature"):
        RolloutEngine(tp, tcfg, temperature=0.0)
    with pytest.raises(ValueError, match="group_size"):
        eng.rollout(prompts, 1, K)
