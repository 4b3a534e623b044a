"""Ring KV caches of kubedl_tpu_torch/models/decode.py and models/serving.py
against the JAX package's (tests/test_ring_cache.py holds the JAX side to
its own full cache): the same f32 parameters, prompts from a numpy seed.
`_ring_positions` and the buffer shapes are exact, logits within 1e-4 of
max|JAX|, greedy tokens equal, and the guards raise as JAX's do. The port
runs its flash wrapper's CPU path (use_flash=True), the JAX side its plain
attention."""
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

WINDOW = 8


def _port(jcfg, jp):
    tcfg = dataclasses.replace(config_from_fields(**dataclasses.asdict(jcfg)), use_flash=True)
    return tcfg, params_from_numpy(jax.device_get(jp))


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(use_flash=False, dtype=jnp.float32, sliding_window=WINDOW)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    return (jcfg, jp) + _port(jcfg, jp)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("L", [1, 4, 8])
def test_ring_positions_equal_jax(L):
    totals = np.array([0, 1, 3, L, L + 1, 11, 25], np.int32)
    want = np.asarray(jdecode._ring_positions(jnp.asarray(totals), L))
    got = tdecode._ring_positions(torch.from_numpy(totals), L)
    np.testing.assert_array_equal(got.numpy(), want)
    scalar = tdecode._ring_positions(torch.tensor(11), L)
    np.testing.assert_array_equal(scalar.numpy(), np.asarray(jdecode._ring_positions(11, L)))


def test_ring_buffer_shape_and_guards(model):
    jcfg, _, tcfg, _ = model
    for kv in (None, "int8"):
        jc = jdecode.init_kv_cache(jcfg, 2, 64, ring=True, kv_dtype=kv)
        tc = tdecode.init_kv_cache(tcfg, 2, 64, ring=True, kv_dtype=kv, device="cpu")
        assert "ring" in tc and sorted(tc) == sorted(jc)
        for name in jc:
            if name != "ring":
                leaves = jc[name] if isinstance(jc[name], list) else [jc[name]]
                ours = tc[name] if isinstance(tc[name], list) else [tc[name]]
                assert [tuple(t.shape) for t in ours] == [x.shape for x in leaves], name
    plain = jllama.LlamaConfig.tiny(use_flash=False)
    layered = jllama.LlamaConfig.tiny(use_flash=False, sliding_window=WINDOW,
                                      layer_windows=(WINDOW, None))
    for jc, args in ((plain, (1, 32)), (layered, (1, 32)), (jcfg, (1, WINDOW - 1))):
        with pytest.raises(ValueError) as je:
            jdecode.init_kv_cache(jc, *args, ring=True)
        with pytest.raises(ValueError) as te:
            tdecode.init_kv_cache(config_from_fields(**dataclasses.asdict(jc)), *args,
                                  ring=True, device="cpu")
        assert str(te.value) == str(je.value)


def test_ring_decode_matches_jax(model):
    """Token-by-token uniform decode into a ring, well past the wrap:
    the port's logits against JAX's ring and its own full cache."""
    jcfg, jp, tcfg, tp = model
    t, steps = 5, 20  # 25 tokens, window 8: several wraps
    prompt = _prompts((t,), 0)[0][None]
    jr = jdecode.init_kv_cache(jcfg, 1, t + steps, uniform=True, ring=True)
    tr = tdecode.init_kv_cache(tcfg, 1, t + steps, uniform=True, ring=True, device="cpu")
    tf = tdecode.init_kv_cache(tcfg, 1, t + steps, uniform=True, device="cpu")
    tl_full, tf = tdecode.prefill(tp, torch.from_numpy(prompt), tf, tcfg)
    step = jax.jit(lambda p, x, c: jdecode.decode_step(p, x, c, jcfg))
    for i in range(t):
        jl, jr = step(jp, jnp.asarray(prompt[:, i]), jr)
        tl, tr = tdecode.decode_step(tp, torch.from_numpy(prompt[:, i]), tr, tcfg)
        _close(tl, jl)
    _close(tl_full, jl)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = tl.argmax(-1).to(torch.int32)
    for _ in range(steps):
        jl, jr = step(jp, jtok, jr)
        tl, tr = tdecode.decode_step(tp, ttok, tr, tcfg)
        lf, tf = tdecode.decode_step(tp, ttok, tf, tcfg)
        _close(tl, jl)
        _close(lf, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    assert int(tr["lengths"]) == int(jr["lengths"]) == t + steps


@pytest.mark.parametrize("kv", [None, "int8"])
def test_ring_prefill_wraps_like_a_full_cache(model, kv):
    """The port's prefill into a ring keeps each row's last window positions
    in ring order; ragged rows, prompts longer than the window: decoding on
    gives JAX's full-cache logits (the window mask hides the rest)."""
    jcfg, jp, tcfg, tp = model
    toks = np.stack(_prompts((13, 13), 1))
    lengths = np.array([13, 6], np.int32)
    jc = jdecode.init_kv_cache(jcfg, 2, 32, kv_dtype=kv)
    jl, jc = jdecode.prefill(jp, jnp.asarray(toks), jc, jcfg, lengths=jnp.asarray(lengths))
    tc = tdecode.init_kv_cache(tcfg, 2, 32, ring=True, kv_dtype=kv, device="cpu")
    tl, tc = tdecode.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                             lengths=torch.from_numpy(lengths))
    _close(tl, jl)
    for _ in range(6):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jdecode.decode_step(jp, jnp.asarray(tok), jc, jcfg)
        tl, tc = tdecode.decode_step(tp, torch.from_numpy(tok), tc, tcfg)
        _close(tl, jl)


def test_ring_block_steps_are_refused(model):
    jcfg, jp, tcfg, tp = model
    for uniform, T in ((True, 2), (False, 1)):
        jc = jdecode.init_kv_cache(jcfg, 1, 32, uniform=uniform, ring=True)
        tc = tdecode.init_kv_cache(tcfg, 1, 32, uniform=uniform, ring=True, device="cpu")
        with pytest.raises(ValueError) as je:
            jdecode.decode_block_step(jp, jnp.ones((1, T), jnp.int32), jc, jcfg)
        with pytest.raises(ValueError) as te:
            tdecode.decode_block_step(tp, torch.ones((1, T), dtype=torch.int32), tc, tcfg)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_ring_serving_matches_jax_engine(model, kv):
    """Ring on by default (window 8 < max_len 64): ragged slots, mid-flight
    admission, 24 new tokens (3x the window); the JAX engine's tokens."""
    jcfg, jp, tcfg, tp = model
    prompts = _prompts((3, 7, 12, 5), 1)
    want = JaxEngine(jp, jcfg, slots=2, max_len=64, kv_dtype=kv).serve_all(prompts, 24)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=64, kv_dtype=kv)
    assert eng.ring and eng.cache["k"][0].shape[2] == WINDOW and "ring" in eng.cache
    assert eng.serve_all(prompts, 24) == [list(map(int, x)) for x in want]
    full = ServingEngine(tp, tcfg, slots=2, max_len=64, ring=False, kv_dtype=kv)
    assert not full.ring and full.cache["k"][0].shape[2] == 64
    assert eng.stats()["kv_cache_bytes"] * 8 == full.stats()["kv_cache_bytes"]
    if kv is None:
        assert full.serve_all(prompts, 24) == [list(map(int, x)) for x in want]


def test_ring_engine_refusals_match_jax(model):
    jcfg, jp, tcfg, tp = model
    j = JaxEngine(jp, jcfg, slots=2, max_len=64)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=64)
    with pytest.raises(ValueError, match="ring") as je:
        j.register_prefix([1, 2, 3])
    with pytest.raises(ValueError, match="ring") as te:
        eng.register_prefix([1, 2, 3])
    assert str(te.value) == str(je.value)
    # a ring takes no chunked prefill: over the largest bucket is rejected
    eng = ServingEngine(tp, tcfg, slots=1, max_len=64, prompt_buckets=[16], prefill_chunk=16)
    j = JaxEngine(jp, jcfg, slots=1, max_len=64, prompt_buckets=[16], prefill_chunk=16)
    assert not eng._chunk_eligible(32) and not j._chunk_eligible(32)
    with pytest.raises(ValueError, match="largest prompt bucket"):
        eng.submit(np.ones(32, np.int32), 2)
    plain = dataclasses.replace(tcfg, sliding_window=None)
    with pytest.raises(ValueError, match="sliding_window"):
        ServingEngine(tp, plain, slots=1, max_len=64, ring=True)


def test_ring_under_a_mesh_is_refused(model):
    _, _, tcfg, tp = model
    mesh = types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER,
                                 mesh=np.zeros([1] * len(tmesh.AXIS_ORDER)),
                                 get_local_rank=lambda axis: 0)
    with pytest.raises(NotImplementedError, match="ring KV cache under a mesh.*ROADMAP.md"):
        ServingEngine(tp, tcfg, slots=1, max_len=64, mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tdecode.init_kv_cache(tcfg, 1, 64, ring=True, device="cpu", mesh=mesh)
    ServingEngine(tp, tcfg, slots=1, max_len=64, ring=False, mesh=mesh)  # a full cache serves
