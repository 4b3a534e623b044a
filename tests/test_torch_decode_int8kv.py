"""The int8 KV cache of kubedl_tpu_torch/models/decode.py and serving.py
against the JAX package's on the same f32 parameters: `_quantize_kv`'s codes
and scales bit for bit, then prefill, ragged and uniform decode steps, the
block step, greedy generate and the serving engine with kv_dtype="int8"
(logits within 1e-4 of max|JAX|, tokens equal). The JAX side of `tiny`
runs its flash kernel in interpret mode; the family variants run its
attention_reference, as test_torch_decode.py's do."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubedl_tpu.models import decode as jdecode
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models.serving import ServingEngine as JaxEngine
from kubedl_tpu_torch.models import decode as tdecode
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.utils.convert import (config_from_fields, params_from_numpy,
                                            tensor_from_numpy)
from test_torch_decode import DECODE_VARIANTS, _close, _jprefill, _prompts


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=True)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams))


def _kv_rows(dtype):
    """[2, 3, 4, 32] values: random rows, an all-zero row, a row whose amax
    is 127 (scale exactly 1) holding half-integers and both +-amax, and a
    row at -amax only."""
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 32)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0
    x[1, 0, 1] = 0.0
    x[1, 0, 1, :8] = [127.0, -127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 1.5]
    x[1, 2, 3] = -np.abs(x[1, 2, 3])
    x[1, 2, 3, 5] = -4.0 * np.abs(x[1, 2, 3]).max()
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_kv_is_bit_exact(dtype):
    x = _kv_rows(dtype)
    jq, js = jax.jit(jdecode._quantize_kv)(jnp.asarray(x))
    tq, ts = tdecode._quantize_kv(tensor_from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    assert int(tq[1, 0, 1, 2]) == 2 and int(tq[1, 0, 1, 4]) == 4  # half to even
    assert float(ts[0, 1, 2]) == 1.0 and not tq[0, 1, 2].any()    # zero row
    assert int(tq.abs().max()) == 127


@pytest.mark.parametrize("window,softcap", [(None, None), (5, 20.0)])
def test_attend_cached_int8_matches_jax_in_bf16(window, softcap):
    """bf16 queries over int8 codes and scales: the V scale multiplies the
    softmax weights before they are rounded to bf16, as in JAX (ragged
    limits, GQA 2:1, a block of 3 queries)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 3, 32)).astype(ml_dtypes.bfloat16)
    codes = [rng.integers(-127, 128, (2, 2, 16, 32)).astype(np.int8) for _ in range(2)]
    scales = [(rng.random((2, 2, 16)) * 0.05 + 0.01).astype(ml_dtypes.bfloat16)
              for _ in range(2)]
    limits = np.array([[9, 10, 11], [4, 5, 6]], np.int32)
    j = jdecode._attend_cached(jnp.asarray(q), *map(jnp.asarray, codes), jnp.asarray(limits),
                               2, k_scale=jnp.asarray(scales[0]),
                               v_scale=jnp.asarray(scales[1]), window=window, softcap=softcap)
    t = tdecode._attend_cached(tensor_from_numpy(q), *map(tensor_from_numpy, codes),
                               torch.from_numpy(limits), 2,
                               k_scale=tensor_from_numpy(scales[0]),
                               v_scale=tensor_from_numpy(scales[1]),
                               window=window, softcap=softcap)
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max())


def _caches(jcfg, tcfg, b, L, uniform):
    return (jdecode.init_kv_cache(jcfg, b, L, uniform=uniform, kv_dtype="int8"),
            tdecode.init_kv_cache(tcfg, b, L, uniform=uniform, kv_dtype="int8",
                                  device="cpu"))


def _prefill_both(jcfg, jp, tcfg, tp, toks, lengths, jc, tc):
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc,
                             None if lengths is None else jnp.asarray(lengths))
    tl, tc = tdecode.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                             lengths=None if lengths is None else torch.from_numpy(lengths))
    return jl, jc, tl, tc


def _steps_match(jcfg, jp, tcfg, tp, toks, lengths, L, n_steps):
    """Prefill into int8 caches, then greedy decode steps: logits within
    1e-4 of max|JAX| at every step, the same tokens, the same lengths."""
    jc, tc = _caches(jcfg, tcfg, toks.shape[0], L, lengths is None)
    jl, jc, tl, tc = _prefill_both(jcfg, jp, tcfg, tp, toks, lengths, jc, tc)
    _close(tl, jl)
    step = jax.jit(lambda p, x, c: jdecode.decode_step(p, x, c, jcfg))
    for _ in range(n_steps):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        tl, tc = tdecode.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))
    assert tc["k"][0].dtype == torch.int8 and tc["vs"][0].dtype == torch.bfloat16
    return jc, tc


@pytest.mark.parametrize("uniform", [True, False])
def test_int8_decode_steps_match_jax(model, uniform):
    jcfg, jp, tcfg, tp = model
    lengths = None if uniform else np.array([9, 4], np.int32)
    jc, tc = _steps_match(jcfg, jp, tcfg, tp, _prompts(2, 9, 1), lengths, 16, 4)
    # the scales of every written position, bf16 rounding of amax/127
    for i in range(tcfg.n_layers):
        for name in ("ks", "vs"):
            np.testing.assert_allclose(tc[name][i][:, :, :13].float().numpy(),
                                       np.asarray(jc[name][i][:, :, :13], np.float32),
                                       rtol=1e-2)


@pytest.mark.parametrize("ragged", [False, True])
def test_int8_decode_block_step_matches_jax(model, ragged):
    jcfg, jp, tcfg, tp = model
    toks, block = _prompts(2, 6, 2), _prompts(2, 4, 3)
    lengths = np.array([6, 3], np.int32) if ragged else None
    jc, tc = _caches(jcfg, tcfg, 2, 16, not ragged)
    _, jc, _, tc = _prefill_both(jcfg, jp, tcfg, tp, toks, lengths, jc, tc)
    jl, jc = jax.jit(lambda p, x, c: jdecode.decode_block_step(p, x, c, jcfg))(
        jp, jnp.asarray(block), jc)
    tl, tc = tdecode.decode_block_step(tp, torch.from_numpy(block), tc, tcfg)
    _close(tl, jl)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jnp.argmax(jl, -1)))
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


@pytest.mark.parametrize("ragged", [False, True])
def test_int8_generate_matches_jax_token_for_token(model, ragged):
    jcfg, jp, tcfg, tp = model
    toks = _prompts(3, 11, 4)
    lengths = np.array([11, 5, 8], np.int32) if ragged else None
    jl = None if lengths is None else jnp.asarray(lengths)
    j = jax.jit(lambda p, x, n: jdecode.generate(p, x, jcfg, 8, lengths=n,
                                                 kv_dtype="int8"))(jp, jnp.asarray(toks), jl)
    t = tdecode.generate(tp, torch.from_numpy(toks), tcfg, 8, kv_dtype="int8",
                         lengths=None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the first token comes from prefill, which does not read the cache
    plain = tdecode.generate(tp, torch.from_numpy(toks), tcfg, 1,
                             lengths=None if lengths is None else torch.from_numpy(lengths))
    assert torch.equal(plain[:, 0], t[:, 0])


INT8_VARIANTS = ("gemma2", "sliding", "kv1")  # softcap, window, one KV head


@pytest.fixture(scope="module", params=INT8_VARIANTS)
def variant_model(request):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False,
                                   **DECODE_VARIANTS[request.param])
    jparams = jllama.init(jcfg, jax.random.PRNGKey(1))
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams))


@pytest.mark.parametrize("uniform", [True, False])
def test_int8_variant_decode_matches_jax(variant_model, uniform):
    """Prefill, then 8 greedy steps over int8 caches on the softcap,
    window and one-KV-head configs of test_variant_decode_matches_jax."""
    jcfg, jp, tcfg, tp = variant_model
    lengths = None if uniform else np.array([11, 6], np.int32)
    _steps_match(jcfg, jp, tcfg, tp, _prompts(2, 11, 6), lengths, 24, 8)


def test_int8_engine_matches_jax_engine(model):
    """ServingEngine(kv_dtype="int8") on prompts of 5, 11 and 8 tokens over
    2 slots (slot reuse): the JAX engine's greedy tokens; stats() reports
    the int8 cache's bytes."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32) for n in (5, 11, 8)]
    j = JaxEngine(jp, jcfg, slots=2, max_len=64, kv_dtype="int8").serve_all(prompts, 4)
    eng = ServingEngine(tp, tcfg, slots=2, max_len=64, kv_dtype="int8")
    assert eng.serve_all(prompts, 4) == [list(map(int, x)) for x in j]
    st = eng.stats()
    # per layer: int8 K and V [2, 2, 64, 32] plus bf16 scales [2, 2, 64]
    assert st["kv_cache_bytes"] == tcfg.n_layers * 2 * (2 * 2 * 64 * 32 + 2 * 2 * 2 * 64)
    assert ServingEngine(tp, tcfg, slots=2, max_len=64).stats()["kv_cache_bytes"] == \
        tcfg.n_layers * 2 * 2 * 2 * 64 * 32 * 4
