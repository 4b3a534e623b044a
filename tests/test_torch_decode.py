"""kubedl_tpu_torch/models/decode.py against the JAX package's decode on the
same f32 parameters, with the JAX side on its flash kernel (use_flash=True,
interpret mode here): prefill, ragged and uniform decode steps, block
steps and greedy generate, token for token."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import decode as jdecode
from kubedl_tpu.models import llama as jllama
from kubedl_tpu_torch.models import decode as tdecode
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=True)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams))


def _jprefill(jcfg):
    return jax.jit(lambda p, x, c, n: jdecode.prefill(p, x, c, jcfg, lengths=n))


def _prompts(b, t, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (b, t)).astype(np.int32)


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def test_prefill_ragged_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _prompts(3, 20)
    lengths = np.array([20, 7, 13], np.int32)
    jc = jdecode.init_kv_cache(jcfg, 3, 32)
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc, jnp.asarray(lengths))
    tc = tdecode.init_kv_cache(tcfg, 3, 32, device="cpu")
    tl, tc = tdecode.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                             lengths=torch.from_numpy(lengths))
    _close(tl, jl)
    np.testing.assert_array_equal(tc["lengths"].numpy(), lengths)
    for i in range(tcfg.n_layers):  # every written position, pads included
        _close(tc["k"][i][:, :, :20], np.asarray(jc["k"][i])[:, :, :20])
        _close(tc["v"][i][:, :, :20], np.asarray(jc["v"][i])[:, :, :20])


@pytest.mark.parametrize("uniform", [True, False])
def test_decode_steps_match_jax(model, uniform):
    jcfg, jp, tcfg, tp = model
    toks = _prompts(2, 9, 1)
    lengths = None if uniform else np.array([9, 4], np.int32)
    jc = jdecode.init_kv_cache(jcfg, 2, 16, uniform=uniform)
    tc = tdecode.init_kv_cache(tcfg, 2, 16, uniform=uniform, device="cpu")
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc,
                             None if uniform else jnp.asarray(lengths))
    tl, tc = tdecode.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                             lengths=None if uniform else torch.from_numpy(lengths))
    step = jax.jit(lambda p, x, c: jdecode.decode_step(p, x, c, jcfg))
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        tl, tc = tdecode.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_block_step_matches_jax(model, ragged):
    jcfg, jp, tcfg, tp = model
    toks = _prompts(2, 6, 2)
    block = _prompts(2, 4, 3)
    lengths = np.array([6, 3], np.int32) if ragged else None
    jc = jdecode.init_kv_cache(jcfg, 2, 16, uniform=not ragged)
    tc = tdecode.init_kv_cache(tcfg, 2, 16, uniform=not ragged, device="cpu")
    _, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc,
                            None if lengths is None else jnp.asarray(lengths))
    _, tc = tdecode.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                            lengths=None if lengths is None else torch.from_numpy(lengths))
    jl, jc = jax.jit(lambda p, x, c: jdecode.decode_block_step(p, x, c, jcfg))(
        jp, jnp.asarray(block), jc)
    tl, tc = tdecode.decode_block_step(tp, torch.from_numpy(block), tc, tcfg)
    _close(tl, jl)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_matches_jax_token_for_token(model, ragged):
    jcfg, jp, tcfg, tp = model
    toks = _prompts(3, 11, 4)
    lengths = np.array([11, 5, 8], np.int32) if ragged else None
    jl = None if lengths is None else jnp.asarray(lengths)
    j = jax.jit(lambda p, x, n: jdecode.generate(p, x, jcfg, 8, lengths=n))(
        jp, jnp.asarray(toks), jl)
    t = tdecode.generate(tp, torch.from_numpy(toks), tcfg, 8,
                         lengths=None if lengths is None else torch.from_numpy(lengths))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# the family configs of test_torch_llama.py's VARIANTS and one KV head; the
# JAX side runs its attention_reference (use_flash=False), which the flash
# tests hold equal to its kernel
DECODE_VARIANTS = {
    "gemma2": dict(attn_logit_softcap=20.0, final_logit_softcap=15.0,
                   post_block_norms=True, norm_offset=1.0, embed_scale=11.3,
                   query_pre_attn_scalar=24.0, act="gelu_tanh",
                   head_dim_override=24, tie_embeddings=True),
    "qwen2": dict(attn_qkv_bias=True, layer_windows=(None, 5)),
    "sliding": dict(sliding_window=6),
    "rope_llama3": dict(rope_scaling=jllama.RopeScaling(
        "llama3", 8.0, original_max_position_embeddings=32)),
    "kv1": dict(n_kv_heads=1),
}


@pytest.fixture(scope="module", params=list(DECODE_VARIANTS))
def variant_model(request):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False,
                                   **DECODE_VARIANTS[request.param])
    jparams = jllama.init(jcfg, jax.random.PRNGKey(1))
    if jcfg.attn_qkv_bias:  # init zeroes the biases; make them matter
        rng = np.random.default_rng(1)
        for layer in jparams["layers"]:
            for name in ("bq", "bk", "bv"):
                layer[name] = jnp.asarray(rng.standard_normal(layer[name].shape, np.float32) * 0.5)
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams))


@pytest.mark.parametrize("uniform", [True, False])
def test_variant_decode_matches_jax(variant_model, uniform):
    """Prefill, then 8 greedy decode steps, on each family config: logits
    within 1e-4 of max|JAX| at every step and the same tokens."""
    jcfg, jp, tcfg, tp = variant_model
    toks = _prompts(2, 11, 6)
    lengths = None if uniform else np.array([11, 6], np.int32)
    jc = jdecode.init_kv_cache(jcfg, 2, 24, uniform=uniform)
    tc = tdecode.init_kv_cache(tcfg, 2, 24, uniform=uniform, device="cpu")
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc,
                             None if uniform else jnp.asarray(lengths))
    tl, tc = tdecode.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                             lengths=None if uniform else torch.from_numpy(lengths))
    _close(tl, jl)
    step = jax.jit(lambda p, x, c: jdecode.decode_step(p, x, c, jcfg))
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        tl, tc = tdecode.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["lengths"].numpy(), np.asarray(jc["lengths"]))


def test_sampled_generate_is_seeded_and_in_range(model):
    _, _, tcfg, tp = model
    toks = torch.from_numpy(_prompts(2, 5, 5))
    a = tdecode.generate(tp, toks, tcfg, 6, temperature=0.8,
                         generator=torch.Generator().manual_seed(7))
    b = tdecode.generate(tp, toks, tcfg, 6, temperature=0.8,
                         generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_cache_guards(model):
    _, _, tcfg, tp = model
    int8 = tdecode.init_kv_cache(tcfg, 1, 8, kv_dtype="int8", device="cpu")
    assert int8["k"][0].dtype == torch.int8 and int8["ks"][0].dtype == torch.bfloat16
    assert int8["ks"][0].shape == (1, tcfg.n_kv_heads, 8) and bool((int8["vs"][1] == 1).all())
    with pytest.raises(NotImplementedError):
        tdecode.init_kv_cache(tcfg, 1, 8, ring=True, device="cpu")
    with pytest.raises(ValueError):
        tdecode.init_kv_cache(tcfg, 1, 8, kv_dtype="fp8", device="cpu")
    cache = tdecode.init_kv_cache(tcfg, 1, 4, device="cpu")
    _, cache = tdecode.prefill(tp, torch.ones(1, 4, dtype=torch.int32), cache, tcfg)
    with pytest.raises(ValueError, match="overflows"):
        tdecode.decode_step(tp, torch.ones(1, dtype=torch.int32), cache, tcfg)
    uni = tdecode.init_kv_cache(tcfg, 1, 8, uniform=True, device="cpu")
    with pytest.raises(ValueError):
        tdecode.prefill(tp, torch.ones(1, 4, dtype=torch.int32), uni, tcfg,
                        lengths=torch.tensor([4]))
    with pytest.raises(ValueError):
        tdecode.generate(tp, torch.ones(1, 4, dtype=torch.int32), tcfg, 6, max_len=8)


@pytest.fixture(scope="module")
def moe_models():
    """A tiny MoE llama (4 experts, top 2) in f32, bf16 and int8 (f32
    activations, quant.quantize_params weights) in both packages."""
    from kubedl_tpu.models import quant as jquant
    from kubedl_tpu_torch.models import quant as tquant

    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jcfg = jllama.LlamaConfig.tiny(dtype=dtype, use_flash=True, n_experts=4,
                                       expert_top_k=2)
        jparams = jllama.init(jcfg, jax.random.PRNGKey(7))
        tcfg = config_from_fields(**dataclasses.asdict(jcfg))
        out[name] = (jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams)))
    jcfg, jp, tcfg, tp = out["f32"]
    out["int8"] = (jcfg, jquant.quantize_params(jp), tcfg, tquant.quantize_params(tp))
    return out


@pytest.mark.parametrize("weights,ragged", [("f32", False), ("f32", True), ("bf16", True),
                                            ("int8", True)])
def test_moe_greedy_generate_matches_jax_token_for_token(moe_models, weights, ragged):
    """Prefill and every decode step route through the MoE layers (the JAX
    side's gmm kernels in interpret mode, the port's plain versions)."""
    jcfg, jp, tcfg, tp = moe_models[weights]
    toks = _prompts(3, 10, 8)
    lengths = np.array([10, 4, 7], np.int32) if ragged else None
    jl = None if lengths is None else jnp.asarray(lengths)
    j = jax.jit(lambda p, x, n: jdecode.generate(p, x, jcfg, 6, lengths=n))(
        jp, jnp.asarray(toks), jl)
    t = tdecode.generate(tp, torch.from_numpy(toks), tcfg, 6,
                         lengths=None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_moe_decode_step_logits_match_jax(moe_models):
    """f32 logits of a MoE prefill and two ragged decode steps within 1e-4."""
    jcfg, jp, tcfg, tp = moe_models["f32"]
    toks = _prompts(2, 9, 9)
    lengths = np.array([9, 5], np.int32)
    jc = jdecode.init_kv_cache(jcfg, 2, 16)
    tc = tdecode.init_kv_cache(tcfg, 2, 16, device="cpu")
    jl, jc = _jprefill(jcfg)(jp, jnp.asarray(toks), jc, jnp.asarray(lengths))
    tl, tc = tdecode.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                             lengths=torch.from_numpy(lengths))
    _close(tl, jl)
    step = jax.jit(lambda p, x, c: jdecode.decode_step(p, x, c, jcfg))
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        tl, tc = tdecode.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
