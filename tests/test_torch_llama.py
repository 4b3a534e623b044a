"""kubedl_tpu_torch/models/llama.py against the JAX package's llama on the
same parameters (carried across with utils/convert.py): forward logits in
f32 with the Gemma-2 and Qwen2 family knobs and RoPE scaling on and off,
and the pieces the forward is built from."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

VARIANTS = {
    "base": dict(),
    "gemma2": dict(attn_logit_softcap=20.0, final_logit_softcap=15.0,
                   post_block_norms=True, norm_offset=1.0, embed_scale=11.3,
                   query_pre_attn_scalar=24.0, act="gelu_tanh",
                   head_dim_override=24, tie_embeddings=True),
    "qwen2": dict(attn_qkv_bias=True, layer_windows=(None, 5)),
    "sliding": dict(sliding_window=6),
    "rope_llama3": dict(rope_scaling=jllama.RopeScaling(
        "llama3", 8.0, original_max_position_embeddings=32)),
    "rope_linear": dict(rope_scaling=jllama.RopeScaling("linear", 4.0),
                        rope_theta=500000.0),
}


def _pair(variant, use_flash, seed=0):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=use_flash,
                                   **VARIANTS[variant])
    jparams = jllama.init(jcfg, jax.random.PRNGKey(seed))
    if jcfg.attn_qkv_bias:  # init zeroes the biases; make them matter
        rng = np.random.default_rng(seed)
        for layer in jparams["layers"]:
            for name in ("bq", "bk", "bv"):
                layer[name] = jnp.asarray(
                    rng.standard_normal(layer[name].shape, np.float32) * 0.5)
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams))


def _tokens(b, t, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax_f32(variant):
    # the JAX side runs its Pallas kernel (interpret mode) for the plain
    # llama; the family variants use its attention_reference, which the
    # flash tests hold equal to the kernel
    jcfg, jparams, tcfg, tparams = _pair(variant, use_flash=variant == "base")
    toks = _tokens(2, 12, jcfg.vocab_size)
    j = np.asarray(jax.jit(lambda p, x: jllama.forward(p, x, jcfg))(
        jparams, jnp.asarray(toks)))
    t = tllama.forward(tparams, torch.from_numpy(toks), tcfg)
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    scale = np.abs(j).max()
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0), ("llama3", 8.0)])
def test_rope_freqs_bit_identical(scaling):
    js = None if scaling is None else jllama.RopeScaling(*scaling)
    ts = None if scaling is None else tllama.RopeScaling(*scaling)
    a = jllama._rope_freqs(64, 10000.0, js)
    b = tllama._rope_freqs(64, 10000.0, ts)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 16), np.float32)
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    j = jllama._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    t = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    w = rng.standard_normal(16, np.float32)
    j = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset=1.0)
    t = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, offset=1.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_init_matches_jax_tree_and_statistics():
    jcfg = jllama.LlamaConfig.tiny(attn_qkv_bias=True, post_block_norms=True)
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    jp = jax.device_get(jllama.init(jcfg, jax.random.PRNGKey(0)))
    tp = tllama.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert tllama.param_count(tp) == jllama.param_count(jp)
    for name in jp["layers"][0]:
        a, b = np.asarray(jp["layers"][0][name]), tp["layers"][0][name]
        assert tuple(b.shape) == a.shape, name
        assert str(b.dtype).split(".")[1] == a.dtype.name, name
    # truncated normal in [-2, 2] / sqrt(fan_in): same support and scale
    w = tp["layers"][0]["w1"].float()
    fan = tcfg.d_model
    assert w.abs().max().item() <= 2.0 / fan ** 0.5 + 1e-6
    assert abs(w.std().item() * fan ** 0.5 - 0.88) < 0.05
    # a generator makes the draw reproducible
    again = tllama.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


def test_unported_paths_raise():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, n_experts=4)
    with pytest.raises(NotImplementedError):
        tllama.init(cfg, device="cpu")
    from kubedl_tpu_torch.models import quant

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quant.matmul(torch.zeros(2, 2), {"q": torch.zeros(2, 2), "s": torch.ones(2)})
    with pytest.raises(ValueError):
        tllama.LlamaConfig.config_for("llama-70b")
