"""kubedl_tpu_torch/utils/convert.py: the JAX params tree carries across
to torch tensors and back bit for bit (bf16 included), and a JAX
LlamaConfig's fields build the port's config."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.utils import convert


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_params_round_trip_is_bit_exact(dtype):
    cfg = jllama.LlamaConfig.tiny(dtype=dtype, attn_qkv_bias=True,
                                  post_block_norms=True)
    jparams = jax.device_get(jllama.init(cfg, jax.random.PRNGKey(3)))
    tparams = convert.params_from_numpy(jparams, device="cpu")
    back = convert.params_to_numpy(tparams)
    jflat, tflat, bflat = (dict(_flat(t)) for t in (jparams, tparams, back))
    assert jflat.keys() == tflat.keys() == bflat.keys()
    for name, a in jflat.items():
        t = tflat[name]
        assert tuple(t.shape) == a.shape, name
        assert t.dtype == convert.torch_dtype(a.dtype), name
        assert bflat[name].dtype == a.dtype, name
        bits = np.dtype(f"u{a.dtype.itemsize}")
        np.testing.assert_array_equal(bflat[name].view(bits), np.asarray(a).view(bits))
    # bf16 values survive exactly: compare through f32 as well
    emb = tflat["embed"].float().numpy()
    np.testing.assert_array_equal(emb, np.asarray(jflat["embed"]).astype(np.float32))


def test_params_from_numpy_casts_floats_only():
    tree = {"w": np.ones((2, 2), np.float32), "i": np.arange(3, dtype=np.int32)}
    out = convert.params_from_numpy(tree, dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int32


@pytest.mark.parametrize("factory", ["tiny", "bench_150m", "bench_1b", "llama_7b"])
def test_config_factories_match_jax(factory):
    j = getattr(jllama.LlamaConfig, factory)()
    t = getattr(tllama.LlamaConfig, factory)()
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.keys() == td.keys()
    jd.pop("dtype"), td.pop("dtype")
    assert jd == td
    assert t.dtype == torch.bfloat16 and t.head_dim == j.head_dim


def test_config_from_fields_carries_every_knob():
    j = jllama.LlamaConfig.tiny(
        dtype=jnp.float32, rope_scaling=jllama.RopeScaling("llama3", 8.0),
        layer_windows=(None, 16), attn_logit_softcap=30.0, norm_offset=1.0,
        query_pre_attn_scalar=48.0, head_dim_override=24)
    t = convert.config_from_fields(**dataclasses.asdict(j))
    assert t.dtype == torch.float32
    assert t.rope_scaling == tllama.RopeScaling("llama3", 8.0)
    assert t.layer_windows == (None, 16) and t.window_for(1) == 16
    assert t.head_dim == 24 and t.q_prescale == j.q_prescale
    assert llama_param_count(j) == tllama.param_count(
        tllama.init(t, torch.Generator().manual_seed(0), device="cpu"))


def llama_param_count(jcfg):
    return jllama.param_count(jllama.init(jcfg, jax.random.PRNGKey(0)))


def test_torch_dtype_rejects_unknown():
    with pytest.raises(ValueError):
        convert.torch_dtype(np.complex64)


@pytest.mark.parametrize("int8", [False, True])
def test_moe_and_int8_trees_cross_bit_exact(int8):
    """A MoE tree (router f32, [E, in, out] expert stacks) and its int8
    tree ({"q": int8, "s": bf16} leaves) cross to torch and back bit for
    bit, nested dicts and all."""
    from kubedl_tpu.models import quant as jquant

    cfg = jllama.LlamaConfig.tiny(dtype=jnp.bfloat16, n_experts=4, expert_top_k=2)
    jparams = jllama.init(cfg, jax.random.PRNGKey(6))
    if int8:
        jparams = jquant.quantize_params(jparams)
    jparams = jax.device_get(jparams)
    tparams = convert.params_from_numpy(jparams, device="cpu")
    back = convert.params_to_numpy(tparams)
    jflat, tflat, bflat = (dict(_flat(t)) for t in (jparams, tparams, back))
    assert jflat.keys() == tflat.keys() == bflat.keys()
    assert "layers.0.moe.router" in jflat
    assert ("layers.0.moe.w1.q" in jflat) == int8
    for name, a in jflat.items():
        a = np.asarray(a)
        assert tflat[name].dtype == convert.torch_dtype(a.dtype), name
        np.testing.assert_array_equal(bflat[name].view(np.uint8), a.view(np.uint8), name)
