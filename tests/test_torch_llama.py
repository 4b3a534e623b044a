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
    """What the port still refuses: ring KV caches and MoE layers in a
    decode under a mesh (the MoE layers, int8 weight leaves, int8 KV caches
    and one-device ring caches that this test once pinned are ported)."""
    import types

    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.parallel.mesh import AXIS_ORDER

    moe = tllama.LlamaConfig.tiny(dtype=torch.float32, n_experts=2)
    mesh = types.SimpleNamespace(  # stand-in: the refusal comes before any collective
        mesh_dim_names=AXIS_ORDER, mesh=np.zeros([2 if a == "tensor" else 1 for a in AXIS_ORDER]),
        get_local_rank=lambda axis: 0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode.prefill(tllama.init(moe, torch.Generator().manual_seed(0), device="cpu"),
                       torch.ones((1, 4), dtype=torch.int32), {}, moe, mesh=mesh)
    windowed = tllama.LlamaConfig.tiny(dtype=torch.float32, sliding_window=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode.init_kv_cache(windowed, 1, 8, ring=True, device="cpu", mesh=mesh)
    assert decode.init_kv_cache(windowed, 1, 8, ring=True, device="cpu")["k"][0].shape[2] == 4
    with pytest.raises(ValueError):
        tllama.LlamaConfig.config_for("llama-70b")


# -- MoE layers ------------------------------------------------------------------

MOE = dict(n_experts=4, expert_top_k=2)
MOE_LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "moe.router",
                    "moe.w1", "moe.w3", "moe.w2")
MOE_LEAVES = (["embed"] + [f"layers.{i}.{k}" for i in range(2) for k in MOE_LAYER_LEAVES]
              + ["final_norm", "lm_head"])


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _moe_case(**knobs):
    """A tiny f32 MoE llama in both packages, its loss, every gradient
    (JAX's value_and_grad, computed once: the gmm kernels run in interpret
    mode) and its logits and aux."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, **{**MOE, **knobs})
    jparams = jllama.init(jcfg, jax.random.PRNGKey(3))
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    tparams = params_from_numpy(jax.device_get(jparams))
    toks = _tokens(2, 17, jcfg.vocab_size, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, x: jllama.loss_fn(p, x, jcfg)))(
        jparams, jnp.asarray(toks))
    jlogits, jaux = jax.jit(lambda p, x: jllama.forward_and_aux(p, x, jcfg))(
        jparams, jnp.asarray(toks[:, :-1]))
    tree = tllama.tree_map(lambda x: x.clone().requires_grad_(True), tparams)
    tloss = tllama.loss_fn(tree, torch.from_numpy(toks), tcfg)
    grads = torch.autograd.grad(tloss, [_leaf(tree, n) for n in MOE_LEAVES])
    with torch.no_grad():
        tlogits, taux = tllama.forward_and_aux(tparams, torch.from_numpy(toks[:, :-1]), tcfg)
    return dict(jloss=float(jloss), jgrads=jax.device_get(jgrads), tloss=tloss.item(),
                tgrads=dict(zip(MOE_LEAVES, grads)), jlogits=np.asarray(jlogits),
                jaux=float(jaux), tlogits=tlogits, taux=taux, tparams=tparams,
                jparams=jparams)


@pytest.fixture(scope="module")
def moe_pair():
    return _moe_case()


# the routes beside the default (dropless, fused SwiGLU, top 2)
MOE_ROUTES = {"dropless_unfused": dict(moe_dropless=True, moe_fused=False),
              "top1_ce_chunks4": dict(expert_top_k=1, ce_chunks=4)}


@pytest.fixture(scope="module", params=list(MOE_ROUTES))
def moe_route_pair(request):
    return _moe_case(**MOE_ROUTES[request.param])


def test_moe_route_loss_matches_jax(moe_route_pair):
    assert abs(moe_route_pair["tloss"] - moe_route_pair["jloss"]) <= \
        1e-4 * abs(moe_route_pair["jloss"])


@pytest.mark.parametrize("name", MOE_LEAVES)
def test_moe_route_gradient_leaf_matches_jax(moe_route_pair, name):
    """Every gradient leaf on the unfused dropless route and on top-1 with
    the chunked CE, within 1e-4 of max|JAX| in f32."""
    j = np.asarray(_leaf(moe_route_pair["jgrads"], name))
    t = moe_route_pair["tgrads"][name]
    assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def test_moe_forward_and_aux_match_jax(moe_pair):
    j, t = moe_pair["jlogits"], moe_pair["tlogits"]
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())
    assert moe_pair["taux"].dim() == 0 and moe_pair["jaux"] > 0
    assert abs(moe_pair["taux"].item() - moe_pair["jaux"]) <= 1e-6


def test_moe_loss_matches_jax(moe_pair):
    """CE plus moe_aux_coef x aux, as the JAX loss_fn adds it."""
    assert abs(moe_pair["tloss"] - moe_pair["jloss"]) <= 1e-4 * abs(moe_pair["jloss"])


@pytest.mark.parametrize("name", MOE_LEAVES)
def test_moe_gradient_leaf_matches_jax(moe_pair, name):
    """Every gradient leaf (router and expert stacks included, through the
    gmm backward and full remat) within 1e-4 of max|JAX| in f32."""
    j = np.asarray(_leaf(moe_pair["jgrads"], name))
    t = moe_pair["tgrads"][name]
    assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


def test_moe_init_matches_jax_tree():
    jcfg = jllama.LlamaConfig.tiny(**MOE)
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    jp = jax.device_get(jllama.init(jcfg, jax.random.PRNGKey(0)))
    tp = tllama.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert tllama.param_count(tp) == jllama.param_count(jp)
    for name in MOE_LAYER_LEAVES:
        a, b = np.asarray(_leaf(jp["layers"][1], name)), _leaf(tp["layers"][1], name)
        assert tuple(b.shape) == a.shape and str(b.dtype).split(".")[1] == a.dtype.name, name
    assert "w1" not in tp["layers"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bit_exact_on_moe_tree(dtype):
    """Every q and s of quant.quantize_params on a MoE tree equals the JAX
    function's bits (the scale rounded to bf16 before the codes); the
    router, norms and embedding pass through."""
    from kubedl_tpu.models import quant as jquant
    from kubedl_tpu_torch.models import quant as tquant
    from kubedl_tpu_torch.utils.convert import params_to_numpy

    jcfg = jllama.LlamaConfig.tiny(dtype=getattr(jnp, dtype), **MOE)
    jp = jllama.init(jcfg, jax.random.PRNGKey(4))
    jq = jax.device_get(jquant.quantize_params(jp))
    tq = params_to_numpy(tquant.quantize_params(params_from_numpy(jax.device_get(jp))))
    jl, tl = jax.tree_util.tree_leaves_with_path(jq), jax.tree_util.tree_leaves_with_path(tq)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=str(path))
    assert tq["layers"][0]["moe"]["w2"]["q"].dtype == np.int8
    assert tquant.tree_bytes(tquant.quantize_params(params_from_numpy(jax.device_get(jp)))) \
        == jquant.tree_bytes(jq)
