"""kubedl_tpu_torch/models/moe.py against the JAX package's moe.py on the
same numpy inputs and weights: routing (both `need_slots` modes and the
iterative reference), the dispatch plan's integers exactly, and `moe_mlp`
in every single-device mode (dropless fused and unfused, bf16 weights and
int8 stacks, skewed routing that leaves experts unrouted, and the capacity
path), and weight-only int8 quantization bit for bit. The JAX side runs
its Pallas kernels in interpret mode.

Random f32 router logits do not tie, so torch.topk and lax.top_k pick the
same experts in the same order."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.models import quant as jquant
from kubedl_tpu_torch.models import moe as tmoe
from kubedl_tpu_torch.models import quant as tquant
from kubedl_tpu_torch.utils.convert import params_from_numpy

D, FF, E = 128, 256, 4


def _logits(s, e, seed=0):
    return np.random.default_rng(seed).standard_normal((s, e)).astype(np.float32)


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


# (top_k, capacity, need_slots)
GATING_CASES = [(1, 7, True), (2, 7, True), (2, 100, True), (3, 2, True),
                (1, 38, False), (2, 38, False)]


@pytest.mark.parametrize("top_k,capacity,need_slots", GATING_CASES)
def test_top_k_gating_matches_jax(top_k, capacity, need_slots):
    logits = _logits(37, 5, seed=top_k * 10 + capacity)
    j = jmoe._top_k_gating(jnp.asarray(logits), top_k, capacity, need_slots=need_slots)
    t = tmoe._top_k_gating(torch.from_numpy(logits), top_k, capacity,
                           need_slots=need_slots)
    for name, i in (("experts", 0), ("slots", 1), ("keeps", 3)):
        np.testing.assert_array_equal(_np(t[i]), np.asarray(j[i]), err_msg=name)
    assert t[0].dtype == torch.int32 and t[1].dtype == torch.int32 and t[3].dtype == torch.bool
    np.testing.assert_allclose(_np(t[2]), np.asarray(j[2]), rtol=1e-6, atol=1e-6)
    for a, b in zip(t[4], j[4]):  # me, ce
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("top_k,capacity", [(1, 7), (2, 7), (3, 100)])
def test_gating_reference_matches_jax_and_the_sort(top_k, capacity):
    logits = _logits(37, 5, seed=capacity + top_k)
    j = jmoe._top_k_gating_reference(jnp.asarray(logits), top_k, capacity)
    t = tmoe._top_k_gating_reference(torch.from_numpy(logits), top_k, capacity)
    fast = tmoe._top_k_gating(torch.from_numpy(logits), top_k, capacity)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(_np(t[i]), np.asarray(j[i]))
        np.testing.assert_array_equal(_np(fast[i]), np.asarray(j[i]))
    np.testing.assert_allclose(_np(t[2]), np.asarray(j[2]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(t[4][1]), np.asarray(j[4][1]), rtol=1e-6)


# (entries M, experts, share of sentinel entries): tiles of 128, 256, 512
PLAN_CASES = [(42, 4, 0.0), (300, 4, 0.2), (8192, 4, 0.05), (16384, 4, 0.0), (977, 8, 0.5)]


@pytest.mark.parametrize("m,e,sentinel", PLAN_CASES)
def test_dispatch_plan_integers_equal_jax(m, e, sentinel):
    rng = np.random.default_rng(m)
    eid = rng.integers(0, e, m).astype(np.int32)
    eid[rng.random(m) < sentinel] = e  # empty-slot sentinel entries
    j = jmoe._dispatch_plan(jnp.asarray(eid), e)
    t = tmoe._dispatch_plan(torch.from_numpy(eid), e)
    assert t[4] == j[4]  # m_pad
    for name, a, b in zip(("order", "dest", "pos_of_entry", "tile_expert"), t[:4], j[:4]):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
    assert t[3].dtype == torch.int32
    assert tmoe._row_tile(m, e) == jmoe._row_tile(m, e)


def test_expert_capacity_matches_jax():
    for args in ((32, 4, 2, 1.25), (7, 8, 1, 1.0), (1, 8, 2, 0.1)):
        assert tmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)


def _moe_params(seed, skew=None):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, FF, E, dtype=jnp.float32)
    if skew is not None:  # every token's first choice is expert `skew`
        router = np.zeros((D, E), np.float32)
        router[:, skew] = 1.0
        router += np.random.default_rng(seed).standard_normal((D, E)).astype(np.float32) * 1e-3
        jp["router"] = jnp.asarray(router)
    return jp


# mode: (dropless, fused, int8 stacks, skewed router)
MLP_MODES = {
    "dropless_fused": (True, True, False, None),
    "dropless_unfused": (True, False, False, None),
    "dropless_fused_int8": (True, True, True, None),
    "dropless_unfused_int8": (True, False, True, None),
    "dropless_fused_skewed": (True, True, False, 2),
    "capacity": (False, None, False, None),
    "capacity_int8": (False, None, True, None),
}


@pytest.mark.parametrize("mode", list(MLP_MODES))
def test_moe_mlp_matches_jax(mode):
    """Output within 1e-4 of max|JAX| (f32 activations), aux within 1e-6."""
    dropless, fused, int8, skew = MLP_MODES[mode]
    jp = _moe_params(len(mode), skew)
    if int8:
        jp = dict(jp, **{n: jquant.quantize_stack(jp[n]) for n in ("w1", "w3", "w2")})
    tp = params_from_numpy(jax.device_get(jp))
    h = np.random.default_rng(3).standard_normal((2, 16, D)).astype(np.float32)
    jy, jaux = jmoe.moe_mlp(jnp.asarray(h), jp, top_k=2, capacity_factor=1.0,
                            dropless=dropless, fused=fused)
    ty, taux = tmoe.moe_mlp(torch.from_numpy(h), tp, top_k=2, capacity_factor=1.0,
                            dropless=dropless, fused=fused)
    jy = np.asarray(jy)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-4, atol=1e-4 * np.abs(jy).max())
    assert abs(taux.item() - float(jaux)) <= 1e-6


def test_quantize_stack_bit_exact():
    w = np.random.default_rng(11).standard_normal((3, 64, 48)).astype(np.float32)
    w[1, :, 5] = 0.0  # a zero column takes scale 1
    j = jquant.quantize_stack(jnp.asarray(w))
    t = tquant.quantize_stack(torch.from_numpy(w))
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["s"].view(torch.int16).numpy(),
                                  np.asarray(j["s"]).view(np.int16))
    assert t["q"].dtype == torch.int8 and t["s"].dtype == torch.bfloat16


def test_quantize_dequantize_and_int8_matmul_match_jax():
    """quantize bit-exact; dequantize and the int8 matmul (x @ q) * s
    within 1e-6 of max|JAX| in f32; a 3-D stack refused as JAX refuses it."""
    rng = np.random.default_rng(12)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    j = jquant.quantize(jnp.asarray(w))
    t = tquant.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["s"].view(torch.int16).numpy(),
                                  np.asarray(j["s"]).view(np.int16))
    for tout, jout in ((tquant.dequantize(t, torch.float32),
                        jquant.dequantize(j, jnp.float32)),
                       (tquant.matmul(torch.from_numpy(x), t),
                        jquant.matmul(jnp.asarray(x), j))):
        jout = np.asarray(jout)
        np.testing.assert_allclose(tout.numpy(), jout, rtol=1e-6,
                                   atol=1e-6 * np.abs(jout).max())
    assert tquant.is_quantized(t) and not tquant.is_quantized({"q": t["q"]})
    with pytest.raises(ValueError):
        tquant.quantize(torch.zeros(2, 3, 4))
