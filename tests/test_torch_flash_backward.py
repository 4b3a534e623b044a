"""The flash backward of kubedl_tpu_torch/ops/flash_attention.py against the
JAX package: `flash_attention_bwd_plain` (what a CPU tensor's backward
runs) against jax.vjp of the JAX `flash_attention` (its Pallas forward and
backward kernels in interpret mode) and against torch autograd of the
port's plain forward, on the same numpy inputs; and the dispatch rule of
the autograd.Function. The CUDA kernels are held against the plain
backward on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubedl_tpu.ops import flash_attention as jfa
from kubedl_tpu_torch.ops import flash_attention as tfa

# (b, hq, hkv, s, d, causal, window, softcap)
CASES = {
    "causal": (2, 4, 4, 64, 32, True, None, None),
    "full": (1, 4, 4, 48, 32, False, None, None),
    "gqa_8q_2kv": (1, 8, 2, 64, 32, True, None, None),
    "ragged_200": (1, 2, 2, 200, 32, True, None, None),
    "window": (1, 2, 2, 80, 32, True, 24, None),
    "softcap": (1, 2, 1, 64, 32, True, None, 30.0),
    "d64": (1, 2, 2, 64, 64, True, None, None),
    "d96_padded": (1, 2, 2, 48, 96, True, None, None),
}
# against the JAX kernels (each case costs an interpret-mode build, so the
# features are combined: every one of CASES' features appears once)
JAX_CASES = {
    "causal_gqa_8q_2kv_ragged_200_d64": (1, 8, 2, 200, 64, True, None, None),
    "full_d96_padded": (1, 2, 2, 48, 96, False, None, None),
    "window_softcap_gqa": (1, 4, 2, 80, 32, True, 24, 30.0),
}


def _inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d), np.float32) for h in (hq, hkv, hkv))
    return q, k, v, rng.standard_normal((b, hq, s, d), np.float32)


def _jax_grads(q, k, v, dout, causal, window, softcap):
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)

    @jax.jit
    def grads(q, k, v, dout):
        return jax.vjp(f, q, k, v)[1](dout)

    return [np.asarray(g) for g in grads(*(jnp.asarray(x) for x in (q, k, v, dout)))]


def _plain_grads(q, k, v, dout, causal, window, softcap):
    t = [torch.from_numpy(x) for x in (q, k, v, dout)]
    out, lse = tfa.flash_attention_plain(*t[:3], causal=causal, window=window,
                                         softcap=softcap)
    return tfa.flash_attention_bwd_plain(*t[:3], out, lse, t[3], causal=causal,
                                         window=window, softcap=softcap)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_bwd_plain_matches_jax_kernels_f32(name):
    """f32: max|port - JAX| <= 1e-4 x max(1, max|JAX|) for dq, dk, dv (the
    two sum the same products in other orders)."""
    b, hq, hkv, s, d, causal, window, softcap = JAX_CASES[name]
    q, k, v, dout = _inputs(b, hq, hkv, s, d)
    want = _jax_grads(q, k, v, dout, causal, window, softcap)
    got = _plain_grads(q, k, v, dout, causal, window, softcap)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32 and tuple(g.shape) == x.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("name", ["window_softcap_gqa"])
def test_bwd_plain_matches_jax_kernels_bf16(name):
    """bf16 inputs: the JAX kernels round p and ds to bf16 before their
    products, the plain version does not; each gradient within 2e-2 of
    max|JAX|."""
    b, hq, hkv, s, d, causal, window, softcap = JAX_CASES[name]
    q, k, v, dout = (x.astype(ml_dtypes.bfloat16) for x in _inputs(b, hq, hkv, s, d, 1))
    want = _jax_grads(q, k, v, dout, causal, window, softcap)

    def tb(x):
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)

    t = [tb(x) for x in (q, k, v, dout)]
    out, lse = tfa.flash_attention_plain(*t[:3], causal=causal, window=window,
                                         softcap=softcap)
    got = tfa.flash_attention_bwd_plain(*t[:3], out, lse, t[3], causal=causal,
                                        window=window, softcap=softcap)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = w.astype(np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max()


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_plain_matches_autograd_of_plain_forward(name):
    """The explicit backward is the derivative of the plain forward: f32,
    max|diff| <= 1e-5 x max(1, max|autograd|)."""
    b, hq, hkv, s, d, causal, window, softcap = CASES[name]
    q, k, v, dout = _inputs(b, hq, hkv, s, d, 2)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention_plain(*leaves, causal=causal, window=window,
                                    softcap=softcap)[0]
    want = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    got = _plain_grads(q, k, v, dout, causal, window, softcap)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-5 * max(1.0, w.abs().max().item())


def test_requires_grad_goes_through_the_autograd_function(monkeypatch):
    """With an input requiring grad, flash_attention runs FlashAttention: on
    CPU tensors its forward is the plain forward and its backward the plain
    backward, and the gradients are those of the plain backward."""
    q, k, v, dout = _inputs(1, 4, 2, 40, 16, 3)
    calls = []
    real_bwd = tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or real_bwd(*a, **kw))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    assert calls == [1]
    want = _plain_grads(q, k, v, dout, True, None, None)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # no grad wanted: the plain forward alone, no graph
    with torch.no_grad():
        assert tfa.flash_attention(*leaves).grad_fn is None


def test_non_cpu_tensors_take_the_kernels_or_raise(monkeypatch):
    """The dispatch rule under autograd: a non-CPU tensor goes to the kernel
    wrappers, forward and backward, never to the plain versions."""
    calls = []

    def fwd(q, k, v, **kw):
        calls.append("fwd")
        return torch.zeros_like(q), torch.zeros(q.shape[:3], device=q.device)

    def bwd(q, k, v, out, lse, dout, **kw):
        calls.append("bwd")
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(tfa, "flash_attention_fwd", fwd)
    monkeypatch.setattr(tfa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(tfa, "flash_attention_plain", None)
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain", None)
    q = torch.zeros(1, 2, 8, 16, device="meta", requires_grad=True)
    out = tfa.flash_attention(q, q, q)
    torch.autograd.grad(out.sum(), q)
    assert calls == ["fwd", "bwd"]
    monkeypatch.undo()
    with pytest.raises(ValueError):  # meta tensors are not CUDA tensors
        tfa.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8, device="meta"), q)
