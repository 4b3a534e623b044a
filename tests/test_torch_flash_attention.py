"""kubedl_tpu_torch/ops/flash_attention.py against the JAX package's
flash attention: the port's plain versions (what a CPU tensor runs) against
the Pallas kernel in interpret mode and against attention_reference, on the
same numpy inputs. The CUDA kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubedl_tpu.ops import flash_attention as jfa
from kubedl_tpu_torch.ops import flash_attention as tfa

# (b, hq, hkv, s, d, causal, window, softcap): every case is a shape the
# JAX entry runs as one kernel block (s < 128), so its LSE is reachable
CASES = {
    "causal": (2, 4, 4, 64, 32, True, None, None),
    "full": (1, 4, 4, 48, 32, False, None, None),
    "gqa": (1, 4, 2, 64, 32, True, None, None),
    "window": (1, 2, 2, 80, 32, True, 24, None),
    "softcap": (1, 2, 1, 64, 32, True, None, 30.0),
    "ragged": (1, 2, 2, 77, 64, True, None, None),
}


def _inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d), np.float32) for h in (hq, hkv, hkv)]


def _jax_fwd(q, k, v, causal, window, softcap):
    """The JAX forward kernel's (out, lse) via its internal _fwd, with the
    GQA repeat and lane padding its public entry applies (s < 128: one
    block of the whole sequence)."""
    b, hq, s, d = q.shape
    rep = hq // k.shape[1]
    k, v = np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1)
    pad = ((0, 0), (0, 0), (0, 0), (0, 128 - d))
    qf, kf, vf = (jnp.asarray(np.pad(x, pad).reshape(b * hq, s, 128))
                  for x in (q, k, v))
    out, lse = jfa._fwd(qf, kf, vf, 1.0 / d ** 0.5, causal, window, s, s, s,
                        softcap=softcap)
    out = np.asarray(out)[..., :d].reshape(b, hq, s, d)
    return out, np.asarray(lse).reshape(b, hq, s)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_kernel_f32(name):
    b, hq, hkv, s, d, causal, window, softcap = CASES[name]
    q, k, v = _inputs(b, hq, hkv, s, d)
    j_out, j_lse = _jax_fwd(q, k, v, causal, window, softcap)
    t_out, t_lse = tfa.flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, rtol=0, atol=1e-4)
    # the public entry on CPU tensors is the plain version, and launches nothing
    n0 = tfa.flash_attention.launches
    pub = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, window=window, softcap=softcap)
    assert tfa.flash_attention.launches == n0
    np.testing.assert_allclose(pub.numpy(), j_out, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["causal", "gqa", "window", "softcap"])
def test_plain_matches_jax_public_entry_bf16(name):
    b, hq, hkv, s, d, causal, window, softcap = CASES[name]
    q, k, v = (x.astype(ml_dtypes.bfloat16) for x in _inputs(b, hq, hkv, s, d, 1))
    j = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                            window=window, softcap=softcap)
    t = tfa.flash_attention(
        *(torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) for x in (q, k, v)),
        causal=causal, window=window, softcap=softcap)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j).astype(np.float32), rtol=0, atol=2e-2)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_matches_jax_reference(name):
    b, hq, hkv, s, d, causal, window, softcap = CASES[name]
    q, k, v = _inputs(b, hq, hkv, s, d, 2)
    j = jfa.attention_reference(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                window=window, softcap=softcap)
    t = tfa.attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)


def test_matches_jax_streamed_path(monkeypatch):
    """The JAX streamed forward (K4, taken past STREAM_MIN_SEQ) computes the
    same function; with the threshold lowered it runs here in interpret
    mode over two 128-row K blocks and a ragged tail."""
    monkeypatch.setattr(jfa, "STREAM_MIN_SEQ", 64)
    q, k, v = _inputs(1, 2, 2, 160, 32, 3)
    j = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    t = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)


def test_argument_checks_match_jax():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, kv, kv)  # 4 q heads over 3 kv heads
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, softcap=0.0)


def test_fully_masked_rows_stay_finite():
    """A row that sees no key (only possible past the sequence in the
    kernel) must not turn NaN: the l >= 1e-30 floor, as in the JAX kernel."""
    q = torch.randn(1, 1, 4, 8)
    out, lse = tfa.flash_attention_plain(q, q, q, causal=True, window=1)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_cuda_tensor_never_takes_the_plain_path(monkeypatch):
    """The dispatch rule: a non-CPU tensor goes to the kernel wrapper, which
    raises on what the kernel does not take — no silent fallback."""
    calls = []
    monkeypatch.setattr(tfa, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(1) or (a[0], None))
    q = torch.zeros(1, 1, 4, 8, device="meta")
    tfa.flash_attention(q, q, q)
    assert calls == [1]
    with pytest.raises(ValueError):
        monkeypatch.undo()
        tfa.flash_attention(q, q, q)  # meta tensors are not CUDA tensors
