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


@pytest.mark.parametrize("head_dim,source", [
    (1, tfa.SM90), (40, tfa.SM90), (64, tfa.SM90), (100, tfa.SM90), (128, tfa.SM90),
    (129, tfa.MMA_SYNC), (256, tfa.MMA_SYNC)])
def test_kernel_source_routes_by_head_dim(head_dim, source):
    """Head dims padded to 64 or 128 take the TMA/wgmma kernel, 256 the
    mma.sync kernel: fixed by shape, no fallback between them."""
    assert tfa.kernel_source(head_dim) == source


def test_kernel_source_refuses_past_256():
    with pytest.raises(ValueError):
        tfa.kernel_source(257)


def test_kernel_wrapper_refuses_cpu_tensors_on_either_route():
    """flash_attention_fwd never computes on the CPU, whichever source is
    asked for: the check comes before any build or launch."""
    q = torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16)
    for source in (None, tfa.SM90, tfa.MMA_SYNC):
        with pytest.raises(ValueError):
            tfa.flash_attention_fwd(q, q, q, source=source)


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """A source's library name covers every csrc/ header it includes,
    directly or through another header: editing one rebuilds."""
    from kubedl_tpu_torch.ops import _build

    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("int b;\n")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint k;\n')
    (tmp_path / "plain.cu").write_text("int p;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.includes(tmp_path / "k.cu") == [tmp_path / "a.cuh", tmp_path / "b.cuh"]
    assert _build.includes(tmp_path / "plain.cu") == []
    before, plain = _build.library_path("k"), _build.library_path("plain")
    (tmp_path / "b.cuh").write_text("int b2;\n")
    assert _build.library_path("k") != before
    assert _build.library_path("plain") == plain
    (tmp_path / "b.cuh").write_text("int b;\n")
    assert _build.library_path("k") == before


def test_sm90_sources_share_the_header():
    """flash_fwd_sm90.cu and gmm_sm90.cu include sm90_common.cuh, so each
    library's name moves with it."""
    from kubedl_tpu_torch.ops import _build

    header = _build.CSRC / "sm90_common.cuh"
    for name in ("flash_fwd_sm90", "gmm_sm90"):
        assert _build.includes(_build.CSRC / f"{name}.cu") == [header]
    for name in ("flash_fwd", "flash_bwd", "gmm"):
        assert _build.includes(_build.CSRC / f"{name}.cu") == []


@pytest.mark.parametrize("shape", [
    (4, 32, 32, 1024, 128, True, None),   # the 7B prefill cluster
    (4, 32, 8, 1023, 128, True, None),    # GQA 32/8, ragged
    (1, 8, 8, 8320, 128, True, None),     # one long row
    (2, 4, 4, 333, 128, True, 100),       # window
    (3, 5, 5, 300, 64, False, None),      # not causal
    (1, 1, 1, 1, 128, True, None),        # fewer items than CTAs
])
def test_sm90_schedule_takes_every_item_once(shape):
    """flash_fwd_sm90.cu's persistent schedule: every (q-tile, b, h) item
    in exactly one CTA's list, and the CTAs' work (K/V tiles + 1 an item)
    within 12 % of the mean wherever there are several items a CTA."""
    b, hq, hkv, s, d, causal, window = shape
    n_ctas = 132
    order, starts = tfa.sm90_schedule(b, hq, hkv, s, d, causal, window, n_ctas)
    n_qt = -(-s // tfa.SM90_BLOCK)
    assert order.dtype == np.int32 and starts.dtype == np.int32
    assert starts[0] == 0 and starts[-1] == len(order) and np.all(np.diff(starts) >= 0)
    assert sorted(order.tolist()) == list(range(b * hq * n_qt))
    work = [sum(tfa._tiles(int(c) // (b * hq), s, causal, window) + 1
                for c in order[starts[i]:starts[i + 1]]) for i in range(n_ctas)]
    if len(order) >= 4 * n_ctas:
        assert max(work) <= 1.12 * (sum(work) / n_ctas)
    assert tfa.sm90_schedule(b, hq, hkv, s, d, causal, window, n_ctas)[0] is order


def test_sm90_schedule_orders_each_cta_longest_first_by_group():
    """Inside one L2 group a CTA's causal items never get longer, and the
    query heads of a GQA group are never split across L2 groups."""
    b, hq, hkv, s, d = 4, 32, 8, 1024, 128
    order, starts = tfa.sm90_schedule(b, hq, hkv, s, d, True, None, 16)
    group = tfa.sm90_group(b, hq, hkv, s, d)
    assert group % (hq // hkv) == 0
    for i in range(16):
        codes = order[starts[i]:starts[i + 1]]
        qt, bh = codes // (b * hq), codes % (b * hq)
        for g in np.unique(bh // group):
            assert np.all(np.diff(qt[bh // group == g]) <= 0)


@pytest.mark.parametrize("qt,s,causal,window,want", [
    (0, 1024, True, None, 1), (7, 1024, True, None, 8), (3, 1024, False, None, 8),
    (2, 333, True, 100, 2), (0, 333, True, 100, 1), (7, 1024, True, 1, 1)])
def test_sm90_tiles_match_the_kernels_live_range(qt, s, causal, window, want):
    """The K/V tiles a q-tile loads: up to its diagonal when causal, none
    wholly below the window's first key."""
    assert tfa._tiles(qt, s, causal, window) == want


def test_flash_probe_variants_still_apply():
    """ops/flash_probe.py patches flash_fwd_sm90.cu's softmax dispatch and
    deals sm90_items out round robin: both must keep matching the code."""
    from kubedl_tpu_torch.ops import flash_probe

    src = flash_probe.variants()["nosoftmax"]
    assert flash_probe._NO_SOFTMAX in src and flash_probe._SOFTMAX not in src
    order, starts = flash_probe.round_robin(2, 8, 2, 300, 128, True, None, 7)
    assert sorted(order.tolist()) == list(range(2 * 8 * 3))
    assert starts[-1] == len(order) and np.all(np.diff(starts) >= 0)


@pytest.mark.parametrize("shape,want", [
    ((4, 32, 32, 1024, 128), 43),   # 48 pairs fit: three groups of 43, 43, 42
    ((1, 8, 8, 8320, 128), 4),      # 5 fit: two groups of 4, not 5 and 3
    ((4, 32, 8, 1024, 128), 128),   # GQA 32/8: all 128 fit
    ((2, 8, 2, 65536, 128), 4),     # one KV head's K/V past the budget: its 4 query heads
    ((1, 2, 2, 1 << 20, 128), 1),   # one query head's past it
    ((1, 3, 3, 1024, 128), 3),      # fewer pairs than fit
])
def test_sm90_group_fits_l2_evenly(shape, want):
    """The L2 groups: whole GQA groups of query heads, their K/V within
    SM90_L2_GROUP_BYTES where one KV head's fits, and of even size."""
    b, hq, hkv, s, d = shape
    group = tfa.sm90_group(b, hq, hkv, s, d)
    assert group == want
    rep = hq // hkv
    assert group % rep == 0
    if s * d * 4 <= tfa.SM90_L2_GROUP_BYTES:
        assert group // rep * s * d * 4 <= tfa.SM90_L2_GROUP_BYTES
