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
    (129, tfa.SM90), (256, tfa.SM90)])
def test_kernel_source_routes_by_head_dim(head_dim, source):
    """Every head dim, padded to 64, 128 or 256, takes the TMA/wgmma
    kernel: fixed by shape, no fallback to the mma.sync kernel."""
    assert tfa.kernel_source(head_dim) == source


def test_kernel_source_refuses_past_256():
    with pytest.raises(ValueError):
        tfa.kernel_source(257)


@pytest.mark.parametrize("head_dim,source", [
    (1, tfa.BWD_SM90), (40, tfa.BWD_SM90), (64, tfa.BWD_SM90), (100, tfa.BWD_SM90),
    (128, tfa.BWD_SM90), (129, (tfa.BWD_SM90, tfa.BWD_SM90)),
    (256, (tfa.BWD_SM90, tfa.BWD_SM90))])
def test_bwd_kernel_source_routes_by_head_dim(head_dim, source):
    """The backward's route table, (dq, dkv): padded to 64, 128 or 256,
    both kernels on flash_bwd_sm90.cu; no head dim reaches flash_bwd.cu."""
    want = source if isinstance(source, tuple) else (source, source)
    assert (tfa.bwd_kernel_source(head_dim, "dq"), tfa.bwd_kernel_source(head_dim, "dkv")) == want


def test_bwd_kernel_source_refuses_past_256():
    for kind in ("dq", "dkv"):
        with pytest.raises(ValueError):
            tfa.bwd_kernel_source(257, kind)
    with pytest.raises(ValueError):
        tfa.bwd_kernel_source(128, "dkq")


@pytest.mark.parametrize("d,source,want", [
    (200, None, ({"dq": tfa.BWD_SM90, "dkv": tfa.BWD_SM90}, 256)),
    (256, None, ({"dq": tfa.BWD_SM90, "dkv": tfa.BWD_SM90}, 256)),
    (256, tfa.BWD_MMA_SYNC, ({"dq": tfa.BWD_MMA_SYNC, "dkv": tfa.BWD_MMA_SYNC}, 256)),
    (100, None, ({"dq": tfa.BWD_SM90, "dkv": tfa.BWD_SM90}, 128)),
    (40, tfa.BWD_MMA_SYNC, ({"dq": tfa.BWD_MMA_SYNC, "dkv": tfa.BWD_MMA_SYNC}, 64)),
])
def test_bwd_plan_routes_each_kernel(d, source, want):
    """Both backward kernels take flash_bwd_sm90.cu at every head dim,
    padded to 64, 128 or 256; `source` names one source for both kernels,
    where a caller compares them."""
    assert tfa._bwd_plan(d, source) == want


@pytest.mark.parametrize("d,source", [(257, tfa.BWD_SM90), (320, tfa.BWD_SM90),
                                      (320, None), (64, "flash_bwd_sm80")])
def test_bwd_plan_refuses_what_no_kernel_takes(d, source):
    """Past head dim 256 no kernel takes the width, whichever source is
    asked for, and an unknown source raises: the wrapper raises before
    anything is built or launched."""
    with pytest.raises(ValueError):
        tfa._bwd_plan(d, source)


def test_bwd_wrapper_refuses_cpu_tensors_on_either_route():
    """flash_attention_bwd never computes on the CPU, whichever source is
    asked for, and refuses a source it does not know."""
    q = torch.zeros(1, 1, 4, 128, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 4)
    for source in (None, tfa.BWD_SM90, tfa.BWD_MMA_SYNC, "flash_bwd_nonesuch"):
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd(q, q, q, q, lse, q, source=source)


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
    """flash_fwd_sm90.cu, flash_bwd_sm90.cu and gmm_sm90.cu include
    sm90_common.cuh, so each library's name moves with it."""
    from kubedl_tpu_torch.ops import _build

    header = _build.CSRC / "sm90_common.cuh"
    for name in ("flash_fwd_sm90", "flash_bwd_sm90", "gmm_sm90"):
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


BWD_SCHEDULE_SHAPES = [
    (4, 32, 32, 1023, 128, True, None),   # the 7B training shape
    (4, 32, 8, 1024, 128, True, None),    # GQA 32/8
    (1, 8, 8, 8192, 128, True, None),     # one long row
    (2, 4, 4, 333, 128, True, 100),       # window
    (3, 5, 5, 300, 64, False, None),      # not causal
    (1, 1, 1, 1, 128, True, None),        # fewer items than CTAs
]


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("shape", BWD_SCHEDULE_SHAPES)
def test_bwd_schedule_takes_every_item_once(shape, kind):
    """flash_bwd_sm90.cu's schedules: every item (a 128-row block of one
    (b, q head) for dq, of one (b, KV head) for dkv) in exactly one CTA's
    list, and the CTAs' work (streamed tiles over the GQA group + 1 an
    item) within 12 % of the mean wherever there are several items a CTA."""
    b, hq, hkv, s, d, causal, window = shape
    n_ctas, rep = 132, hq // hkv
    pairs, per = (b * hkv, rep) if kind == "dkv" else (b * hq, 1)
    order, starts = tfa.sm90_schedule(b, hq, hkv, s, d, causal, window, n_ctas, kind)
    assert order.dtype == np.int32 and starts.dtype == np.int32
    assert starts[0] == 0 and starts[-1] == len(order) and np.all(np.diff(starts) >= 0)
    assert sorted(order.tolist()) == list(range(pairs * -(-s // 128)))
    work = [sum(tfa._tiles(int(c) // pairs, s, causal, window, kind) * per + 1
                for c in order[starts[i]:starts[i + 1]]) for i in range(n_ctas)]
    if len(order) >= 4 * n_ctas:
        assert max(work) <= 1.12 * (sum(work) / n_ctas)
    # a schedule a kind: the forward's of the same shape is another list
    assert tfa.sm90_schedule(b, hq, hkv, s, d, causal, window, n_ctas, kind)[0] is order


@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_bwd_schedule_takes_the_longest_items_first(kind):
    """Inside one L2 group a CTA's causal items never get cheaper to more
    expensive: dq's last query blocks and dkv's first key blocks first."""
    b, hq, hkv, s, d = 4, 32, 8, 1024, 128
    order, starts = tfa.sm90_schedule(b, hq, hkv, s, d, True, None, 16, kind)
    pairs = b * hkv if kind == "dkv" else b * hq
    group = tfa.sm90_group(b, hq, hkv, s, d, kind)
    for i in range(16):
        codes = order[starts[i]:starts[i + 1]]
        cost = np.array([tfa._tiles(int(c) // pairs, s, True, None, kind) for c in codes])
        grp = (codes % pairs) // group
        for g in np.unique(grp):
            assert np.all(np.diff(cost[grp == g]) <= 0)


@pytest.mark.parametrize("kind,t,s,causal,window,want", [
    ("dq", 0, 1023, True, None, 2), ("dq", 7, 1023, True, None, 16),
    ("dq", 3, 1024, False, None, 16), ("dq", 2, 333, True, 100, 4),
    ("dkv", 0, 1023, True, None, 16), ("dkv", 7, 1023, True, None, 2),
    ("dkv", 3, 1024, False, None, 16), ("dkv", 0, 333, True, 100, 4),
    ("dkv", 2, 333, True, 100, 2), ("dkv", 1, 777, True, 1, 2)])
def test_bwd_tiles_match_the_kernels_live_range(kind, t, s, causal, window, want):
    """The 64-row tiles a 128-row item streams: dq's K/V tiles up to its
    diagonal and from its window's first key; dkv's q tiles from its
    diagonal to the window's last query."""
    assert tfa._tiles(t, s, causal, window, kind) == want


@pytest.mark.parametrize("kind,shape,want", [
    ("dq", (4, 32, 32, 1024, 128), 43),    # the forward's groups: the same K/V per head
    ("dkv", (4, 32, 32, 1024, 128), 43),   # a KV head's Q and dO: 48 fit
    ("dkv", (4, 32, 8, 1024, 128), 11),    # 4 query heads a KV head: 12 fit, 3 groups
    ("dkv", (1, 2, 2, 1 << 20, 128), 1),   # one head's past the budget
])
def test_bwd_groups_fit_l2(kind, shape, want):
    assert tfa.sm90_group(*shape, kind) == want


@pytest.mark.parametrize("qt,s,causal,window,want", [
    (0, 1024, True, None, 1), (7, 1024, True, None, 8), (3, 1024, False, None, 8),
    (2, 333, True, 100, 2), (0, 333, True, 100, 1), (7, 1024, True, 1, 1)])
def test_sm90_tiles_match_the_kernels_live_range(qt, s, causal, window, want):
    """The K/V tiles a q-tile loads: up to its diagonal when causal, none
    wholly below the window's first key."""
    assert tfa._tiles(qt, s, causal, window) == want


def test_flash_probe_variants_still_apply():
    """ops/flash_probe.py patches flash_fwd_sm90.cu's softmax dispatch,
    flash_bwd_sm90.cu's elementwise work and the d 256 dq kernel's release
    of K, and deals sm90_items out round robin: all must keep matching the
    code."""
    from kubedl_tpu_torch.ops import flash_probe

    src = flash_probe.variants()["nosoftmax"]
    assert flash_probe._NO_SOFTMAX in src and flash_probe._SOFTMAX not in src
    src = flash_probe.bwd_variants()["noelem"]
    assert all(stub in src for stub in flash_probe._BWD_ELEM.values())
    assert not any(work in src for work in flash_probe._BWD_ELEM)
    src = flash_probe.bwd_variants()["latek"]
    assert flash_probe._K_LATE[1] in src and flash_probe._K_EARLY[0] not in src
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


D256_SCHEDULE_SHAPES = [
    (4, 8, 4, 1024, 256, True, None),     # Gemma-2-2B's prefill and training rows
    (4, 8, 4, 1023, 256, True, None),     # ragged
    (1, 8, 4, 5000, 256, True, 4096),     # the sliding layers past the window
    (2, 4, 4, 333, 256, False, None),     # not causal
    (1, 1, 1, 1, 256, True, None),        # fewer items than CTAs
]


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("shape", D256_SCHEDULE_SHAPES)
def test_d256_schedule_takes_every_item_once(shape, kind):
    """At head dim 256 the forward streams 64-key tiles into 128-row items,
    the dq kernel's items are 64 query rows and the dkv kernel's 64 key
    rows: every item of that size in exactly one CTA's list, the CTAs'
    costs (in 64-row tiles) within 12 % of the mean wherever there are
    several items a CTA."""
    b, hq, hkv, s, d, causal, window = shape
    n_ctas, rep = 132, hq // hkv
    pairs, per = (b * hkv, rep) if kind == "dkv" else (b * hq, 1)
    rows = 128 if kind == "fwd" else 64
    assert tfa.sm90_tiles(kind, d) == (rows, 64)
    order, starts = tfa.sm90_schedule(b, hq, hkv, s, d, causal, window, n_ctas, kind)
    assert starts[0] == 0 and starts[-1] == len(order) and np.all(np.diff(starts) >= 0)
    assert sorted(order.tolist()) == list(range(pairs * -(-s // rows)))
    work = [sum(tfa._tiles(int(c) // pairs, s, causal, window, kind, d) * per + 1
                for c in order[starts[i]:starts[i + 1]]) for i in range(n_ctas)]
    if len(order) >= 4 * n_ctas:
        assert max(work) <= 1.12 * (sum(work) / n_ctas)
    assert tfa.sm90_schedule(b, hq, hkv, s, d, causal, window, n_ctas, kind)[0] is order


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
def test_d256_schedule_takes_the_longest_items_first(kind):
    """Inside one L2 group a CTA's causal items at head dim 256 never get
    more expensive: the forward's and dq's last query blocks and dkv's
    first key blocks first, costed in 64-row tiles."""
    b, hq, hkv, s, d = 4, 8, 4, 1024, 256
    order, starts = tfa.sm90_schedule(b, hq, hkv, s, d, True, None, 16, kind)
    pairs = b * hkv if kind == "dkv" else b * hq
    group = tfa.sm90_group(b, hq, hkv, s, d, kind)
    for i in range(16):
        codes = order[starts[i]:starts[i + 1]]
        cost = np.array([tfa._tiles(int(c) // pairs, s, True, None, kind, d) for c in codes])
        grp = (codes % pairs) // group
        for g in np.unique(grp):
            assert np.all(np.diff(cost[grp == g]) <= 0)


@pytest.mark.parametrize("kind,t,s,causal,window,want", [
    ("fwd", 0, 1024, True, None, 2), ("fwd", 7, 1024, True, None, 16),
    ("fwd", 3, 1023, False, None, 16), ("fwd", 39, 5000, True, 4096, 65),
    ("fwd", 2, 333, True, 100, 4),
    ("dq", 0, 1023, True, None, 1), ("dq", 15, 1023, True, None, 16),
    ("dq", 3, 1024, False, None, 16), ("dq", 78, 5000, True, 4096, 65),
    ("dq", 4, 333, True, 100, 3),
    ("dkv", 0, 1023, True, None, 16), ("dkv", 15, 1023, True, None, 1),
    ("dkv", 3, 1024, False, None, 16), ("dkv", 0, 5000, True, 4096, 65),
    ("dkv", 1, 333, True, 100, 3)])
def test_d256_tiles_match_the_kernels_live_range(kind, t, s, causal, window, want):
    """The 64-row tiles an item streams at head dim 256 (Fwd<256>'s item_of,
    Dq256's and Dkv256's dq_item / dkv_item): the forward's and dq's K/V
    tiles up to its diagonal and from its window's first key; dkv's q tiles
    from its diagonal to the window's last query."""
    assert tfa._tiles(t, s, causal, window, kind, 256) == want


def _live_key_tiles(t, s, causal, window, rows=64, cols=64):
    """The cols-key tiles holding a (query, key) pair that the masks keep,
    for the query rows [t * rows, (t + 1) * rows) below s: counted pair by
    pair."""
    qs = np.arange(t * rows, min((t + 1) * rows, s))[:, None]
    ks = np.arange(s)[None, :]
    keep = np.ones((len(qs), s), bool)
    if causal:
        keep &= ks <= qs
    if window:
        keep &= ks > qs - window
    return len(np.unique(np.nonzero(keep.any(0))[0] // cols))


@pytest.mark.parametrize("shape", [
    (1, 2, 1, 333, 256, True, 100),       # a window shorter than S, a ragged tail
    (2, 4, 2, 1023, 256, True, None),     # Gemma-2's training rows, causal
    (1, 2, 1, 5000, 256, True, 4096),     # the sliding layers past the window
    (2, 2, 2, 260, 256, False, None),     # not causal
])
def test_d256_dq_schedule_costs_match_a_brute_force_count(shape):
    """The d 256 dq schedule's items are 64 query rows each, every one in
    exactly one CTA's list, and each item's cost is one (its prologue and
    epilogue) plus the 64-key tiles that hold a pair the causal and window
    masks keep, counted pair by pair: the work the kernel's live range
    [kb, ke) streams, no tile more or less."""
    b, hq, hkv, s, d, causal, window = shape
    pairs = b * hq
    assert tfa.sm90_tiles("dq", d) == (64, 64)
    items = list(tfa.sm90_items(b, hq, hkv, s, d, causal, window, "dq"))
    assert sorted(code for code, _ in items) == list(range(pairs * -(-s // 64)))
    for code, cost in items:
        assert cost == _live_key_tiles(code // pairs, s, causal, window) + 1, code
    order, starts = tfa.sm90_schedule(b, hq, hkv, s, d, causal, window, 132, "dq")
    assert sorted(order.tolist()) == list(range(pairs * -(-s // 64)))
