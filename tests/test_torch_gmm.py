"""kubedl_tpu_torch/ops/gmm.py against the JAX package's grouped matmul
kernels (Pallas, interpret mode on the CPU) on the same numpy inputs: the
three forward products at row tiles 128, 256 and 512, bf16 and int8
weights; the gradients of every argument against jax.vjp; the unrouted
experts' zero gradients; and the row-tile refusals, message for message.

Tolerances: f32 within 1e-4 of max|JAX| (one f32 product per expert here,
per-tile accumulation there); bf16 within 2e-2 (one bf16 rounding of the
output, taken from f32 sums in another order)."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.ops import gmm as jg
from kubedl_tpu_torch.ops import gmm as tg

E, K, N = 3, 128, 128
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _tile_map(row_tile):
    # two tiles with expert 1 unrouted; a single 512-row tile on expert 1
    return np.array([1] if row_tile == 512 else [0, 2], np.int32)


def _operands(seed, row_tile, int8):
    rng = np.random.default_rng(seed)
    te = _tile_map(row_tile)
    lhs = rng.standard_normal((len(te) * row_tile, K)).astype(np.float32)
    if int8:
        w1, w3 = (rng.integers(-127, 128, (E, K, N)).astype(np.int8) for _ in range(2))
    else:
        w1, w3 = (rng.standard_normal((E, K, N)).astype(np.float32) * 0.1 for _ in range(2))
    s1, s3 = (rng.uniform(0.5, 1.5, (E, N)).astype(np.float32) for _ in range(2))
    if int8:  # keep int8 products O(1): scale the codes down
        s1, s3 = s1 / 127.0, s3 / 127.0
    return lhs, w1, w3, te, s1, s3


def _both(a, jdt, tdt):
    """One numpy array as (JAX, torch) operands: float arrays in the working
    dtype, int8 weights as int8 for the port and as the lhs dtype for JAX
    (models/moe.py converts the codes before its kernels)."""
    if a.dtype == np.int8:
        return jnp.asarray(a.astype(np.float32), jdt), torch.from_numpy(a)
    if a.dtype == np.int32:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _close(t, j, tol):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.float().numpy(), j, rtol=tol, atol=tol * np.abs(j).max())


# (kind, dtype, row_tile, int8 weights)
FWD_CASES = [
    ("gmm", "f32", 128, False), ("gmm", "f32", 256, False), ("gmm", "f32", 512, False),
    ("gmm", "bf16", 128, False), ("gmm", "f32", 256, True),
    ("scaled", "f32", 128, False), ("scaled", "f32", 256, True),
    ("scaled", "bf16", 512, True),
    ("swiglu", "f32", 128, False), ("swiglu", "f32", 512, False),
    ("swiglu", "bf16", 256, False), ("swiglu", "f32", 128, True),
    ("swiglu", "bf16", 128, True),
]


@pytest.mark.parametrize("kind,dtype,row_tile,int8", FWD_CASES)
def test_forward_matches_jax(kind, dtype, row_tile, int8):
    jdt, tdt, tol = DTYPES[dtype]
    lhs, w1, w3, te, s1, s3 = _operands(len(FWD_CASES) + row_tile, row_tile, int8)
    (jl, tl), (j1, t1), (j3, t3), (jte, tte) = (_both(a, jdt, tdt) for a in (lhs, w1, w3, te))
    js1, js3 = jnp.asarray(s1), jnp.asarray(s3)
    ts1, ts3 = torch.from_numpy(s1), torch.from_numpy(s3)
    if kind == "gmm":
        j = jg.gmm(jl, j1, jte, row_tile=row_tile)
        t = tg.gmm(tl, t1, tte, row_tile=row_tile)
    elif kind == "scaled":
        j = jg.gmm_scaled(jl, j1, jte, js1, row_tile=row_tile)
        t = tg.gmm_scaled(tl, t1, tte, ts1, row_tile=row_tile)
    else:
        j = jg.gmm_swiglu(jl, j1, j3, jte, js1, js3, row_tile=row_tile)
        t = tg.gmm_swiglu(tl, t1, t3, tte, ts1, ts3, row_tile=row_tile)
    assert t.dtype == tdt and tuple(t.shape) == j.shape
    _close(t, j, tol)


def _grads(jfn, tfn, jargs, targs, dout):
    """(JAX vjp, port autograd) gradients of every argument for one
    output cotangent."""
    out, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(dout))
    tleaves = [a.detach().clone().requires_grad_(True) for a in targs]
    tout = tfn(*tleaves)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(out)).max())
    tgrads = torch.autograd.grad(tout, tleaves, torch.from_numpy(dout))
    return jgrads, tgrads


@pytest.mark.parametrize("kind,row_tile", [("gmm", 128), ("gmm", 512), ("scaled", 256),
                                           ("swiglu", 128)])
def test_gradients_match_jax_vjp(kind, row_tile):
    """Every argument's gradient (scales included) within 1e-4 of max|JAX|
    in f32; the unrouted expert's weight gradient is exactly zero in both."""
    lhs, w1, w3, te, s1, s3 = _operands(7 + row_tile, row_tile, False)
    rng = np.random.default_rng(row_tile)
    dout = rng.standard_normal((lhs.shape[0], N)).astype(np.float32)
    jte, tte = jnp.asarray(te), torch.from_numpy(te)
    if kind == "gmm":
        args = (lhs, w1)
        jfn = lambda a, b: jg.gmm(a, b, jte, row_tile=row_tile)  # noqa: E731
        tfn = lambda a, b: tg.gmm(a, b, tte, row_tile=row_tile)  # noqa: E731
        weights = (1,)
    elif kind == "scaled":
        args = (lhs, w1, s1)
        jfn = lambda a, b, s: jg.gmm_scaled(a, b, jte, s, row_tile=row_tile)  # noqa: E731
        tfn = lambda a, b, s: tg.gmm_scaled(a, b, tte, s, row_tile=row_tile)  # noqa: E731
        weights = (1,)
    else:
        args = (lhs, w1, w3, s1, s3)
        jfn = lambda a, b, c, sa, sb: jg.gmm_swiglu(  # noqa: E731
            a, b, c, jte, sa, sb, row_tile=row_tile)
        tfn = lambda a, b, c, sa, sb: tg.gmm_swiglu(  # noqa: E731
            a, b, c, tte, sa, sb, row_tile=row_tile)
        weights = (1, 2)
    jgrads, tgrads = _grads(jfn, tfn, [jnp.asarray(a) for a in args],
                            [torch.from_numpy(a) for a in args], dout)
    for i, (j, t) in enumerate(zip(jgrads, tgrads)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        _close(t, j, 1e-4)
    unrouted = sorted(set(range(E)) - set(te.tolist()))
    for i in weights:
        for e in unrouted:
            assert float(jnp.abs(jgrads[i][e]).max()) == 0.0
            assert tgrads[i][e].abs().max().item() == 0.0
        assert tgrads[i][int(te[0])].abs().max().item() > 0.0


@pytest.mark.parametrize("row_tile", [128, 256])
def test_tgmm_plain_matches_jax_drhs(row_tile):
    """K7's plain version against the JAX kernel behind `_drhs` (tiles of
    one expert summed, unrouted experts zeroed)."""
    rng = np.random.default_rng(row_tile)
    te = np.array([0, 0, 2], np.int32)
    lhs = rng.standard_normal((3 * row_tile, K)).astype(np.float32)
    dout = rng.standard_normal((3 * row_tile, N)).astype(np.float32)
    j = jg._drhs(jnp.asarray(lhs), jnp.asarray(dout), jnp.asarray(te), E)
    t = tg.tgmm(torch.from_numpy(lhs), torch.from_numpy(dout), torch.from_numpy(te), E)
    assert t.dtype == torch.float32 and tuple(t.shape) == (E, K, N)
    _close(t, j, 1e-4)
    assert t[1].abs().max().item() == 0.0


def _raises_like_jax(jcall, tcall):
    with pytest.raises(ValueError) as je:
        jcall()
    with pytest.raises(ValueError) as te:
        tcall()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kind", ["gmm", "gmm_scaled", "gmm_swiglu"])
def test_row_tile_refusals_match_jax(kind):
    """_check_row_tile: a row tile that is not a multiple of 128, rows that
    are not whole row tiles, and a tile map of the wrong length all refuse
    with the JAX package's messages."""
    lhs = np.zeros((256, K), np.float32)
    w = np.zeros((E, K, N), np.float32)
    s = np.ones((E, N), np.float32)
    bad = [(lhs, np.zeros(2, np.int32), 64),            # row_tile % 128
           (lhs[:200], np.zeros(1, np.int32), 128),     # ragged rows
           (lhs, np.zeros(1, np.int32), 128)]           # truncated tile map
    for a, te, rt in bad:
        ja, jw, js, jte = (jnp.asarray(x) for x in (a, w, s, te))
        ta, tw, ts, tte = (torch.from_numpy(x) for x in (a, w, s, te))
        if kind == "gmm":
            _raises_like_jax(lambda: jg.gmm(ja, jw, jte, row_tile=rt),
                             lambda: tg.gmm(ta, tw, tte, row_tile=rt))
        elif kind == "gmm_scaled":
            _raises_like_jax(lambda: jg.gmm_scaled(ja, jw, jte, js, row_tile=rt),
                             lambda: tg.gmm_scaled(ta, tw, tte, ts, row_tile=rt))
        else:
            _raises_like_jax(lambda: jg.gmm_swiglu(ja, jw, jw, jte, js, js, row_tile=rt),
                             lambda: tg.gmm_swiglu(ta, tw, tw, tte, ts, ts, row_tile=rt))


def test_row_tile_of_refusals_match_jax():
    for m, n_tiles in ((300, 2), (192, 3)):  # ragged tail; tile of 64 rows
        te = np.zeros(n_tiles, np.int32)
        _raises_like_jax(lambda: jg._row_tile_of(m, te, "gmm"),
                         lambda: tg._row_tile_of(m, te, "gmm"))
    assert tg._row_tile_of(1024, np.zeros(2, np.int32), "gmm") == 512


def test_plain_versions_need_no_card_and_count_no_launch():
    """CPU tensors take the plain versions: the launch counters do not move."""
    lhs, w1, w3, te, s1, s3 = _operands(3, 128, False)
    before = (tg.gmm.launches, tg.gmm_scaled.launches, tg.gmm_swiglu.launches,
              tg.tgmm.launches)
    args = [torch.from_numpy(a) for a in (lhs, w1, w3, te, s1, s3)]
    x = args[0].requires_grad_(True)
    out = tg.gmm_swiglu(x, *args[1:])
    tg.gmm(out, args[1], args[3]).sum().backward()
    tg.gmm_scaled(x, args[1], args[3], args[4])
    assert (tg.gmm.launches, tg.gmm_scaled.launches, tg.gmm_swiglu.launches,
            tg.tgmm.launches) == before


def test_tgmm_plain_bf16_out_is_one_cast_of_the_f32_sum():
    """out_dtype=bf16 is the f32 sum rounded once: bit for bit the separate
    cast the backward used to make (JAX's drhs.astype(rhs.dtype)); CPU
    tensors take it through `tgmm` too."""
    rng = np.random.default_rng(11)
    te = torch.from_numpy(np.array([2, 0, 2], np.int32))
    lhs = torch.from_numpy(rng.standard_normal((3 * 128, K)).astype(np.float32)).to(torch.bfloat16)
    dout = torch.from_numpy(rng.standard_normal((3 * 128, N)).astype(np.float32)).to(torch.bfloat16)
    f32 = tg.tgmm_plain(lhs, dout, te, E)
    got = tg.tgmm_plain(lhs, dout, te, E, out_dtype=torch.bfloat16)
    assert f32.dtype == torch.float32 and got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    assert torch.equal(tg.tgmm(lhs, dout, te, E, out_dtype=torch.bfloat16), got)
    assert got[1].abs().max().item() == 0.0


@pytest.mark.parametrize("kind", ["gmm", "scaled", "swiglu"])
def test_gradients_match_jax_vjp_bf16(kind):
    """The three autograd Functions with bf16 operands against jax.vjp in
    bf16: the weight gradients come out of K7 as bf16 (out_dtype=rhs.dtype)
    where JAX casts the f32 drhs; every gradient within 2e-2 of max|JAX|
    (one bf16 rounding, sums in another order)."""
    row_tile = 128
    lhs, w1, w3, te, s1, s3 = _operands(31, row_tile, False)
    dout = np.random.default_rng(32).standard_normal((lhs.shape[0], N)).astype(np.float32)
    jte, tte = jnp.asarray(te), torch.from_numpy(te)
    if kind == "gmm":
        args, weights = (lhs, w1), (1,)
        jfn = lambda a, b: jg.gmm(a, b, jte, row_tile=row_tile)  # noqa: E731
        tfn = lambda a, b: tg.gmm(a, b, tte, row_tile=row_tile)  # noqa: E731
    elif kind == "scaled":
        args, weights = (lhs, w1), (1,)
        js, ts = jnp.asarray(s1), torch.from_numpy(s1)
        jfn = lambda a, b: jg.gmm_scaled(a, b, jte, js, row_tile=row_tile)  # noqa: E731
        tfn = lambda a, b: tg.gmm_scaled(a, b, tte, ts, row_tile=row_tile)  # noqa: E731
    else:
        args, weights = (lhs, w1, w3), (1, 2)
        js1, js3 = jnp.asarray(s1), jnp.asarray(s3)
        ts1, ts3 = torch.from_numpy(s1), torch.from_numpy(s3)
        jfn = lambda a, b, c: jg.gmm_swiglu(  # noqa: E731
            a, b, c, jte, js1, js3, row_tile=row_tile)
        tfn = lambda a, b, c: tg.gmm_swiglu(  # noqa: E731
            a, b, c, tte, ts1, ts3, row_tile=row_tile)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    tleaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in args]
    jout, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(dout, jnp.bfloat16))
    tout = tfn(*tleaves)
    _close(tout.detach(), jout, 2e-2)
    tgrads = torch.autograd.grad(tout, tleaves, torch.from_numpy(dout).to(torch.bfloat16))
    for j, t in zip(jgrads, tgrads):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        _close(t, j, 2e-2)
    for i in weights:
        assert tgrads[i][1].abs().max().item() == 0.0  # expert 1 owns no tile


ROUTES = [(dt, trans, epi) for dt in (torch.bfloat16, torch.int8) for trans in (False, True)
          for epi in (tg.EPI_NONE, tg.EPI_SCALE, tg.EPI_SWIGLU)]


@pytest.mark.parametrize("dtype,trans,epi", ROUTES)
def test_kernel_source_names_each_route(dtype, trans, epi):
    """K5 and K8 (bf16 and int8 weights) and K6 on bf16 weights, in either
    layout, go to the TMA/wgmma source; K6 on int8 weights, in either
    layout, to the mma.sync source; the scaled and SwiGLU products refuse
    the transposed layout."""
    if trans and epi != tg.EPI_NONE:
        with pytest.raises(ValueError):
            tg.kernel_source(dtype, trans, epi)
        return
    want = tg.MMA_SYNC if dtype == torch.int8 and epi == tg.EPI_NONE else tg.SM90
    assert tg.kernel_source(dtype, trans, epi) == want


def test_kernel_source_refuses_other_weight_dtypes():
    with pytest.raises(TypeError):
        tg.kernel_source(torch.float32, False, tg.EPI_NONE)
    with pytest.raises(ValueError):
        tg.kernel_source(torch.bfloat16, False, 7)


# routed rows R of chip_smoke.py's phase-2c shapes (top 2 of 8 experts)
PHASE_2C = {"train_R8184": 8184, "prefill_R8192": 8192, "decode_R16": 16,
            "tile512_R32768": 32768, "skewed_R8184": 8184}


@pytest.mark.parametrize("shape", sorted(PHASE_2C))
def test_sm90_tile_n_at_the_phase_2c_shapes(shape):
    """The epilogue kernel's tile width: K5 always 128 (w1's and w3's
    128-wide panels); K8 (N = 4096) 256 unless that gives fewer than two
    waves of 132 SMs, which only decode's m_pad 1152 does (144 tiles, 288
    at 128 wide)."""
    from kubedl_tpu_torch.models import moe

    r = PHASE_2C[shape]
    tile = moe._row_tile(r, 8)
    m_pad = (r + tile - 1) // tile * tile + 8 * tile  # as moe._dispatch_plan pads
    assert tg.sm90_tile_n(m_pad, 14336, tg.EPI_SWIGLU) == 128
    tiles256 = (m_pad // 128) * 16
    want = 128 if shape == "decode_R16" else 256
    assert (tiles256 < 2 * 132) == (want == 128)
    assert tg.sm90_tile_n(m_pad, 4096, tg.EPI_SCALE) == want
    # a card with fewer SMs takes the wide tile sooner
    assert tg.sm90_tile_n(m_pad, 4096, tg.EPI_SCALE, sms=64) == 256
    with pytest.raises(ValueError):
        tg.sm90_tile_n(m_pad, 4096, tg.EPI_NONE)
