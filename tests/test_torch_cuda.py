"""kubedl_tpu_torch on the card: each CUDA kernel against its plain PyTorch
version, and the model path through the kernel. Every test here needs an
NVIDIA GPU and nvcc and skips without them; the file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from kubedl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(dev, b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32))
        .to(dev, torch.bfloat16)
        for h in (hq, hkv, hkv))


# (b, hq, hkv, s, d, causal, window, softcap)
KERNEL_CASES = [
    (2, 4, 4, 256, 128, True, None, None),
    (1, 4, 4, 200, 128, True, None, None),      # ragged tail
    (2, 8, 2, 130, 128, True, None, None),      # GQA
    (1, 4, 4, 333, 128, True, 100, None),       # window
    (1, 4, 4, 190, 128, True, None, 50.0),      # softcap
    (1, 2, 2, 160, 64, True, None, None),
    (1, 2, 2, 96, 256, True, None, None),
    (1, 2, 1, 70, 40, True, None, None),        # d padded 40 -> 64
    (1, 2, 2, 150, 128, False, None, None),     # not causal
    (1, 1, 1, 1, 128, True, None, None),        # one token
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,softcap", KERNEL_CASES)
def test_flash_fwd_kernel_matches_plain(dev, b, hq, hkv, s, d, causal, window,
                                        softcap):
    q, k, v = _qkv(dev, b, hq, hkv, s, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = fa.flash_attention.launches
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, **kw)
    assert out.shape == (b, hq, s, d) and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def _rel_err(got, ref):
    """max|got - ref| / max|ref|, with a 1e-4 floor on the scale: a
    gradient that is exactly zero in f32 (one token: ds = 0) comes out of
    the kernel as rounding noise."""
    scale = max(ref.float().abs().max().item(), 1e-4)
    return (got.float() - ref.float()).abs().max().item() / scale


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,softcap", KERNEL_CASES)
def test_flash_bwd_kernels_match_plain(dev, b, hq, hkv, s, d, causal, window, softcap):
    """dq and dkv kernels against the f32 plain backward on the same bf16
    inputs: max|kernel - plain| / max|plain| <= 2e-2 (bf16 p and ds before
    their products, bf16 outputs), and two launches give the same bits."""
    q, k, v = _qkv(dev, b, hq, hkv, s, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dout = _qkv(dev, b, hq, hq, s, d, seed=1)[0]
    n0 = (fa.flash_attention.bwd_dq_launches, fa.flash_attention.bwd_dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.bwd_dq_launches, fa.flash_attention.bwd_dkv_launches) == (
        n0[0] + 1, n0[1] + 1)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), **kw)
    for name, g, r, x in zip(("dq", "dk", "dv"), got, ref, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, r) <= 2e-2, (name, _rel_err(g, r))
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_flash_autograd_through_the_kernels(dev):
    """flash_attention with requires_grad on CUDA tensors: forward kernel,
    backward kernels, gradients as the plain version's autograd gives them;
    the inputs are the model's transpose(1, 2) views."""
    b, s, hq, hkv, d = 2, 150, 4, 2, 128
    rng = np.random.default_rng(4)

    def view(h):
        x = torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
        return x.to(dev, torch.bfloat16).transpose(1, 2).requires_grad_(True)

    q, k, v = view(hq), view(hkv), view(hkv)
    dout = torch.from_numpy(rng.standard_normal((b, hq, s, d), np.float32)).to(dev)
    launches = (fa.flash_attention.launches, fa.flash_attention.bwd_dq_launches,
                fa.flash_attention.bwd_dkv_launches)
    out = fa.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), dout.to(torch.bfloat16))
    assert (fa.flash_attention.launches, fa.flash_attention.bwd_dq_launches,
            fa.flash_attention.bwd_dkv_launches) == tuple(n + 1 for n in launches)
    qf, kf, vf = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    ref_out = fa.flash_attention_plain(qf, kf, vf, causal=True)[0]
    ref = torch.autograd.grad(ref_out, (qf, kf, vf), dout)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= 2e-2


def test_flash_bwd_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 2, 2, 64, 128)
    out, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, k, v, out, lse, out.float())
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse[:, :1], out)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q.cpu(), k, v, out, lse, out)
    big = torch.zeros(1, 1, 8, 320, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(big, big, big, big, torch.zeros(1, 1, 8, device=dev), big)


def test_flash_fwd_strided_input_needs_no_copy(dev):
    """[b, s, h, d] -> transpose(1, 2), as the model passes q/k/v."""
    b, s, h, d = 2, 100, 4, 128
    rng = np.random.default_rng(1)
    x = [torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
         .to(dev, torch.bfloat16).transpose(1, 2) for _ in range(3)]
    out, _ = fa.flash_attention_fwd(*x, causal=True)
    ref, _ = fa.flash_attention_plain(*x, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    # the output buffer is [b, s, h, d]: the model's transpose back is a view
    assert out.transpose(1, 2).is_contiguous()


# flash_fwd_sm90.cu (TMA, wgmma) beyond KERNEL_CASES, which it takes too:
# (b, hq, hkv, s, d, causal, window, softcap)
SM90_CASES = [
    (1, 4, 4, 1000, 128, True, None, None),     # S not a multiple of 128
    (1, 2, 2, 70, 128, True, None, None),       # S < 128: one zero-filled tile
    (4, 32, 32, 1024, 128, True, None, None),   # more items than 132 CTAs: persistent loop
    (2, 32, 8, 300, 128, True, None, None),     # GQA 32/8
    (1, 4, 4, 333, 128, True, 100, None),       # window across tiles: rows whose first tile is
                                                # all masked
    (1, 4, 4, 777, 128, True, 1, None),         # window 1: all keys but one masked in every row
    (1, 4, 2, 300, 128, True, None, 30.0),      # softcap
    (1, 2, 2, 200, 40, True, None, None),       # d 40 padded to 64
    (2, 4, 4, 260, 64, False, None, None),      # not causal
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,softcap", SM90_CASES)
def test_flash_fwd_sm90_matches_plain_and_mma_sync(dev, b, hq, hkv, s, d, causal, window,
                                                   softcap):
    """The TMA/wgmma forward against the plain version (out 2e-2, LSE 1e-3,
    finite everywhere), two launches bit-identical, and the mma.sync kernel
    at the same shape within twice those (each is within them of plain)."""
    assert fa.kernel_source(d) == fa.SM90
    q, k, v = _qkv(dev, b, hq, hkv, s, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    again, again_lse = fa.flash_attention_fwd(q, k, v, **kw)
    old, old_lse = fa.flash_attention_fwd(q, k, v, source=fa.MMA_SYNC, **kw)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - ref).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(out, again) and torch.equal(lse, again_lse)
    assert (out.float() - old.float()).abs().max().item() <= 4e-2
    assert (lse - old_lse).abs().max().item() <= 2e-3


def test_flash_fwd_sm90_reads_strided_views_in_place(dev):
    """The model's q/k/v, transpose(1, 2) views of [b, s, h, d] buffers, go
    to the tensor maps as they are (no copy), GQA included."""
    b, s, hq, hkv, d = 2, 300, 8, 2, 128
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
               .to(dev, torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv))
    for x in (q, k, v):
        assert not x.is_contiguous() and fa._aligned(x).data_ptr() == x.data_ptr()
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


def test_flash_fwd_sm90_refuses_what_it_does_not_take(dev):
    big = torch.zeros(1, 1, 8, 256, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(big, big, big, source=fa.SM90)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(big, big, big, source="flash_fwd_sm80")


# flash_bwd_sm90.cu (TMA, wgmma) on every KERNEL_CASES row it takes, and
# beyond them: the main training shape's tail and GQA 32/8 over many items
SM90_BWD_CASES = [c for c in KERNEL_CASES if c[4] <= 128] + [
    (4, 32, 32, 1023, 128, True, None, None),   # S 1023: a ragged q tile and a masked S tail
    (2, 32, 8, 300, 128, True, None, None),     # GQA 32/8: dK, dV summed over 4 query heads
    (1, 4, 4, 777, 128, True, 2, None),         # window 2: two keys a row, tiles mostly masked
]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,softcap", SM90_BWD_CASES)
def test_flash_bwd_sm90_matches_plain_and_mma_sync(dev, b, hq, hkv, s, d, causal, window,
                                                   softcap):
    """The TMA/wgmma backward against the f32 plain backward (max|kernel -
    plain| / max|plain| <= 2e-2 for dq, dk, dv, finite), two launches
    bit-identical, and flash_bwd.cu's mma.sync kernels at the same shape
    within twice that (each is within it of plain)."""
    assert fa.bwd_kernel_source(d) == fa.BWD_SM90
    q, k, v = _qkv(dev, b, hq, hkv, s, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dout = _qkv(dev, b, hq, hq, s, d, seed=1)[0]
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, source=fa.BWD_SM90, **kw)
    old = fa.flash_attention_bwd(q, k, v, out, lse, dout, source=fa.BWD_MMA_SYNC, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), **kw)
    for name, g, a, o, r in zip(("dq", "dk", "dv"), got, again, old, ref):
        assert torch.isfinite(g.float()).all(), name
        assert _rel_err(g, r) <= 2e-2, (name, _rel_err(g, r))
        assert torch.equal(g, a), name
        assert _rel_err(g, o) <= 4e-2, (name, _rel_err(g, o))


def test_flash_bwd_sm90_reads_strided_views_in_place(dev):
    """The model's q/k/v/out/dout, transpose(1, 2) views of [b, s, h, d]
    buffers, go to the tensor maps as they are (no copy), GQA included."""
    b, s, hq, hkv, d = 2, 300, 8, 2, 128
    rng = np.random.default_rng(6)

    def view(h):
        return (torch.from_numpy(rng.standard_normal((b, s, h, d), np.float32))
                .to(dev, torch.bfloat16).transpose(1, 2))

    q, k, v, dout = view(hq), view(hkv), view(hkv), view(hq)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    launches, _ = fa._bwd_launch_args(q, k, v, out, lse, dout, True, None, None, None)
    assert launches["dq"][0] == fa.BWD_SM90
    for x, y in zip((q, k, v, out, dout), launches["dq"][1]):
        assert not x.is_contiguous() and y.data_ptr() == x.data_ptr()
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), causal=True)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= 2e-2


def test_flash_bwd_sm90_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 2, 2, 64, 128)
    out, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, k, v, out, lse, out.float(), source=fa.BWD_SM90)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse[:, :1], out, source=fa.BWD_SM90)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse, out, source="flash_bwd_sm80")
    big = torch.zeros(1, 1, 8, 256, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(big, big, big, big, torch.zeros(1, 1, 8, device=dev), big,
                               source=fa.BWD_SM90)


@pytest.fixture(scope="module")
def tiny_bf16(dev):
    from kubedl_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(d_model=256, n_heads=2, n_kv_heads=1)  # hd 128
    return cfg, llama.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def test_prefill_through_kernel_matches_plain_attention(dev, tiny_bf16):
    import dataclasses

    from kubedl_tpu_torch.models import decode

    cfg, params = tiny_bf16
    toks = torch.randint(0, cfg.vocab_size, (3, 90), device=dev, dtype=torch.int32)
    lengths = torch.tensor([90, 41, 7], device=dev, dtype=torch.int32)
    out = {}
    for label, c in (("kernel", cfg), ("plain", dataclasses.replace(cfg, use_flash=False))):
        n0 = fa.flash_attention.launches
        cache = decode.init_kv_cache(c, 3, 96, device=dev)
        logits, _ = decode.prefill(params, toks, cache, c, lengths=lengths)
        out[label] = (logits.float(), fa.flash_attention.launches - n0)
    assert out["kernel"][1] == cfg.n_layers and out["plain"][1] == 0
    diff = (out["kernel"][0] - out["plain"][0]).abs().max().item()
    assert diff <= 0.05 * out["plain"][0].abs().max().item()


def test_loss_grads_through_kernels_match_plain_attention(dev, tiny_bf16):
    """loss_fn and every gradient with attention through the kernels
    (forward twice a layer under full remat, dq and dkv once) against
    use_flash=False; bf16 model, so max|diff| / max|plain| <= 5e-2."""
    import dataclasses

    from kubedl_tpu_torch.models import llama

    cfg, params = tiny_bf16
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(5))
    out = {}
    for label, c in (("kernel", cfg), ("plain", dataclasses.replace(cfg, use_flash=False))):
        tree = llama.tree_map(lambda x: x.detach().clone().requires_grad_(True), params)
        leaves = list(llama.tree_leaves(tree))
        n0 = (fa.flash_attention.launches, fa.flash_attention.bwd_dq_launches,
              fa.flash_attention.bwd_dkv_launches)
        loss = llama.loss_fn(tree, toks, c)
        grads = torch.autograd.grad(loss, leaves)
        n1 = (fa.flash_attention.launches, fa.flash_attention.bwd_dq_launches,
              fa.flash_attention.bwd_dkv_launches)
        out[label] = (loss.item(), grads, tuple(b - a for a, b in zip(n0, n1)))
    n = cfg.n_layers
    assert out["kernel"][2] == (2 * n, n, n) and out["plain"][2] == (0, 0, 0)
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-2 * abs(out["plain"][0])
    for g, r in zip(out["kernel"][1], out["plain"][1]):
        assert g.dtype == r.dtype and torch.isfinite(g.float()).all()
        assert _rel_err(g, r) <= 5e-2


def test_engine_on_the_card_matches_generate(dev, tiny_bf16):
    from kubedl_tpu_torch.models import decode
    from kubedl_tpu_torch.models.serving import ServingEngine

    cfg, params = tiny_bf16
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 40, 100)]
    n0 = fa.flash_attention.launches
    eng = ServingEngine(params, cfg, slots=4, max_len=128)
    outs = eng.serve_all(prompts, 6)
    assert fa.flash_attention.launches - n0 == cfg.n_layers * eng.stats()["prefill_batches"]
    for p, o in zip(prompts, outs):
        assert len(o) == 6 and all(0 <= t < cfg.vocab_size for t in o)
    # the same traffic drained tick by tick gives the same tokens
    again = ServingEngine(params, cfg, slots=4, max_len=128)
    reqs = [again.submit(p, 6) for p in prompts]
    while again.has_pending():
        again.step()
    assert [r.tokens for r in reqs] == outs
    # generate on the card runs (uniform cache, kernel prefill)
    gen = decode.generate(params, torch.from_numpy(prompts[1]).to(dev)[None], cfg, 6)
    assert gen.shape == (1, 6)


def test_flash_fwd_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(dev, 1, 2, 2, 64, 128)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
    big = torch.zeros(1, 1, 8, 320, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(big, big, big)


# -- grouped matmul kernels (ops/csrc/gmm_sm90.cu, gmm.cu) ----------------------

def _gmm_operands(dev, kind, int8, trans, row_tile, m_tiles=3, k=272, n=400, e=4, seed=0):
    """bf16 lhs; bf16 or int8 weights [E, K, N], or the transpose(1, 2) view
    of an [E, N, K] stack; K and N not multiples of the 128-wide tiles."""
    from kubedl_tpu_torch.ops import gmm as G

    rng = np.random.default_rng(seed)
    lhs = torch.from_numpy(rng.standard_normal((m_tiles * row_tile, k), np.float32)).to(
        dev, torch.bfloat16)

    def stack():
        shape = (e, n, k) if trans else (e, k, n)
        if int8:
            w = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
        else:
            w = torch.from_numpy(rng.standard_normal(shape, np.float32) * 0.1).to(
                dev, torch.bfloat16)
        return w.transpose(1, 2) if trans else w

    w1, w3 = stack(), stack()
    scale = (1 / 127.0 if int8 else 1.0) * 0.5
    s1, s3 = (torch.from_numpy(rng.uniform(0.5, 1.5, (e, n)).astype(np.float32)).to(dev) * scale
              for _ in range(2))
    # expert 1 owns no tile; the last tile is a clamped padding tile
    te = torch.tensor(([0] + [2] * (m_tiles - 2) + [3])[:m_tiles], dtype=torch.int32, device=dev)
    return G, lhs, w1, w3, s1, s3, te


# (kind, int8 weights, transposed weights, row tile)
GMM_CASES = [
    ("gmm", False, False, 128), ("gmm", False, True, 128), ("gmm", True, False, 256),
    ("gmm", True, True, 128), ("gmm", False, False, 512),
    ("scaled", False, False, 128), ("scaled", True, False, 256),
    ("swiglu", False, False, 128), ("swiglu", True, False, 128), ("swiglu", False, False, 256),
]


@pytest.mark.parametrize("kind,int8,trans,row_tile", GMM_CASES)
def test_gmm_kernels_match_plain(dev, kind, int8, trans, row_tile):
    """K6 (both weight layouts), K8 and K5 against their plain versions on
    the same bf16/int8 inputs: max|kernel - plain| <= 2e-2 max|plain| (one
    bf16 rounding of the output); each call launches its kernel once."""
    G, lhs, w1, w3, s1, s3, te = _gmm_operands(dev, kind, int8, trans, row_tile)
    counter = {"gmm": G.gmm, "scaled": G.gmm_scaled, "swiglu": G.gmm_swiglu}[kind]
    n0 = counter.launches
    if kind == "gmm":
        got, ref = G.gmm_cuda(lhs, w1, te), G.gmm_plain(lhs, w1, te)
    elif kind == "scaled":
        got, ref = G.gmm_cuda(lhs, w1, te, s1), G.gmm_scaled_plain(lhs, w1, te, s1)
    else:
        got = G.gmm_swiglu_cuda(lhs, w1, w3, te, s1, s3)
        ref = G.gmm_swiglu_plain(lhs, w1, w3, te, s1, s3)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, ref) <= 2e-2, _rel_err(got, ref)


@pytest.mark.parametrize("row_tile", [128, 256])
def test_tgmm_kernel_matches_plain_and_is_deterministic(dev, row_tile):
    """K7: f32 [E, K, N] within 1e-3 of max|plain|, the unrouted expert
    exactly zero, two launches bit-identical (no atomics)."""
    G, lhs, _, _, _, _, te = _gmm_operands(dev, "gmm", False, False, row_tile, m_tiles=4)
    rng = np.random.default_rng(9)
    dout = torch.from_numpy(rng.standard_normal((lhs.shape[0], 400), np.float32)).to(
        dev, torch.bfloat16)
    n0 = G.tgmm.launches
    got = G.tgmm_cuda(lhs, dout, te, 4)
    again = G.tgmm_cuda(lhs, dout, te, 4)
    torch.cuda.synchronize()
    assert G.tgmm.launches == n0 + 2
    ref = G.tgmm_plain(lhs, dout, te, 4)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_err(got, ref) <= 1e-3
    assert got[1].abs().max().item() == 0.0
    assert torch.equal(got, again)


def _strided(x, extra=48):
    """x as a column slice of a wider matrix: row stride K + extra, not K."""
    wide = torch.zeros((x.shape[0], x.shape[1] + extra), dtype=x.dtype, device=x.device)
    wide[:, :x.shape[1]] = x
    return wide[:, :x.shape[1]]


# (transposed weights, row tile, row tiles, strided lhs): K = 272 and N = 400
# leave ragged TMA boxes; one row tile is fewer output tiles than SMs, 150
# row tiles (300 output tiles) many more
SM90_GMM_CASES = [
    (False, 128, 3, False), (True, 128, 3, False), (False, 256, 3, False),
    (False, 512, 2, False), (True, 512, 2, False), (False, 128, 1, False),
    (True, 128, 150, False), (False, 128, 150, False), (False, 128, 3, True),
    (True, 256, 3, True),
]


@pytest.mark.parametrize("trans,row_tile,m_tiles,strided", SM90_GMM_CASES)
def test_gmm_sm90_kernel_matches_plain(dev, trans, row_tile, m_tiles, strided):
    """K6 on bf16 weights through gmm_sm90.cu (TMA, wgmma, persistent grid)
    against gmm_plain: within 2e-2 of max|plain|, one launch, and the same
    bits from a second launch."""
    G, lhs, w1, _, _, _, te = _gmm_operands(dev, "gmm", False, trans, row_tile, m_tiles=m_tiles)
    assert G.kernel_source(w1.dtype, trans, G.EPI_NONE) == G.SM90
    if strided:
        lhs = _strided(lhs)
        assert lhs.stride(0) != lhs.shape[1]
    n0 = G.gmm.launches
    got = G.gmm_cuda(lhs, w1, te)
    again = G.gmm_cuda(lhs, w1, te)
    torch.cuda.synchronize()
    assert G.gmm.launches == n0 + 2
    ref = G.gmm_plain(lhs, w1, te)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, ref) <= 2e-2, _rel_err(got, ref)
    assert torch.equal(got, again)


# (out dtype, row tile, row tiles, strided lhs and dout)
SM90_TGMM_CASES = [
    (torch.float32, 128, 4, False), (torch.bfloat16, 128, 4, False),
    (torch.float32, 256, 4, False), (torch.bfloat16, 256, 4, False),
    (torch.float32, 512, 3, False), (torch.bfloat16, 512, 3, False),
    (torch.float32, 128, 1, False), (torch.float32, 128, 150, False),
    (torch.bfloat16, 128, 150, False), (torch.float32, 128, 4, True),
    (torch.bfloat16, 256, 4, True),
]


@pytest.mark.parametrize("out_dtype,row_tile,m_tiles,strided", SM90_TGMM_CASES)
def test_tgmm_sm90_kernel_matches_plain(dev, out_dtype, row_tile, m_tiles, strided):
    """K7 through gmm_sm90.cu at K = 272, N = 400: within 1e-3 (f32) or
    2e-2 (bf16) of max|plain|; the unrouted expert exactly zero; two
    launches bit-identical; the bf16 output is the f32 output rounded once."""
    G, lhs, _, _, _, _, te = _gmm_operands(dev, "gmm", False, False, row_tile, m_tiles=m_tiles)
    rng = np.random.default_rng(10)
    dout = torch.from_numpy(rng.standard_normal((lhs.shape[0], 400), np.float32)).to(
        dev, torch.bfloat16)
    if strided:
        lhs, dout = _strided(lhs), _strided(dout, 16)
    n0 = G.tgmm.launches
    got = G.tgmm_cuda(lhs, dout, te, 4, out_dtype=out_dtype)
    again = G.tgmm_cuda(lhs, dout, te, 4, out_dtype=out_dtype)
    f32 = G.tgmm_cuda(lhs, dout, te, 4)
    torch.cuda.synchronize()
    assert G.tgmm.launches == n0 + 3
    ref = G.tgmm_plain(lhs, dout, te, 4, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == ref.shape == (4, 272, 400)
    assert _rel_err(got, ref) <= (1e-3 if out_dtype == torch.float32 else 2e-2)
    assert got[1].abs().max().item() == 0.0
    assert torch.equal(got, again)
    assert torch.equal(got, f32.to(out_dtype))


def test_gmm_sm90_refuses_what_it_does_not_take(dev):
    G, lhs, w1, _, _, _, te = _gmm_operands(dev, "gmm", False, False, 128, k=256, n=256)
    dout = torch.zeros((lhs.shape[0], 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        G.tgmm_cuda(lhs, dout, te, 4, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        G.tgmm_cuda(lhs[:, :100], dout, te, 4)  # K % 8
    with pytest.raises(ValueError):
        G.gmm_cuda(lhs, w1[:, :, :200], te)  # N % 16
    # the epilogue kernel: K-major weights only, K % 16, aligned operands
    _, lhs_t, w_t, w3_t, s1, s3, te_t = _gmm_operands(dev, "scaled", True, True, 128)
    with pytest.raises(ValueError):
        G.gmm_cuda(lhs_t, w_t, te_t, s1)  # transposed int8 weights under a scale
    with pytest.raises(ValueError):
        G.gmm_swiglu_cuda(lhs_t, w_t, w3_t, te_t, s1, s3)
    _, lhs, w1, w3, s1, s3, te = _gmm_operands(dev, "swiglu", True, False, 128)
    with pytest.raises(ValueError):
        G.gmm_swiglu_cuda(lhs[:, :200], w1[:, :200], w3[:, :200], te, s1, s3)  # K % 16
    lib, out = G._lib_sm90(), torch.empty((lhs.shape[0], 400), dtype=torch.bfloat16, device=dev)
    te32 = te.to(torch.int32)
    stream = torch.cuda.current_stream().cuda_stream

    def call(a=lhs.data_ptr(), b1=w1.data_ptr(), b3=w3.data_ptr(), o=out.data_ptr(), epi=2,
             tile_n=128):
        return lib.kubedl_gmm_sm90_epi(a, b1, b3, s1.data_ptr(), s3.data_ptr(), o,
                                       te32.data_ptr(), lhs.shape[0], 400, 272, 128, 4,
                                       lhs.stride(0), 400, 272 * 400, 400, epi, 1, tile_n, stream)

    assert call() == 0
    torch.cuda.synchronize()
    for bad in (dict(a=lhs.data_ptr() + 2), dict(b1=w1.data_ptr() + 8), dict(b3=w3.data_ptr() + 4),
                dict(o=out.data_ptr() + 2), dict(tile_n=256), dict(tile_n=64), dict(epi=0)):
        assert call(**bad) != 0, bad


# K8 and K5 through gmm_sm90.cu's epilogue kernel: (kind, int8 weights, row
# tile, row tiles, strided lhs). K = 272 and N = 400 leave ragged TMA boxes;
# 150 row tiles make enough 256-wide tiles that K8 takes them (fewer take
# 128-wide ones, as at decode).
SM90_EPI_CASES = [
    (kind, int8, row_tile, m_tiles, False)
    for kind in ("scaled", "swiglu") for int8 in (False, True)
    for row_tile, m_tiles in ((128, 3), (256, 3), (512, 2), (128, 1), (128, 150))
] + [(kind, int8, 128, 3, True) for kind in ("scaled", "swiglu") for int8 in (False, True)]


def _epi_call(G, kind, lhs, w1, w3, te, s1, s3):
    if kind == "scaled":
        return G.gmm_cuda(lhs, w1, te, s1), G.gmm_scaled_plain(lhs, w1, te, s1)
    return (G.gmm_swiglu_cuda(lhs, w1, w3, te, s1, s3),
            G.gmm_swiglu_plain(lhs, w1, w3, te, s1, s3))


@pytest.mark.parametrize("kind,int8,row_tile,m_tiles,strided", SM90_EPI_CASES)
def test_gmm_sm90_epi_kernel_matches_plain(dev, kind, int8, row_tile, m_tiles, strided):
    """K8 and K5 on bf16 and int8 weights through gmm_sm90.cu (TMA, int8
    widened in the kernel, wgmma): within 2e-2 of max|plain|, one launch a
    call, the same bits from a second launch."""
    G, lhs, w1, w3, s1, s3, te = _gmm_operands(dev, kind, int8, False, row_tile,
                                               m_tiles=m_tiles)
    epi = G.EPI_SCALE if kind == "scaled" else G.EPI_SWIGLU
    assert G.kernel_source(w1.dtype, False, epi) == G.SM90
    if strided:
        lhs = _strided(lhs)
        assert lhs.stride(0) != lhs.shape[1]
    counter = G.gmm_scaled if kind == "scaled" else G.gmm_swiglu
    n0 = counter.launches
    got, ref = _epi_call(G, kind, lhs, w1, w3, te, s1, s3)
    again = _epi_call(G, kind, lhs, w1, w3, te, s1, s3)[0]
    torch.cuda.synchronize()
    assert counter.launches == n0 + 2
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert _rel_err(got, ref) <= 2e-2, _rel_err(got, ref)
    assert torch.equal(got, again)


@pytest.mark.parametrize("kind", ["scaled", "swiglu"])
def test_gmm_sm90_epi_clamps_expert_indices(dev, kind):
    """An expert that owns no tile contributes nothing, and te entries
    outside [0, E) are clamped as the plain version clamps them."""
    G, lhs, w1, w3, s1, s3, _ = _gmm_operands(dev, kind, True, False, 128, m_tiles=4)
    te = torch.tensor([-3, 2, 2, 9], dtype=torch.int32, device=dev)  # -> 0, 2, 2, 3
    got, ref = _epi_call(G, kind, lhs, w1, w3, te, s1, s3)
    clamped = _epi_call(G, kind, lhs, w1, w3, te.clamp(0, 3), s1, s3)[0]
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= 2e-2, _rel_err(got, ref)
    assert torch.equal(got, clamped)


def test_gmm_autograd_through_the_kernels(dev):
    """gmm_swiglu then gmm on CUDA tensors: forward and backward through
    the kernels (K5, K6, K7), gradients within 2e-2 of the plain
    versions' autograd in f32 on the same inputs."""
    G, lhs, w1, w3, _, _, te = _gmm_operands(dev, "gmm", False, False, 128, k=256, n=256)
    w2 = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 256, 256), np.float32)
                          * 0.1).to(dev, torch.bfloat16)
    ones = torch.ones((4, 256), device=dev)
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal((lhs.shape[0], 256),
                                                                    np.float32)).to(dev)

    def run(fn_swiglu, fn_gmm, dtype):
        leaves = [x.detach().to(dtype).requires_grad_(True) for x in (lhs, w1, w3, w2)]
        h = fn_swiglu(leaves[0], leaves[1], leaves[2], te, ones, ones)
        out = fn_gmm(h, leaves[3], te)
        return torch.autograd.grad(out, leaves, dout.to(dtype))

    n0 = (G.gmm_swiglu.launches, G.gmm.launches, G.tgmm.launches)
    got = run(G.gmm_swiglu, G.gmm, torch.bfloat16)
    # forward K5 + K6; backward of gmm: K6 + K7; of swiglu: 2 K6 recompute,
    # 2 K6 for dlhs, 2 K7
    assert (G.gmm_swiglu.launches - n0[0], G.gmm.launches - n0[1],
            G.tgmm.launches - n0[2]) == (1, 6, 3)
    ref = run(G.gmm_swiglu_plain, G.gmm_plain, torch.float32)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        assert _rel_err(g, r) <= 2e-2


def test_gmm_rejects_what_it_does_not_take(dev):
    G, lhs, w1, _, _, _, te = _gmm_operands(dev, "gmm", False, False, 128, k=256, n=256)
    with pytest.raises(TypeError):
        G.gmm(lhs.float(), w1.float(), te)
    with pytest.raises(ValueError):
        G.gmm_cuda(lhs[:, :200], w1[:, :200], te)  # K % 16
    with pytest.raises(ValueError):
        G.gmm_cuda(lhs.cpu(), w1, te)
    with pytest.raises(TypeError):
        G.tgmm_cuda(lhs.float(), lhs.float(), te, 4)


@pytest.fixture(scope="module")
def tiny_moe(dev):
    from kubedl_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(d_model=256, n_heads=2, n_kv_heads=1, d_ff=512,
                                 n_experts=4, expert_top_k=2)
    return cfg, llama.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def test_moe_train_step_on_the_card(dev, tiny_moe):
    """One make_train_step step of a bf16 MoE llama with AdamW and clip:
    finite loss and grad norm, parameters moved, and per layer under full
    remat K5 2, K6 7 and K7 3 launches."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.ops import gmm as G
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    cfg, params = tiny_moe
    params = llama.tree_map(lambda x: x.detach().clone(), params)
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(1e-3, weight_decay=0.01))
    init_state, train_step = make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), tx)
    state = init_state(params)
    before = state.params["layers"][0]["moe"]["w1"].detach().clone()
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(6))
    n0 = (G.gmm_swiglu.launches, G.gmm.launches, G.tgmm.launches)
    state, metrics = train_step(state, toks)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert (G.gmm_swiglu.launches - n0[0], G.gmm.launches - n0[1],
            G.tgmm.launches - n0[2]) == (2 * n, 7 * n, 3 * n)
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    assert not torch.equal(before, state.params["layers"][0]["moe"]["w1"])


def test_moe_int8_engine_on_the_card(dev, tiny_moe):
    """The serving engine on the int8 MoE tree: prefill and decode run
    K5 and K8, ticks and admission drain the same tokens."""
    from kubedl_tpu_torch.models import quant
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.ops import gmm as G

    cfg, params = tiny_moe
    qp = quant.quantize_params(params)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in (5, 40, 100)]
    n0 = (G.gmm_swiglu.launches, G.gmm_scaled.launches, G.gmm.launches)
    outs = ServingEngine(qp, cfg, slots=4, max_len=128).serve_all(prompts, 6)
    assert G.gmm_swiglu.launches > n0[0] and G.gmm_scaled.launches > n0[1]
    assert G.gmm.launches == n0[2]  # int8 stacks never take the bf16 product
    again = ServingEngine(qp, cfg, slots=4, max_len=128)
    reqs = [again.submit(p, 6) for p in prompts]
    while again.has_pending():
        again.step()
    assert [r.tokens for r in reqs] == outs


def test_moe_decode_step_never_syncs_with_the_host(dev, tiny_moe):
    """Routing, dispatch and the int8 grouped products of a decode step stay
    on the device: under sync debug mode "error" a host sync would raise."""
    from kubedl_tpu_torch.models import decode, quant

    cfg, params = tiny_moe
    qp = quant.quantize_params(params)
    cache = decode.init_kv_cache(cfg, 4, 64, device=dev)
    toks = torch.randint(1, cfg.vocab_size, (4, 9), device=dev, dtype=torch.int32)
    logits, cache = decode.prefill(qp, toks, cache, cfg)
    nxt = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = decode.decode_step(qp, nxt, cache, cfg, check=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
