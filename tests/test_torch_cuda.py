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
