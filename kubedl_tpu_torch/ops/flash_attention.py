"""Flash attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of kubedl_tpu/ops/flash_attention.py. The semantics are that
module's: [batch, heads, seq, head_dim] tensors, GQA (k/v may carry fewer
heads, q_heads % kv_heads == 0), an optional causal sliding window (query i
attends keys in (i - window, i]), and Gemma-2's softcap cap*tanh(s/cap) on
the scaled scores before masking. The TPU module's dispatch constants
(FLASH_MIN_SEQ, STREAM_MIN_SEQ, BWD_MAX_SEQ, 128-lane alignment, block
snapping) describe its VMEM and MXU and are not carried over.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernel (ops/csrc/flash_fwd.cu) or the call raises on a dtype, head dim or
shape the kernel does not take. There is no fallback between the two.
Forward only: the backward kernels come with training.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from kubedl_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)  # the kernel's template widths


def _check(q, k, v, causal, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [batch, heads, seq, head_dim]")
    b, hq, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {k.shape[1]}")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (sliding window "
                             "is a causal-attention concept)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")


def _mask(s: int, causal: bool, window: Optional[int], device) -> Optional[torch.Tensor]:
    if not causal:
        return None
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    m = kp <= qp
    if window is not None:
        m &= kp > qp - window
    return m


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (out [b, hq, s, d] in q's
    dtype, lse [b, hq, s] f32), computed in f32. GQA groups the query heads
    under their KV head (head h reads KV head h // rep) instead of
    repeating K/V."""
    _check(q, k, v, causal, window, softcap)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, rep, s, d)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * sm_scale
    if softcap is not None:
        sc = torch.tanh(sc / softcap) * softcap
    mask = _mask(s, causal, window, q.device)
    if mask is not None:
        sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p / l, v.float())
    lse = (m + torch.log(l))[..., 0]
    return (out.reshape(b, hq, s, d).to(q.dtype), lse.reshape(b, hq, s))


def attention_reference(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain attention (the JAX module's attention_reference): out only."""
    return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                 window=window, softcap=softcap)[0]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """A view the kernel can read: unit last stride, other strides whole
    16-byte vectors, 16-byte aligned base. The strided q/k/v that the model
    passes already are; anything else is copied once here."""
    ok = (x.stride(-1) == 1 and all(st % 8 == 0 for st in x.stride()[:-1])
          and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def _lib():
    lib = _build.load("flash_fwd")
    fn = lib.kubedl_flash_fwd_bf16
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([P] * 5 + [I] * 6 + [L] * 12
                       + [ctypes.c_float, I, I, ctypes.c_float, P])
        fn.restype = I
        lib.kubedl_cuda_error_string.argtypes = [I]
        lib.kubedl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: (out [b, hq, s, d] bf16, lse [b, hq, s] f32).

    Takes bf16 CUDA tensors with head_dim <= 256; a head dim outside
    {64, 128, 256} is zero-padded up to the next of them (zero K columns add
    nothing to q.k, zero V columns give zero output columns, which are not
    written). `out` is returned as a [b, hq, s, d] view of a [b, s, hq, d]
    buffer, so the model's transpose back to [b, s, hq*d] is free."""
    _check(q, k, v, causal, window, softcap)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention_fwd: {name} is on {x.device}, "
                             f"the kernel needs CUDA tensors")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_fwd: {name} is {x.dtype}; the "
                            f"kernel takes bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    dk = next((w for w in HEAD_DIMS if w >= d), None)
    if dk is None:
        raise ValueError(f"flash_attention_fwd: head_dim {d} > {HEAD_DIMS[-1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if dk != d:
        q, k, v = (F.pad(x, (0, dk - d)) for x in (q, k, v))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.kubedl_flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, hq, hkv, s, dk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_fwd kernel launch failed: CUDA error {err} "
            f"({lib.kubedl_cuda_error_string(err).decode()}) at "
            f"b={b} hq={hq} hkv={hkv} s={s} d={d}")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention over [batch, q_heads, seq, head_dim] tensors (GQA k/v).

    CPU tensors run `flash_attention_plain`; CUDA tensors run the kernel,
    at every sequence length, or raise. `flash_attention.launches` counts
    kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                     window=window, softcap=softcap)[0]
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               window=window, softcap=softcap)[0]


flash_attention.launches = 0
