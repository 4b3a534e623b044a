"""Flash attention: hand-written CUDA kernels for Hopper (forward and
backward) and their plain PyTorch versions.

Counterpart of kubedl_tpu/ops/flash_attention.py. The semantics are that
module's: [batch, heads, seq, head_dim] tensors, GQA (k/v may carry fewer
heads, q_heads % kv_heads == 0), an optional causal sliding window (query i
attends keys in (i - window, i]), and Gemma-2's softcap cap*tanh(s/cap) on
the scaled scores before masking. The TPU module's dispatch constants
(FLASH_MIN_SEQ, STREAM_MIN_SEQ, BWD_MAX_SEQ, 128-lane alignment, block
snapping) describe its VMEM and MXU and are not carried over.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes the
kernels (ops/csrc/flash_fwd.cu forward, ops/csrc/flash_bwd.cu backward) or
the call raises on a dtype, head dim or shape they do not take. There is
no fallback between the two. When an input requires grad, `flash_attention`
goes through `FlashAttention`, a torch.autograd.Function whose forward
keeps (q, k, v, out, lse) and whose backward is the dq and dkv kernels (the
plain backward on CPU tensors).
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


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function in plain PyTorch, written out in f32
    (not autograd of the forward): (dq, dk, dv) in the dtypes of q, k, v.

    p = exp(s - lse) under the masks, delta = rowsum(out * dout),
    ds = p * (dp - delta) times 1 - (capped / cap)^2 with a softcap; the
    query heads of a GQA group sum into their KV head."""
    _check(q, k, v, causal, window, softcap)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    rep = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.float().reshape(b, hkv, rep, s, d)
    dog = dout.float().reshape(b, hkv, rep, s, d)
    kf, vf = k.float(), v.float()
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * sm_scale
    if softcap is not None:
        sc = torch.tanh(sc / softcap) * softcap
    p = torch.exp(sc - lse.float().reshape(b, hkv, rep, s, 1))
    mask = _mask(s, causal, window, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    delta = (out.float().reshape(b, hkv, rep, s, d) * dog).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dog, vf) - delta)
    if softcap is not None:
        ds = ds * (1.0 - (sc / softcap) ** 2)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * sm_scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * sm_scale
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _lib_bwd():
    lib = _build.load("flash_bwd")
    if lib.kubedl_flash_bwd_dq_bf16.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        tail = [ctypes.c_float, I, I, ctypes.c_float, P]
        lib.kubedl_flash_bwd_dq_bf16.argtypes = [P] * 7 + [I] * 6 + [L] * 15 + tail
        lib.kubedl_flash_bwd_dkv_bf16.argtypes = [P] * 8 + [I] * 6 + [L] * 18 + tail
        lib.kubedl_flash_bwd_dq_bf16.restype = I
        lib.kubedl_flash_bwd_dkv_bf16.restype = I
        lib.kubedl_flash_bwd_error_string.argtypes = [I]
        lib.kubedl_flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_launch_args(q, k, v, out, lse, dout, causal, sm_scale, window, softcap):
    """Check, pad and allocate for the backward kernels: the argument lists
    of the dq and dkv launches and the (dq, dk, dv) they write."""
    _check(q, k, v, causal, window, softcap)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        if x.device.type != "cuda":
            raise ValueError(f"flash_attention_bwd: {name} is on {x.device}, "
                             f"the kernels need CUDA tensors")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention_bwd: {name} is {x.dtype}; the "
                            f"kernels take bfloat16")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} / dout {tuple(dout.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if (lse.shape != (b, hq, s) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"lse must be [b, hq, s] float32 on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if len({x.device for x in (q, k, v, out, dout)}) != 1:
        raise ValueError("q, k, v, out, dout must be on one device")
    dk_ = next((w for w in HEAD_DIMS if w >= d), None)
    if dk_ is None:
        raise ValueError(f"flash_attention_bwd: head_dim {d} > {HEAD_DIMS[-1]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    delta = (out.float() * dout.float()).sum(-1)  # [b, hq, s] f32, contiguous
    if dk_ != d:
        q, k, v, dout = (F.pad(x, (0, dk_ - d)) for x in (q, k, v, dout))
    q, k, v, dout = _aligned(q), _aligned(k), _aligned(v), _aligned(dout)
    lse = lse.contiguous()
    grads = (torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2),
             torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device).transpose(1, 2),
             torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device).transpose(1, 2))
    head = [q, k, v, dout, lse, delta]  # tensors: kept alive with the lists
    dims = (b, hq, hkv, s, dk_, d)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3])
    tail = (float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)
    launches = {}
    for name, outs in (("dq", grads[:1]), ("dkv", grads[1:])):
        launches[name] = (head + list(outs), [*dims, *strides,
                          *(st for o in outs for st in o.stride()[:3]), *tail])
    return launches, grads


def _launch_bwd(name: str, args) -> None:
    """Launch the "dq" or "dkv" kernel with its `_bwd_launch_args` entry;
    raises on a CUDA error, counts the launch."""
    lib = _lib_bwd()
    tensors, rest = args
    fn = {"dq": lib.kubedl_flash_bwd_dq_bf16, "dkv": lib.kubedl_flash_bwd_dkv_bf16}[name]
    err = fn(*(t.data_ptr() for t in tensors), *rest)
    if err:
        b, hq, hkv, s, _, d = rest[:6]
        raise RuntimeError(
            f"flash_bwd_{name} kernel launch failed: CUDA error {err} "
            f"({lib.kubedl_flash_bwd_error_string(err).decode()}) at "
            f"b={b} hq={hq} hkv={hkv} s={s} d={d}")
    if name == "dq":
        flash_attention.bwd_dq_launches += 1
    else:
        flash_attention.bwd_dkv_launches += 1


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dq kernel, then the dkv kernel: (dq, dk, dv) in bf16.

    Takes what `flash_attention_fwd` takes plus its (out, lse) and the
    output gradient, with the same checks, head-dim padding and stride
    rules; delta = rowsum(out * dout) is computed here in f32. dq is a
    [b, hq, s, d] view of a [b, s, hq, d] buffer and dk, dv of
    [b, s, hkv, d] buffers, the layouts the model's projections produce."""
    launches, grads = _bwd_launch_args(q, k, v, out, lse, dout, causal, sm_scale,
                                       window, softcap)
    _launch_bwd("dq", launches["dq"])
    _launch_bwd("dkv", launches["dkv"])
    return grads


class FlashAttention(torch.autograd.Function):
    """Attention with a flash backward: CPU tensors take the plain forward
    and the plain backward, CUDA tensors the kernels (or raise)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window, softcap):
        fwd = flash_attention_plain if q.device.type == "cpu" else flash_attention_fwd
        out, lse = fwd(q, k, v, causal=causal, sm_scale=sm_scale, window=window,
                       softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Attention over [batch, q_heads, seq, head_dim] tensors (GQA k/v).

    CPU tensors run `flash_attention_plain`; CUDA tensors run the kernel,
    at every sequence length, or raise. When grad is enabled and an input
    requires it, the call goes through `FlashAttention`, whose backward is
    the flash backward. `flash_attention.launches` counts forward kernel
    launches, `bwd_dq_launches` and `bwd_dkv_launches` the backward's."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, sm_scale, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                     window=window, softcap=softcap)[0]
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               window=window, softcap=softcap)[0]


flash_attention.launches = 0
flash_attention.bwd_dq_launches = 0
flash_attention.bwd_dkv_launches = 0
