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
kernels or the call raises on a dtype, head dim or shape they do not take.
There is no fallback between the two. The forward's source is fixed by the
head dim (`kernel_source`): padded to 64 or 128, ops/csrc/flash_fwd_sm90.cu
(TMA, wgmma, warp-specialized); 256, ops/csrc/flash_fwd.cu (mma.sync). The
backward's likewise (`bwd_kernel_source`): ops/csrc/flash_bwd_sm90.cu at
64 or 128, ops/csrc/flash_bwd.cu at 256. When an input requires grad,
`flash_attention` goes through `FlashAttention`, a torch.autograd.Function
whose forward keeps (q, k, v, out, lse) and whose backward is the dq and
dkv kernels (the plain backward on CPU tensors).
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import Dict, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from kubedl_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)  # the mma.sync kernels' template widths
SM90, MMA_SYNC = "flash_fwd_sm90", "flash_fwd"  # the forward's kernel sources under ops/csrc/
BWD_SM90, BWD_MMA_SYNC = "flash_bwd_sm90", "flash_bwd"  # the backward's
SM90_HEAD_DIMS = (64, 128)


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
    """A view the kernels can read (and a TMA tensor map can describe):
    unit last stride, other strides whole 16-byte vectors, 16-byte aligned
    base. The strided q/k/v that the model
    passes already are; anything else is copied once here."""
    ok = (x.stride(-1) == 1 and all(st > 0 and st % 8 == 0 for st in x.stride()[:-1])
          and x.data_ptr() % 16 == 0)
    return x if ok else x.contiguous()


def kernel_source(head_dim: int) -> str:
    """The csrc/ source whose kernel the CUDA forward takes at this head
    dim: padded to 64 or 128, flash_fwd_sm90.cu; 256, flash_fwd.cu. Raises
    past 256."""
    if head_dim <= SM90_HEAD_DIMS[-1]:
        return SM90
    if head_dim <= HEAD_DIMS[-1]:
        return MMA_SYNC
    raise ValueError(f"flash_attention_fwd: head_dim {head_dim} > {HEAD_DIMS[-1]}")


def bwd_kernel_source(head_dim: int) -> str:
    """The csrc/ source whose dq and dkv kernels the CUDA backward takes at
    this head dim: padded to 64 or 128, flash_bwd_sm90.cu; 256,
    flash_bwd.cu. Raises past 256."""
    if head_dim <= SM90_HEAD_DIMS[-1]:
        return BWD_SM90
    if head_dim <= HEAD_DIMS[-1]:
        return BWD_MMA_SYNC
    raise ValueError(f"flash_attention_bwd: head_dim {head_dim} > {HEAD_DIMS[-1]}")


SM90_BLOCK = 128              # query rows an item and key rows a tile of flash_fwd_sm90.cu
SM90_L2_GROUP_BYTES = 24 << 20  # streamed bytes a group of items may take: half the L2
# the persistent kernels' items: kind -> (rows an item, rows a streamed tile).
# "fwd" and "dq" items are query rows of one (b, q head) streaming K/V tiles;
# "dkv" items are key rows of one (b, KV head) streaming the Q/dO tiles of
# every query head of its GQA group
SM90_TILES = {"fwd": (SM90_BLOCK, SM90_BLOCK), "dq": (128, 64), "dkv": (128, 64)}


def _tiles(t: int, s: int, causal: bool, window: Optional[int], kind: str = "fwd") -> int:
    """Tiles the `kind` kernel streams for its item row block t, for one
    query head (its item_of / dq_item / dkv_item)."""
    bm, bn = SM90_TILES[kind]
    r0, n = t * bm, -(-s // bn)
    if kind == "dkv":  # query tiles from the diagonal on, to the window's last row
        if window:
            n = min(n, (min(r0 + bm, s) - 1 + window - 1) // bn + 1)
        return max(n - (r0 // bn if causal else 0), 0)
    if causal:
        n = min(n, (r0 + bm - 1) // bn + 1)
    lo = r0 - window + 1 if window else 0
    return n - (lo // bn if lo > 0 else 0)


def sm90_group(b: int, hq: int, hkv: int, s: int, d: int, kind: str = "fwd") -> int:
    """Heads in one L2 group of the `kind` kernel's schedule. "fwd", "dq":
    (b, q head) pairs, whole GQA groups, as many as have their K/V (S * d
    * 4 bytes a KV head) in SM90_L2_GROUP_BYTES; "dkv": (b, KV head) pairs
    whose query heads' Q and dO fit. At least one, then evened out so the
    last group is not a small remainder."""
    rep = hq // hkv
    if kind == "dkv":
        pairs, unit, nbytes = b * hkv, 1, rep * s * d * 4
    else:
        pairs, unit, nbytes = b * hq, rep, s * d * 4
    group = min(max(SM90_L2_GROUP_BYTES // nbytes, 1) * unit, pairs)
    even = -(-pairs // -(-pairs // group))  # the same number of groups, sizes within one
    return even + -even % unit


def sm90_items(b: int, hq: int, hkv: int, s: int, d: int, causal: bool,
               window: Optional[int], kind: str = "fwd"):
    """The `kind` kernel's items in order, as (code, cost): code is
    row_block * pairs + pair (pair = batch * hq + head, or batch * hkv + KV
    head for "dkv"), cost its streamed tiles (over the GQA group's query
    heads for "dkv") plus one for its prologue and epilogue. Pairs go in
    `sm90_group`s, so what the CTAs running at once stream stays in L2;
    inside a group, all its pairs of the longest causal row block first:
    the last query block, or the first key block."""
    n_t, rep = -(-s // SM90_TILES[kind][0]), hq // hkv
    pairs, per = (b * hkv, rep) if kind == "dkv" else (b * hq, 1)
    group = sm90_group(b, hq, hkv, s, d, kind)
    blocks = list(range(n_t))
    if causal and kind != "dkv":
        blocks.reverse()
    for first in range(0, pairs, group):
        for t in blocks:
            cost = _tiles(t, s, causal, window, kind) * per + 1
            for pair in range(first, min(first + group, pairs)):
                yield t * pairs + pair, cost


@functools.lru_cache(maxsize=256)
def sm90_schedule(b: int, hq: int, hkv: int, s: int, d: int, causal: bool,
                  window: Optional[int], n_ctas: int, kind: str = "fwd"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The persistent schedule of flash_fwd_sm90.cu ("fwd") or of
    flash_bwd_sm90.cu's two kernels ("dq", "dkv"): (order, starts), CTA c
    taking the items order[starts[c]:starts[c + 1]]. Each item of
    `sm90_items` in turn goes to the CTA that frees first, so the CTAs end
    together, and the ones running at once work on one group's tiles from
    L2."""
    free = [(0, c) for c in range(n_ctas)]
    lists = [[] for _ in range(n_ctas)]
    for code, cost in sm90_items(b, hq, hkv, s, d, causal, window, kind):
        t, c = heapq.heappop(free)
        lists[c].append(code)
        heapq.heappush(free, (t + cost, c))
    starts = np.zeros(n_ctas + 1, np.int32)
    starts[1:] = np.cumsum([len(x) for x in lists])
    return np.concatenate([np.asarray(x, np.int32) for x in lists]), starts


_schedules: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _sm90_schedule_on(device, *key, kind: str = "fwd"
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """sm90_schedule for one CTA an SM of `device`, as int32 device tensors
    kept per shape and kind (a launch copies nothing)."""
    n_ctas = torch.cuda.get_device_properties(device).multi_processor_count
    full = (str(device), *key, n_ctas, kind)
    got = _schedules.get(full)
    if got is None:
        if len(_schedules) >= 256:  # serving's buckets are few; bound it all the same
            _schedules.clear()
        order, starts = sm90_schedule(*key, n_ctas, kind)
        got = (torch.from_numpy(order).to(device), torch.from_numpy(starts).to(device))
        _schedules[full] = got
    return (*got, n_ctas)


def _lib(source: str):
    lib = _build.load(source)
    fn, message = {SM90: ("kubedl_flash_fwd_sm90_bf16", "kubedl_flash_fwd_sm90_error_string"),
                   MMA_SYNC: ("kubedl_flash_fwd_bf16", "kubedl_cuda_error_string")}[source]
    fn, message = getattr(lib, fn), getattr(lib, message)
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sched = [P, P, I] if source == SM90 else []  # order, starts, CTAs
        fn.argtypes = ([P] * 5 + [I] * 6 + [L] * 12
                       + [ctypes.c_float, I, I, ctypes.c_float] + sched + [P])
        fn.restype = I
        message.argtypes = [I]
        message.restype = ctypes.c_char_p
    return fn, message


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        source: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: (out [b, hq, s, d] bf16, lse [b, hq, s] f32).

    Takes bf16 CUDA tensors with head_dim <= 256; the kernel is the one
    `kernel_source(head_dim)` names, or `source` (SM90 or MMA_SYNC) where a
    caller compares the two; nothing on the model's path passes it. A head
    dim that is not one of the kernel's widths is zero-padded up to the next
    of them (zero K columns add nothing to q.k, zero V columns give zero
    output columns, which are not written). `out` is returned as a
    [b, hq, s, d] view of a [b, s, hq, d] buffer, so the model's transpose
    back to [b, s, hq*d] is free."""
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
    if source is None:
        source = kernel_source(d)
    widths = {SM90: SM90_HEAD_DIMS, MMA_SYNC: HEAD_DIMS}.get(source)
    if widths is None:
        raise ValueError(f"flash_attention_fwd: unknown kernel source {source!r}")
    dk = next((w for w in widths if w >= d), None)
    if dk is None:
        raise ValueError(f"flash_attention_fwd: head_dim {d} > {widths[-1]} ({source}.cu)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if dk != d:
        q, k, v = (F.pad(x, (0, dk - d)) for x in (q, k, v))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    fn, message = _lib(source)
    sched = ()
    if source == SM90:
        order, starts, n_ctas = _sm90_schedule_on(q.device, b, hq, hkv, s, dk, bool(causal),
                                                  window)
        sched = (order.data_ptr(), starts.data_ptr(), n_ctas)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, hq, hkv, s, dk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0),
        *sched, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_fwd kernel launch failed ({source}.cu): CUDA error {err} "
            f"({message(err).decode()}) at "
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


# source -> (dq entry point, dkv entry point, error string)
_BWD_ENTRIES = {
    BWD_SM90: ("kubedl_flash_bwd_dq_sm90_bf16", "kubedl_flash_bwd_dkv_sm90_bf16",
               "kubedl_flash_bwd_sm90_error_string"),
    BWD_MMA_SYNC: ("kubedl_flash_bwd_dq_bf16", "kubedl_flash_bwd_dkv_bf16",
                   "kubedl_flash_bwd_error_string"),
}


def _lib_bwd(source: str):
    """{"dq": fn, "dkv": fn, "message": fn} of the source's library."""
    lib = _build.load(source)
    fns = dict(zip(("dq", "dkv", "message"), (getattr(lib, n) for n in _BWD_ENTRIES[source])))
    if fns["dq"].argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sched = [P, P, I] if source == BWD_SM90 else []  # order, starts, CTAs
        tail = [ctypes.c_float, I, I, ctypes.c_float] + sched + [P]
        # pointers (bf16 tensors, then f32 rows), then (b, h, s) strides of
        # each bf16 tensor: sm90 reads o in dq, and hands lse and delta to
        # dkv in one buffer
        n_dq, n_dkv = (8, 7) if source == BWD_SM90 else (7, 8)
        fns["dq"].argtypes = [P] * n_dq + [I] * 6 + [L] * 3 * (n_dq - 2) + tail
        fns["dkv"].argtypes = [P] * n_dkv + [I] * 6 + [L] * 18 + tail
        fns["dq"].restype = fns["dkv"].restype = I
        fns["message"].argtypes = [I]
        fns["message"].restype = ctypes.c_char_p
    return fns


def _bwd_launch_args(q, k, v, out, lse, dout, causal, sm_scale, window, softcap,
                     source: Optional[str] = None):
    """Check, pad and allocate for the backward kernels: {"dq": args, "dkv":
    args} of the two launches and the (dq, dk, dv) they write. args =
    (source, tensors, the other arguments but the stream). On
    flash_bwd_sm90.cu the dq kernel computes delta = rowsum(out * dout) and
    writes it, with LSE * log2 e, to a [2, b, hq, S rounded up to 64] f32
    buffer that the dkv kernel reads; on flash_bwd.cu delta is computed
    here."""
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
    if source is None:
        source = bwd_kernel_source(d)
    widths = {BWD_SM90: SM90_HEAD_DIMS, BWD_MMA_SYNC: HEAD_DIMS}.get(source)
    if widths is None:
        raise ValueError(f"flash_attention_bwd: unknown kernel source {source!r}")
    dk_ = next((w for w in widths if w >= d), None)
    if dk_ is None:
        raise ValueError(f"flash_attention_bwd: head_dim {d} > {widths[-1]} ({source}.cu)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    sm90 = source == BWD_SM90
    lse = lse.contiguous()
    if sm90:  # the dq kernel's rows: LSE * log2 e, then delta
        rows = torch.empty((2, b, hq, -(-s // 64) * 64), dtype=torch.float32, device=q.device)
        f32 = {"dq": [lse, rows], "dkv": [rows]}
    else:
        delta = (out.float() * dout.float()).sum(-1)  # [b, hq, s] f32, contiguous
        f32 = {"dq": [lse, delta], "dkv": [lse, delta]}
    if dk_ != d:
        q, k, v, out, dout = (F.pad(x, (0, dk_ - d)) for x in (q, k, v, out, dout))
    q, k, v, out, dout = (_aligned(x) for x in (q, k, v, out, dout))
    grads = (torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2),
             torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device).transpose(1, 2),
             torch.empty((b, s, hkv, d), dtype=q.dtype, device=q.device).transpose(1, 2))
    dims = (b, hq, hkv, s, dk_, d)
    tail = (float(sm_scale), int(causal), int(window or 0), float(softcap or 0.0))
    launches = {}
    for name, ins, outs in (("dq", [q, k, v, out, dout] if sm90 else [q, k, v, dout], grads[:1]),
                            ("dkv", [q, k, v, dout], grads[1:])):
        ptrs = ins + f32[name] + list(outs)  # tensors: kept alive with the lists
        strides = [st for x in ins + list(outs) for st in x.stride()[:3]]
        sched = ()
        if sm90:
            order, starts, n_ctas = _sm90_schedule_on(q.device, b, hq, hkv, s, dk_, bool(causal),
                                                      window, kind=name)
            sched = (order.data_ptr(), starts.data_ptr(), n_ctas)
        launches[name] = (source, ptrs, [*dims, *strides, *tail, *sched])
    return launches, grads


def _launch_bwd(name: str, args) -> None:
    """Launch the "dq" or "dkv" kernel with its `_bwd_launch_args` entry on
    the current stream (a CUDA graph's while one is captured); raises on a
    CUDA error, counts the launch."""
    source, tensors, rest = args
    fns = _lib_bwd(source)
    err = fns[name](*(t.data_ptr() for t in tensors), *rest,
                    torch.cuda.current_stream(tensors[0].device).cuda_stream)
    if err:
        b, hq, hkv, s, _, d = rest[:6]
        raise RuntimeError(
            f"flash_bwd_{name} kernel launch failed ({source}.cu): CUDA error {err} "
            f"({fns['message'](err).decode()}) at "
            f"b={b} hq={hq} hkv={hkv} s={s} d={d}")
    if name == "dq":
        flash_attention.bwd_dq_launches += 1
    else:
        flash_attention.bwd_dkv_launches += 1


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        source: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the dq kernel, then the dkv kernel: (dq, dk, dv) in bf16.

    Takes what `flash_attention_fwd` takes plus its (out, lse) and the
    output gradient, with the same checks, head-dim padding and stride
    rules. The kernels are the ones `bwd_kernel_source(head_dim)` names,
    or `source` (BWD_SM90 or BWD_MMA_SYNC) where a caller compares the two;
    nothing on the model's path passes it. dq is a [b, hq, s, d] view of a
    [b, s, hq, d] buffer and dk, dv of [b, s, hkv, d] buffers, the layouts
    the model's projections produce."""
    launches, grads = _bwd_launch_args(q, k, v, out, lse, dout, causal, sm_scale,
                                       window, softcap, source)
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
