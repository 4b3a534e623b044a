"""Grouped matrix products for the dropless MoE FFN: hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of kubedl_tpu/ops/gmm.py. `gmm(lhs, rhs, tile_expert)` computes,
for every row tile i of `lhs` [M, K], ``lhs[tile i] @ rhs[tile_expert[i]]``
with rhs [E, K, N]; the row tile is M / len(tile_expert). Three products
share that shape: `gmm` (K6), `gmm_scaled` (K8: times a per-expert [E, N]
output scale, the int8 dequantisation) and `gmm_swiglu` (K5:
``silu(lhs @ w1[e] * s1[e]) * (lhs @ w3[e] * s3[e])`` in one pass). Their
backward runs `tgmm` (K7): ``drhs[e] = sum over e's row tiles of
lhs_tile^T @ dout_tile`` summed in f32 and written in f32 or, where the
caller casts to bf16 weights anyway, in bf16; zero for an expert that owns
no tile.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor takes a
kernel or the call raises. There is no fallback between the two.
`kernel_source` names the kernel source of each product: K5, K8 (bf16 or
int8 weights), K6 on bf16 weights (either layout) and K7 run the TMA/wgmma
kernels of ops/csrc/gmm_sm90.cu; only K6 on int8 weights, which no path
runs (training never sees a quantized tree), stays on the mma.sync
template of ops/csrc/gmm.cu. Both widen int8 weights to bf16 inside the
kernel, so no bf16 copy of an int8 stack is made. The public functions go
through torch.autograd.Functions whose backward is the JAX module's
(`_gmm_bwd`, `_gmm_scaled_bwd`, `_gmm_swiglu_bwd`): dlhs by the gmm kernel
against rhs transposed (a strided view, never a copy), drhs by `tgmm`, the
SwiGLU's two pre-activation products recomputed, and the scale gradients
by a per-expert segment sum. The TPU module's tile constants (`_pick_tiles`,
the grid) are not carried over; the row-tile checks are, with the same
errors.

Each kernel wrapper counts its launches: `gmm.launches` (K6),
`gmm_scaled.launches` (K8), `gmm_swiglu.launches` (K5) and
`tgmm.launches` (K7).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from kubedl_tpu_torch.ops import _build

TILE_M = 128
EPI_NONE, EPI_SCALE, EPI_SWIGLU = 0, 1, 2


def _row_tile_of(m: int, tile_expert, name: str) -> int:
    """The row-tile size is m / len(tile_expert) and must be a whole
    multiple of TILE_M (a ragged tail would never be computed)."""
    n_tiles = int(tile_expert.shape[0])
    if n_tiles <= 0 or m % n_tiles:
        raise ValueError(
            f"{name} tile_expert has {n_tiles} entries which do not evenly "
            f"tile {m} lhs rows; a ragged tail would silently never be "
            "computed")
    tm = m // n_tiles
    if tm % TILE_M:
        raise ValueError(
            f"{name} row-tile {tm} ({m} rows / {n_tiles} tile entries) "
            f"must be a multiple of TILE_M ({TILE_M}); the grid covers "
            "whole tiles and a ragged tail would silently never be "
            "computed")
    return tm


def _check_row_tile(m: int, tile_expert, row_tile: int, name: str) -> None:
    """The caller states the row tile it laid the rows out with, and
    len(tile_expert) must agree: a truncated tile_expert whose length
    happens to divide m would otherwise be read as a wider tile and apply
    one expert's weights to another's rows."""
    if row_tile % TILE_M:
        raise ValueError(
            f"{name} row_tile {row_tile} must be a multiple of TILE_M "
            f"({TILE_M}) — MXU sublane alignment")
    if m % row_tile:
        raise ValueError(
            f"{name} lhs rows ({m}) must be a multiple of TILE_M-aligned "
            f"row_tile {row_tile}; the grid covers m // row_tile tiles and "
            "a ragged tail would silently never be computed")
    if tile_expert.shape[0] != m // row_tile:
        raise ValueError(
            f"{name} tile_expert has {tile_expert.shape[0]} entries for "
            f"{m // row_tile} row-tiles of {row_tile} rows; an out-of-range "
            "te[i] gather clamps and would silently reuse the last "
            "expert's weights")


# -- plain versions ------------------------------------------------------------


def _expert_tiles(tile_expert, n_experts: int):
    """[(expert, its tile indices)] for every expert that owns a tile. An
    index outside [0, E) is clamped, as the kernels clamp it. Reads the map
    back to the host: the plain versions are for CPU tensors and checks."""
    te = tile_expert.long().clamp(0, n_experts - 1)
    out = []
    for e in range(n_experts):
        tiles = (te == e).nonzero()[:, 0]
        if tiles.numel():
            out.append((e, tiles))
    return out


def _plain(lhs, weights, tile_expert, epilogue):
    """One f32 matmul per expert over the rows of its tiles, for each
    weight stack; `epilogue(e, products)` gives the [rows, N] f32 result,
    cast to lhs's dtype at the end."""
    m, k = lhs.shape
    n = weights[0].shape[2]
    nt = tile_expert.shape[0]
    tm = m // nt
    x = lhs.float().reshape(nt, tm, k)
    out = torch.zeros((nt, tm, n), dtype=torch.float32, device=lhs.device)
    for e, tiles in _expert_tiles(tile_expert, weights[0].shape[0]):
        rows = x[tiles].reshape(-1, k)
        y = epilogue(e, [rows @ w[e].float() for w in weights])
        out[tiles] = y.reshape(-1, tm, n)
    return out.reshape(m, n).to(lhs.dtype)


def gmm_plain(lhs, rhs, tile_expert):
    """K6's function in plain PyTorch: lhs [M, K] x rhs [E, K, N] -> [M, N]
    in lhs's dtype, f32 products (an int8 rhs is read as its integers)."""
    return _plain(lhs, [rhs], tile_expert, lambda e, p: p[0])


def gmm_scaled_plain(lhs, rhs, tile_expert, out_scale):
    """K8's function: gmm_plain with the f32 product times out_scale[e]."""
    return _plain(lhs, [rhs], tile_expert, lambda e, p: p[0] * out_scale[e].float())


def gmm_swiglu_plain(lhs, w1, w3, tile_expert, scale1, scale3):
    """K5's function: silu(lhs @ w1[e] * s1[e]) * (lhs @ w3[e] * s3[e]) in
    f32, one cast to lhs's dtype."""
    if w3.shape != w1.shape:
        raise ValueError(f"w1 {tuple(w1.shape)} vs w3 {tuple(w3.shape)} shape mismatch")
    return _plain(lhs, [w1, w3], tile_expert,
                  lambda e, p: F.silu(p[0] * scale1[e].float()) * (p[1] * scale3[e].float()))


def tgmm_plain(lhs, dout, tile_expert, n_experts: int, out_dtype=torch.float32):
    """K7's function: [E, K, N] with drhs[e] = lhs_e^T @ dout_e over the
    rows of e's tiles, summed in f32 and cast to `out_dtype` at the end; an
    expert that owns no tile is exactly zero."""
    m, k = lhs.shape
    n = dout.shape[1]
    nt = tile_expert.shape[0]
    tm = m // nt
    x = lhs.float().reshape(nt, tm, k)
    d = dout.float().reshape(nt, tm, n)
    out = torch.zeros((n_experts, k, n), dtype=torch.float32, device=lhs.device)
    for e, tiles in _expert_tiles(tile_expert, n_experts):
        out[e] = x[tiles].reshape(-1, k).T @ d[tiles].reshape(-1, n)
    return out.to(out_dtype)


# -- the CUDA kernels ----------------------------------------------------------


SM90, MMA_SYNC = "gmm_sm90", "gmm"  # the two kernel sources under ops/csrc/


def kernel_source(rhs_dtype, transposed: bool, epi: int) -> str:
    """The csrc/ source whose kernel a CUDA grouped product takes, from the
    weights' dtype, their layout (the transpose(1, 2) view or not) and the
    epilogue: everything goes to gmm_sm90.cu (TMA, wgmma) but K6 on int8
    weights, which goes to gmm.cu (mma.sync). The scaled and SwiGLU
    products read K-major weights only. Raises on what neither kernel
    takes."""
    if rhs_dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"grouped product weights are {rhs_dtype}; the kernels take "
                        "torch.bfloat16 or torch.int8")
    if epi not in (EPI_NONE, EPI_SCALE, EPI_SWIGLU):
        raise ValueError(f"unknown grouped product epilogue {epi}")
    if transposed and epi != EPI_NONE:
        raise ValueError("the scaled and SwiGLU products take K-major weights only")
    return MMA_SYNC if rhs_dtype == torch.int8 and epi == EPI_NONE else SM90


SM90_SMS = 132  # an H100 SXM's SMs, for callers that name no device


def sm90_tile_n(m: int, n: int, epi: int, sms: int = SM90_SMS) -> int:
    """The output tile width of gmm_sm90.cu's epilogue kernel for an
    [m, n] product on a card of `sms` SMs: SwiGLU 128 (w1's and w3's
    128-wide panels side by side); scaled 256, unless 128 x 256 tiles would
    be fewer than two waves of the SMs (decode: m_pad 1152 x 4096 makes
    144 tiles on 132 SMs, the second wave nearly empty), then 128."""
    if epi == EPI_SWIGLU:
        return 128
    if epi != EPI_SCALE:
        raise ValueError(f"sm90_tile_n: epilogue {epi} is not scaled or SwiGLU")
    return 256 if (m // TILE_M) * -(-n // 256) >= 2 * sms else 128


_SMS = {}


def _sms(device) -> int:
    """SMs of a CUDA device, read once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _lib():
    lib = _build.load(MMA_SYNC)
    if lib.kubedl_gmm.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.kubedl_gmm.argtypes = [P] * 4 + [I] * 5 + [L] * 4 + [I, P]
        lib.kubedl_gmm.restype = I
        lib.kubedl_gmm_error_string.argtypes = [I]
        lib.kubedl_gmm_error_string.restype = ctypes.c_char_p
    return lib


def _lib_sm90():
    lib = _build.load(SM90)
    if lib.kubedl_gmm_sm90.argtypes is None:
        bind_sm90(lib)
    return lib


def bind_sm90(lib):
    """Set the ctypes signatures of a gmm_sm90.cu library's entry points."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.kubedl_gmm_sm90.argtypes = [P] * 4 + [I] * 5 + [L] * 4 + [I, P]
    lib.kubedl_gmm_sm90.restype = I
    lib.kubedl_tgmm_sm90.argtypes = [P] * 4 + [I] * 6 + [L] * 2 + [I, P]
    lib.kubedl_tgmm_sm90.restype = I
    lib.kubedl_gmm_sm90_epi.argtypes = [P] * 7 + [I] * 5 + [L] * 4 + [I] * 3 + [P]
    lib.kubedl_gmm_sm90_epi.restype = I
    lib.kubedl_gmm_sm90_error_string.argtypes = [I]
    lib.kubedl_gmm_sm90_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_check(name: str, fn: str, x, dtypes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: {name} is on {x.device}, the kernel needs CUDA tensors")
    if x.dtype not in dtypes:
        raise TypeError(f"{fn}: {name} is {x.dtype}; the kernel takes "
                        f"{', '.join(str(d) for d in dtypes)}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A [rows, cols] view the kernels read with 16-byte copies: unit
    column stride, a row stride of whole 16-byte vectors, aligned base."""
    vec = 16 // x.element_size()
    ok = x.stride(1) == 1 and x.stride(0) % vec == 0 and x.data_ptr() % 16 == 0
    return x if ok else x.contiguous()


def _stack(w: torch.Tensor):
    """(stack, transposed, ldb, expert stride) for an [E, K, N] weight stack
    read in place: K-major rows (N contiguous) or, for the backward's
    rhs.transpose(1, 2) view, N-major rows (K contiguous)."""
    vec = 16 // w.element_size()
    for trans, (inner, ld) in ((False, (2, 1)), (True, (1, 2))):
        if (w.stride(inner) == 1 and w.stride(ld) % vec == 0
                and w.stride(0) % vec == 0 and w.data_ptr() % 16 == 0):
            return w, trans, w.stride(ld), w.stride(0)
    w = w.contiguous()
    return w, False, w.stride(1), w.stride(0)


def _launch(fn_name, lhs, ws, scales, tile_expert, epi):
    _cuda_check("lhs", fn_name, lhs, (torch.bfloat16,))
    for i, w in enumerate(ws):
        _cuda_check(f"rhs{i or ''}", fn_name, w, (torch.bfloat16, torch.int8))
    if lhs.dim() != 2 or any(w.dim() != 3 for w in ws):
        raise ValueError(f"{fn_name}: lhs must be [M, K] and rhs [E, K, N]")
    m, k = lhs.shape
    e, k2, n = ws[0].shape
    if k2 != k or any(w.shape != ws[0].shape or w.dtype != ws[0].dtype for w in ws):
        raise ValueError(f"{fn_name}: lhs {tuple(lhs.shape)} and rhs "
                         f"{[tuple(w.shape) for w in ws]} do not chain")
    if k % 16 or n % 16:
        raise ValueError(f"{fn_name}: K={k} and N={n} must be multiples of 16")
    tm = _row_tile_of(m, tile_expert, fn_name)
    if len({x.device for x in (lhs, tile_expert, *ws, *scales)}) != 1:
        raise ValueError(f"{fn_name}: operands must be on one device")
    lhs = _rows(lhs)
    te = tile_expert.to(torch.int32).contiguous()
    stacks = [_stack(w) for w in ws]
    if len({(s[1], s[2], s[3]) for s in stacks}) != 1:
        stacks = [_stack(w.contiguous()) for w in ws]
    scales = [s.float().contiguous() for s in scales]
    for s in scales:
        if s.shape != (e, n):
            raise ValueError(f"{fn_name}: scale {tuple(s.shape)} is not [E, N] = {(e, n)}")
    _, trans, ldb, sbe = stacks[0]
    int8 = ws[0].dtype == torch.int8
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    args = (m, n, k, tm, e, lhs.stride(0), ldb, sbe, out.stride(0))
    tile_n = None
    if kernel_source(ws[0].dtype, trans, epi) == MMA_SYNC:
        lib = _lib()
        err = lib.kubedl_gmm(lhs.data_ptr(), stacks[0][0].data_ptr(), out.data_ptr(),
                             te.data_ptr(), *args, int(trans), stream)
        message = lib.kubedl_gmm_error_string
    elif epi == EPI_NONE:
        lib = _lib_sm90()
        err = lib.kubedl_gmm_sm90(lhs.data_ptr(), stacks[0][0].data_ptr(), out.data_ptr(),
                                  te.data_ptr(), *args, int(trans), stream)
        message = lib.kubedl_gmm_sm90_error_string
    else:
        lib = _lib_sm90()
        tile_n = sm90_tile_n(m, n, epi, _sms(lhs.device))
        ptrs = [s[0].data_ptr() for s in stacks] + [0] * (2 - len(stacks))
        sptrs = [s.data_ptr() for s in scales] + [0] * (2 - len(scales))
        err = lib.kubedl_gmm_sm90_epi(lhs.data_ptr(), ptrs[0], ptrs[1], sptrs[0], sptrs[1],
                                      out.data_ptr(), te.data_ptr(), *args, epi, int(int8),
                                      tile_n, stream)
        message = lib.kubedl_gmm_sm90_error_string
    if err:
        raise RuntimeError(
            f"{fn_name} kernel launch failed: CUDA error {err} "
            f"({message(err).decode()}) at M={m} K={k} N={n} "
            f"E={e} row_tile={tm} int8={int8} trans={trans} tile_n={tile_n}")
    return out


def gmm_cuda(lhs, rhs, tile_expert, out_scale=None):
    """Launch K6 (or K8 with `out_scale` [E, N]): [M, N] bf16. Takes bf16
    lhs and a bf16 or int8 rhs, K-major or as the transpose(1, 2) view of
    an [E, N, K] stack; raises on anything else."""
    if out_scale is None:
        out = _launch("gmm", lhs, [rhs], [], tile_expert, EPI_NONE)
        gmm.launches += 1
    else:
        out = _launch("gmm_scaled", lhs, [rhs], [out_scale], tile_expert, EPI_SCALE)
        gmm_scaled.launches += 1
    return out


def gmm_swiglu_cuda(lhs, w1, w3, tile_expert, scale1, scale3):
    """Launch K5: silu(lhs @ w1[e] * s1[e]) * (lhs @ w3[e] * s3[e]), bf16."""
    out = _launch("gmm_swiglu", lhs, [w1, w3], [scale1, scale3], tile_expert, EPI_SWIGLU)
    gmm_swiglu.launches += 1
    return out


def tgmm_cuda(lhs, dout, tile_expert, n_experts: int, out_dtype=torch.float32):
    """Launch K7: [E, K, N] weight gradient from bf16 lhs [M, K] and dout
    [M, N], summed in f32 and written as `out_dtype` (f32 or bf16); each
    output tile sums its expert's row tiles in order, so the result has no
    atomics and is the same bits on every run."""
    for name, x in (("lhs", lhs), ("dout", dout)):
        _cuda_check(name, "tgmm", x, (torch.bfloat16,))
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tgmm: out_dtype {out_dtype}; the kernel writes torch.float32 "
                        "or torch.bfloat16")
    m, k = lhs.shape
    if dout.dim() != 2 or dout.shape[0] != m:
        raise ValueError(f"tgmm: dout {tuple(dout.shape)} does not match lhs {tuple(lhs.shape)}")
    n = dout.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"tgmm: K={k} and N={n} must be multiples of 8")
    if not 0 < n_experts <= 1024:
        raise ValueError(f"tgmm: {n_experts} experts; the kernel takes 1 to 1024")
    tm = _row_tile_of(m, tile_expert, "tgmm")
    lhs, dout = _rows(lhs), _rows(dout)
    te = tile_expert.to(torch.int32).contiguous()
    out = torch.empty((n_experts, k, n), dtype=out_dtype, device=lhs.device)
    lib = _lib_sm90()
    err = lib.kubedl_tgmm_sm90(
        lhs.data_ptr(), dout.data_ptr(), out.data_ptr(), te.data_ptr(),
        m, k, n, tm, te.shape[0], n_experts, lhs.stride(0), dout.stride(0),
        int(out_dtype == torch.bfloat16), torch.cuda.current_stream(lhs.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"tgmm kernel launch failed: CUDA error {err} "
            f"({lib.kubedl_gmm_sm90_error_string(err).decode()}) at M={m} K={k} N={n} "
            f"E={n_experts} row_tile={tm} out_dtype={out_dtype}")
    tgmm.launches += 1
    return out


# -- dispatch and the backward helpers -----------------------------------------


def _gmm_raw(lhs, rhs, tile_expert, out_scale=None):
    if lhs.device.type == "cpu":
        if out_scale is None:
            return gmm_plain(lhs, rhs, tile_expert)
        return gmm_scaled_plain(lhs, rhs, tile_expert, out_scale)
    return gmm_cuda(lhs, rhs, tile_expert, out_scale)


def _gmm_swiglu_raw(lhs, w1, w3, tile_expert, scale1, scale3):
    if lhs.device.type == "cpu":
        return gmm_swiglu_plain(lhs, w1, w3, tile_expert, scale1, scale3)
    return gmm_swiglu_cuda(lhs, w1, w3, tile_expert, scale1, scale3)


def tgmm(lhs, dout, tile_expert, n_experts: int, out_dtype=torch.float32):
    """drhs [E, K, N]: the weight gradient of a grouped product (K7), summed
    in f32 and written as `out_dtype`; the plain version for CPU tensors,
    the kernel for CUDA ones."""
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, dout, tile_expert, n_experts, out_dtype)
    return tgmm_cuda(lhs, dout, tile_expert, n_experts, out_dtype)


def _bcast_tile_scale(x, scale, tile_expert):
    """x [m, n] * scale[tile_expert] broadcast over each tile's rows, the
    scale first cast to x's dtype (as the JAX helper does)."""
    m, n = x.shape
    nt = tile_expert.shape[0]
    s = scale[tile_expert.long()][:, None, :].to(x.dtype)
    return (x.reshape(nt, m // nt, n) * s).reshape(m, n)


def _tile_segsum(x, tile_expert, n_experts: int):
    """[E, N] per-expert sum of x's rows: each tile's rows collapse, then
    the tiles add into their expert's row."""
    m, n = x.shape
    nt = tile_expert.shape[0]
    per_tile = x.reshape(nt, m // nt, n).sum(dim=1)
    return torch.zeros((n_experts, n), dtype=x.dtype, device=x.device).index_add_(
        0, tile_expert.long(), per_tile)


def _t(w):
    """rhs^T per expert as a strided view: the kernel reads it in place."""
    return w.transpose(1, 2)


class _Gmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, tile_expert):
        ctx.save_for_backward(lhs, rhs, tile_expert)
        return _gmm_raw(lhs, rhs, tile_expert)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, te = ctx.saved_tensors
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = _gmm_raw(dout, _t(rhs), te).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, dout, te, rhs.shape[0], out_dtype=rhs.dtype)
        return dlhs, drhs, None


class _GmmScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, tile_expert, out_scale):
        out = _gmm_raw(lhs, rhs, tile_expert, out_scale)
        ctx.save_for_backward(lhs, rhs, tile_expert, out_scale, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, te, scale, out = ctx.saved_tensors
        e = rhs.shape[0]
        # y = raw * s, so dL/draw = dout * s (broadcast over each tile)
        dpre = _bcast_tile_scale(dout, scale, te)
        dlhs = drhs = dscale = None
        if ctx.needs_input_grad[0]:
            dlhs = _gmm_raw(dpre, _t(rhs), te).to(lhs.dtype)
        if ctx.needs_input_grad[1]:
            drhs = tgmm(lhs, dpre, te, e, out_dtype=rhs.dtype)
        if ctx.needs_input_grad[3]:
            # raw = out / s and s is constant over (e, n), so the division
            # moves outside the segment sum (s > 0 by construction, quant.py)
            dscale = (_tile_segsum(out.float() * dout.float(), te, e)
                      / scale.float()).to(scale.dtype)
        return dlhs, drhs, None, dscale


class _GmmSwiglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, w1, w3, tile_expert, scale1, scale3):
        ctx.save_for_backward(lhs, w1, w3, tile_expert, scale1, scale3)
        return _gmm_swiglu_raw(lhs, w1, w3, tile_expert, scale1, scale3)

    @staticmethod
    def backward(ctx, dout):
        lhs, w1, w3, te, s1, s3 = ctx.saved_tensors
        e = w1.shape[0]
        need = ctx.needs_input_grad
        # recompute the two pre-activation products rather than keep them
        g_raw = _gmm_raw(lhs, w1, te)
        u_raw = _gmm_raw(lhs, w3, te)
        g = _bcast_tile_scale(g_raw, s1, te).float()
        u = _bcast_tile_scale(u_raw, s3, te).float()
        df = dout.float()
        sig = torch.sigmoid(g)
        # d silu(g)/dg = sig * (1 + g * (1 - sig))
        dgate = df * u * (sig * (1.0 + g * (1.0 - sig)))
        dup = df * (g * sig)
        del g, u, sig, df
        dgate_pre = _bcast_tile_scale(dgate.to(lhs.dtype), s1, te)
        dup_pre = _bcast_tile_scale(dup.to(lhs.dtype), s3, te)
        dlhs = dw1 = dw3 = ds1 = ds3 = None
        if need[0]:
            dlhs = (_gmm_raw(dgate_pre, _t(w1), te)
                    + _gmm_raw(dup_pre, _t(w3), te)).to(lhs.dtype)
        if need[1]:
            dw1 = tgmm(lhs, dgate_pre, te, e, out_dtype=w1.dtype)
        if need[2]:
            dw3 = tgmm(lhs, dup_pre, te, e, out_dtype=w3.dtype)
        if need[4]:
            ds1 = _tile_segsum(g_raw.float() * dgate, te, e).to(s1.dtype)
        if need[5]:
            ds3 = _tile_segsum(u_raw.float() * dup, te, e).to(s3.dtype)
        return dlhs, dw1, dw3, None, ds1, ds3


# -- public ops ----------------------------------------------------------------


def gmm(lhs, rhs, tile_expert, *, row_tile: int = TILE_M):
    """[M, K] x [E, K, N] -> [M, N], the weight chosen per row tile:
    out[tile i] = lhs[tile i] @ rhs[tile_expert[i]]. Rows are sorted by
    expert and padded per group to `row_tile` by the caller (models/moe.py);
    padding rows are zeros and are never gathered back."""
    _check_row_tile(lhs.shape[0], tile_expert, row_tile, "gmm")
    return _Gmm.apply(lhs, rhs, tile_expert)


def gmm_scaled(lhs, rhs, tile_expert, out_scale, *, row_tile: int = TILE_M):
    """gmm with a per-expert output scale ([E, N], per output channel) in
    the epilogue: out[i] = (lhs[i] @ rhs[te[i]]) * out_scale[te[i]]. The
    int8 dequantisation path."""
    _check_row_tile(lhs.shape[0], tile_expert, row_tile, "gmm_scaled")
    return _GmmScaled.apply(lhs, rhs, tile_expert, out_scale)


def gmm_swiglu(lhs, w1, w3, tile_expert, scale1, scale3, *,
               row_tile: int = TILE_M):
    """The fused front half of the expert SwiGLU,
    out[i] = silu(lhs[i] @ w1[e] * s1[e]) * (lhs[i] @ w3[e] * s3[e]) with
    e = tile_expert[i]: both products into f32 accumulators and one write.
    scale1/scale3 are [E, N]; pass ones for unquantized weights."""
    _check_row_tile(lhs.shape[0], tile_expert, row_tile, "gmm_swiglu")
    return _GmmSwiglu.apply(lhs, w1, w3, tile_expert, scale1, scale3)


gmm.launches = 0
gmm_scaled.launches = 0
gmm_swiglu.launches = 0
tgmm.launches = 0
