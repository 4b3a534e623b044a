"""Time variants of ops/csrc/gmm_sm90.cu (K5-K8) at the MoE training and
int8 decode shapes, to see what holds the kernels back. Needs an NVIDIA
GPU and nvcc:

    python -m kubedl_tpu_torch.ops.gmm_probe [--reps 3] [--widths]

Each variant is the source with one change, built beside the port's own
libraries and launched through ops/gmm.py's wrappers:
  base     the kernels as they are;
  sumacc   the epilogue only sums each thread's accumulators and writes
           nothing: the products and the pipeline without the output;
  noepi    no epilogue: ptxas then drops the products whose results are
           dead, so this times the TMA load path (and the int8 widening)
           and its barriers alone;
  nowiden  the int8 codes go to wgmma as they are loaded, unconverted:
           wrong values, for timing only; it prices the widening
           arithmetic of K5 and K8 on int8 weights.
Prints the card's name and power limit, then one line per variant, shape
and repetition: K6, K6 with the transposed weights, K7 with f32 and bf16
output (training shape only), K5 and K8 on bf16 and int8 weights, in ms
and in TFLOP/s over the m_pad rows the kernels compute.

--widths times instead K8 on int8 and bf16 weights at each output tile
width the kernel takes (128 and 256, the two in turns) at the decode,
training and prefill shapes, checks that both widths give the same bits,
and prints the width `sm90_tile_n` picks there.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import torch

from kubedl_tpu_torch.ops import _build
from kubedl_tpu_torch.ops import gmm as G

_HEAD = "template <typename T, int COLS = BN>\n__device__ __forceinline__ void store_tile("
_NEXT = "// ---------------------------------------------------------------------------\n// K6:"
_SUM = """template <typename T, int COLS = BN>
__device__ __forceinline__ void store_tile(const float (&acc)[128], uint8_t* buf, T* out,
                                           int64_t ld, int row0, int rows, int col0, int cols,
                                           int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 128; ++i) s += acc[i];
  if (row0 < 0 && s == 1.f) out[lane] = T(s);
}

"""
_FIRST = "  constexpr int PER = 128 / sizeof(T);"
_WIDEN = "  const uint32_t v = (t & 0x007F007Fu) | 0x43004300u;"
_RS_HEAD = "template <int EPI, int NT>\n__device__ __forceinline__ void store_rs("
_RS_NEXT = "template <int EPI, bool INT8, int NP>\n__global__"
_RS_FIRST = "  constexpr int OUTS = EPI == EPI_SWIGLU ? 1 : NT;"
_RS_SUM = """template <int EPI, int NT>
__device__ __forceinline__ void store_rs(const float (&acc)[128], const float* __restrict__ s1,
                                         const float* __restrict__ s3, int e, int N,
                                         const int (&col)[NT], bf16* __restrict__ out,
                                         int64_t ld, int row0, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64 * NT; ++i) s += acc[i];
  if (row0 < 0 && s == 1.f) out[lane] = __float2bfloat16_rn(s);
}

"""


def variants() -> dict:
    """{name: source} of the four variants."""
    src = (_build.CSRC / "gmm_sm90.cu").read_text()

    def swap(text, head, nxt, first, body):
        """text with the function from `head` up to `nxt` replaced by
        `body`, or (body None) returning before the line `first`."""
        i0, i1 = text.index(head), text.index(nxt)
        if first not in text[i0:i1]:
            raise RuntimeError(f"gmm_sm90.cu's {head.split('(')[0].split()[-1]} changed: "
                               "update the probe")
        fn = body if body is not None else text[i0:i1].replace(first, "  return;\n" + first)
        return text[:i0] + fn + text[i1:]

    if src.count(_WIDEN) != 1:
        raise RuntimeError("gmm_sm90.cu's widen2 changed: update the probe")
    return {"base": src,
            "sumacc": swap(swap(src, _HEAD, _NEXT, _FIRST, _SUM),
                           _RS_HEAD, _RS_NEXT, _RS_FIRST, _RS_SUM),
            "noepi": swap(swap(src, _HEAD, _NEXT, _FIRST, None),
                          _RS_HEAD, _RS_NEXT, _RS_FIRST, None),
            "nowiden": src.replace(_WIDEN, "  return t;\n" + _WIDEN)}


def build(sources: dict) -> dict:
    """Compile every variant in parallel; {name: ctypes library}."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.includes(_build.CSRC / "gmm_sm90.cu"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"gmm_sm90_{name}.cu"
        cu.write_text(src)
        so = out_dir / f"libgmm_sm90_{name}.so"
        procs[name] = (so, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise _build.BuildError(f"nvcc failed for the {name} variant:\n{log}")
        libs[name] = G.bind_sm90(ctypes.CDLL(str(so)))
    return libs


def _time_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _cases(shape: str, m_pad: int, te, gen):
    """[(name, launch, FLOP over the m_pad rows)] at one shape."""
    e, d, ff = 8, 4096, 14336

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    x, h = randn(m_pad, d), randn(m_pad, ff)
    w1, w3, w2 = randn(e, d, ff, scale=d ** -0.5), randn(e, d, ff, scale=d ** -0.5), \
        randn(e, ff, d, scale=ff ** -0.5)
    q1, q3, q2 = codes(e, d, ff), codes(e, d, ff), codes(e, ff, d)
    s13, s2 = torch.full((e, ff), 1e-3, device="cuda"), torch.full((e, d), 1e-3, device="cuda")
    flop = 2 * m_pad * d * ff
    out = []
    if shape == "train_R8184":
        dg = randn(m_pad, ff)
        out += [("K6", lambda: G.gmm_cuda(h, w2, te), flop),
                ("K6T", lambda: G.gmm_cuda(x, w2.transpose(1, 2), te), flop),
                ("K7f32", lambda: G.tgmm_cuda(x, dg, te, e), flop),
                ("K7bf16", lambda: G.tgmm_cuda(x, dg, te, e, out_dtype=torch.bfloat16), flop)]
    out += [("K5bf16", lambda: G.gmm_swiglu_cuda(x, w1, w3, te, s13, s13), 2 * flop),
            ("K5int8", lambda: G.gmm_swiglu_cuda(x, q1, q3, te, s13, s13), 2 * flop),
            ("K8bf16", lambda: G.gmm_cuda(h, w2, te, s2), flop),
            ("K8int8", lambda: G.gmm_cuda(h, q2, te, s2), flop)]
    return out


def _layout(t: int, gen):
    """(tile_expert, m_pad) of `t` tokens routed top-2 of 8 experts."""
    from kubedl_tpu_torch.models import moe

    logits = torch.randn((t, 8), generator=gen, device="cuda")
    eid = moe._top_k_gating(logits, 2, t + 1, need_slots=False)[0].reshape(-1)
    return moe._dispatch_plan(eid, 8)[3:]


def widths(reps: int, gen) -> None:
    """K8 at 128- and 256-wide output tiles, in turns."""
    e, d, ff = 8, 4096, 14336
    q2 = torch.randint(-127, 128, (e, ff, d), generator=gen, device="cuda", dtype=torch.int8)
    w2 = (torch.randn((e, ff, d), generator=gen, device="cuda") * ff ** -0.5).to(torch.bfloat16)
    s2 = torch.full((e, d), 1e-3, device="cuda")
    real = G.sm90_tile_n
    try:
        for shape, t in (("decode_R16", 8), ("train_R8184", 4092), ("prefill_R8192", 4096)):
            te, m_pad = _layout(t, gen)
            h = torch.randn((m_pad, ff), generator=gen, device="cuda").to(torch.bfloat16)
            outs = {}
            for rep in range(reps):
                for tn in ((128, 256) if rep % 2 == 0 else (256, 128)):
                    G.sm90_tile_n = lambda m, n, epi, sms=0, tn=tn: tn
                    ms = [_time_ms(lambda w=w: G.gmm_cuda(h, w, te, s2)) for w in (q2, w2)]
                    outs[tn] = [G.gmm_cuda(h, w, te, s2) for w in (q2, w2)]
                    print(f"rep {rep} {shape} (m_pad {m_pad}) tile_n {tn}: "
                          f"K8int8 {ms[0]:.4f} ms K8bf16 {ms[1]:.4f} ms", flush=True)
            G.sm90_tile_n = real
            same = all(torch.equal(a, b) for a, b in zip(outs[128], outs[256]))
            pick = real(m_pad, d, G.EPI_SCALE, G._sms(h.device))
            print(f"{shape}: same bits at both widths {same}; sm90_tile_n picks {pick}",
                  flush=True)
    finally:
        G.sm90_tile_n = real


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--widths", action="store_true",
                   help="time K8 at each output tile width instead of the variants")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gmm_probe: needs a CUDA device")
    libs = {} if args.widths else build(variants())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.widths:
        widths(args.reps, gen)
        return 0
    # chip_smoke.py's MoE training shape (4092 tokens top-2 of 8 experts)
    # and its int8 decode tick (8 tokens)
    real = G._lib_sm90
    try:
        for shape, t in (("train_R8184", 4092), ("decode_R16", 8)):
            te, m_pad = _layout(t, gen)
            cases = _cases(shape, m_pad, te, gen)
            for rep in range(args.reps):
                for name, lib in libs.items():
                    G._lib_sm90 = lambda lib=lib: lib
                    ms = [_time_ms(fn) for _, fn, _ in cases]
                    print(f"rep {rep} {name} {shape} (m_pad {m_pad}): " + " ".join(
                        f"{c} {m:.4f} ms ({flop / m / 1e9:.0f} TFLOP/s)"
                        for (c, _, flop), m in zip(cases, ms)), flush=True)
            del cases
            torch.cuda.empty_cache()
    finally:
        G._lib_sm90 = real
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
