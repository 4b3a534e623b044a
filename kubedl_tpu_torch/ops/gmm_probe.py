"""Time variants of ops/csrc/gmm_sm90.cu (K6, K7) at the MoE training shape,
to see what holds the kernels back. Needs an NVIDIA GPU and nvcc:

    python -m kubedl_tpu_torch.ops.gmm_probe [--reps 3]

Each variant is the source with one change, built beside the port's own
libraries and launched through ops/gmm.py's wrappers:
  base    the kernels as they are;
  sumacc  the epilogue only sums each thread's accumulators and writes
          nothing: the products and the pipeline without the output;
  noepi   no epilogue: ptxas then drops the products whose results are
          dead, so this times the TMA load path and its barriers alone.
Prints the card's name and power limit, then one line per variant and
repetition: K6, K6 with the transposed weights, K7 with f32 and bf16
output, in ms and in TFLOP/s over the m_pad rows the kernels compute.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import torch

from kubedl_tpu_torch.ops import _build
from kubedl_tpu_torch.ops import gmm as G

_HEAD = "template <typename T>\n__device__ __forceinline__ void store_tile("
_NEXT = "// ---------------------------------------------------------------------------\n// K6:"
_SUM = """template <typename T>
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


def variants() -> dict:
    """{name: source} of the three variants."""
    src = (_build.CSRC / "gmm_sm90.cu").read_text()
    i0, i1 = src.index(_HEAD), src.index(_NEXT)
    store = src[i0:i1]
    if _FIRST not in store:
        raise RuntimeError("gmm_sm90.cu's store_tile changed: update the probe")
    return {"base": src,
            "sumacc": src[:i0] + _SUM + src[i1:],
            "noepi": src[:i0] + store.replace(_FIRST, "  return;\n" + _FIRST) + src[i1:]}


def build(sources: dict) -> dict:
    """Compile every variant in parallel; {name: ctypes library}."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
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
        lib = ctypes.CDLL(str(so))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.kubedl_gmm_sm90.argtypes = [P] * 4 + [I] * 5 + [L] * 4 + [I, P]
        lib.kubedl_gmm_sm90.restype = I
        lib.kubedl_tgmm_sm90.argtypes = [P] * 4 + [I] * 6 + [L] * 2 + [I, P]
        lib.kubedl_tgmm_sm90.restype = I
        lib.kubedl_gmm_sm90_error_string.argtypes = [I]
        lib.kubedl_gmm_sm90_error_string.restype = ctypes.c_char_p
        libs[name] = lib
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


def main(argv=None) -> int:
    from kubedl_tpu_torch.models import moe

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gmm_probe: needs a CUDA device")
    libs = build(variants())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    # the MoE training shape of chip_smoke.py: 4092 tokens top-2 of 8 experts
    e, d, ff, t = 8, 4096, 14336, 4092
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((t, e), generator=gen, device="cuda")
    eid = moe._top_k_gating(logits, 2, t + 1, need_slots=False)[0].reshape(-1)
    te, m_pad = moe._dispatch_plan(eid, e)[3:]

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    h, w2, x, dg = randn(m_pad, ff), randn(e, ff, d, scale=ff ** -0.5), randn(m_pad, d), \
        randn(m_pad, ff)
    cases = (("K6", lambda: G.gmm_cuda(h, w2, te)),
             ("K6T", lambda: G.gmm_cuda(x, w2.transpose(1, 2), te)),
             ("K7f32", lambda: G.tgmm_cuda(x, dg, te, e)),
             ("K7bf16", lambda: G.tgmm_cuda(x, dg, te, e, out_dtype=torch.bfloat16)))
    flop = 2 * m_pad * d * ff
    real = G._lib_sm90
    try:
        for rep in range(args.reps):
            for name, lib in libs.items():
                G._lib_sm90 = lambda lib=lib: lib
                ms = [_time_ms(fn) for _, fn in cases]
                print(f"rep {rep} {name}: " + " ".join(
                    f"{c} {m:.4f} ms ({flop / m / 1e9:.0f} TFLOP/s)"
                    for (c, _), m in zip(cases, ms)), flush=True)
    finally:
        G._lib_sm90 = real
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
