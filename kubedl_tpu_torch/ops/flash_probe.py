"""Time variants of ops/csrc/flash_fwd_sm90.cu (K1/K4) at chip_smoke.py's
phase-2 shapes, or with --bwd of ops/csrc/flash_bwd_sm90.cu (K2/K3) at
phase 2b's, to see what holds the kernels back. Needs an NVIDIA GPU and
nvcc:

    python -m kubedl_tpu_torch.ops.flash_probe [--reps 3] [--bwd]

Each forward variant is launched through ops/flash_attention.py's wrapper:
  base        the kernel and its host schedule as they are;
  roundrobin  the same kernel on a static schedule: the items in the same
              order (`sm90_items`), CTA c taking items c, c + n, c + 2n, ...
              with no balancing;
  nosoftmax   the source with each tile's softmax replaced by rounding the
              raw scores to bf16: the products, the loads and the epilogue
              alone (its output is wrong; only its time is read);
  mma_sync    flash_fwd.cu, the mma.sync kernel, at the same shapes.
The backward's variants, each the dq and the dkv launch timed apart, at
d 128 and at phase 2b's d 256 shapes (Gemma-2's, q x8 under the softcap):
  base        the two kernels as they are;
  noelem      the source with the elementwise work between the products
              (p, ds, the masks) taken out: each tile's raw S and dP feed
              the next products (its output is wrong; only its time is read);
  latek       the d 256 dq kernel releasing a tile's K only after the next
              tile's ds, not as soon as its dQ product retires (the same
              output; with 2 stages the load of the tile after next then
              has no slack);
  mma_sync    flash_bwd.cu, the mma.sync kernels, at the same shapes.
Device time of 10 launches captured in a CUDA graph, median of 7 replays.
Prints the card's name and power limit, then one line per variant and
repetition, in ms and TFLOP/s over the (query, key) pairs the masks keep
(4 products a pair forward, 5 backward).
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import numpy as np
import torch

from kubedl_tpu_torch.ops import _build
from kubedl_tpu_torch.ops import flash_attention as fa

_SOFTMAX = """  if (masked)
    tile_exp<SOFTCAP, true>(s, m, l, corr, p, qrow, k0, tq);
  else
    tile_exp<SOFTCAP, false>(s, m, l, corr, p, qrow, k0, tq);"""
_NO_SOFTMAX = "  corr[0] = corr[1] = 1.f; l[0] = l[1] = 1.f; m[0] = m[1] = 0.f;"
# flash_bwd_sm90.cu's elementwise work between the products, and what
# takes its place in the noelem variant: the raw scores packed as they are
_BWD_ELEM = {
    """  if (masked)
    dq_grads<SOFTCAP, true>(s, dp, lse2, dl, p, qrow, k0, tq);
  else
    dq_grads<SOFTCAP, false>(s, dp, lse2, dl, p, qrow, k0, tq);""": "  (void)masked;",
    """  if (masked)
    dkv_probs<SOFTCAP, true>(s, pf, lse, p, krow, q0, tq);
  else
    dkv_probs<SOFTCAP, false>(s, pf, lse, p, krow, q0, tq);""": "  (void)masked;\n  pack(pf, s);",
    """    df[2 * j] = pack_bf16(g[4 * j] * (dp[4 * j] - d2.x), g[4 * j + 1] * (dp[4 * j + 1] - d2.y));
    df[2 * j + 1] =
        pack_bf16(g[4 * j + 2] * (dp[4 * j + 2] - d2.x), g[4 * j + 3] * (dp[4 * j + 3] - d2.y));""":
        """    (void)d2;
    df[2 * j] = pack_bf16(dp[4 * j], dp[4 * j + 1]);
    df[2 * j + 1] = pack_bf16(dp[4 * j + 2], dp[4 * j + 3]);""",
}
# the d 256 dq kernel's release of a tile's K, and where the latek
# variant moves it: after the next tile's ds
_K_EARLY = ("""      fence_regs(dq_acc);
      if (lane == 0) mbar_arrive(k_empty + 8 * s_cur);  // K of this tile is read
      wg_wait<0>();""", """      fence_regs(dq_acc);
      wg_wait<0>();""")
_K_LATE = ("""                        kt * BN + 32 * c, tq);
      pack(f, s_acc);
      s_cur = s_next;""", """                        kt * BN + 32 * c, tq);
      pack(f, s_acc);
      if (lane == 0) mbar_arrive(k_empty + 8 * s_cur);
      s_cur = s_next;""")
# name: (b, hq, hkv, s); causal, d = 128
SHAPES = {"b4_h32_s1024": (4, 32, 32, 1024), "gqa_s1024": (4, 32, 8, 1024),
          "b8_h32_s256": (8, 32, 32, 256), "b1_h8_s8320": (1, 8, 8, 8320)}
BWD_SHAPES = {"b4_h32_s1023": (4, 32, 32, 1023), "gqa_s1024": (4, 32, 8, 1024),
              "b1_h8_s8192": (1, 8, 8, 8192)}
# name: (b, hq, hkv, s, window, softcap); causal, d = 256: chip_smoke.py's
# phase 2b rows at d 256
BWD_D256_SHAPES = {"gemma2_s1023": (4, 8, 4, 1023, None, 50.0),
                   "d256_gqa_s1023": (4, 8, 4, 1023, None, None),
                   "gemma2_w4096_b1_s5000": (1, 8, 4, 5000, 4096, 50.0),
                   "d256_b2_h8_s1024": (2, 8, 8, 1024, None, None)}


def variants() -> dict:
    """{name: source} of the variants built from a patched copy."""
    src = (_build.CSRC / "flash_fwd_sm90.cu").read_text()
    if _SOFTMAX not in src:
        raise RuntimeError("flash_probe: the softmax dispatch in flash_fwd_sm90.cu moved")
    return {"nosoftmax": src.replace(_SOFTMAX, _NO_SOFTMAX)}


def bwd_variants() -> dict:
    """{name: source} of the backward's variants built from a patched copy."""
    base = (_build.CSRC / "flash_bwd_sm90.cu").read_text()
    src = base
    for work, stub in _BWD_ELEM.items():
        if work not in src:
            raise RuntimeError("flash_probe: the elementwise work in flash_bwd_sm90.cu moved")
        src = src.replace(work, stub)
    late = base
    for was, now in (_K_EARLY, _K_LATE):
        if late.count(was) != 1:
            raise RuntimeError("flash_probe: the d 256 dq kernel's K release moved")
        late = late.replace(was, now)
    return {"noelem": src, "latek": late}


def build(sources: dict, base: str = "flash_fwd_sm90") -> dict:
    """nvcc each variant of csrc/<base>.cu beside the port's libraries (the
    header too); returns {name: ctypes library}."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.includes(_build.CSRC / f"{base}.cu"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{base}_{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{base}_{name}.so"
        procs[name] = (so, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                             str(cu)], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise _build.BuildError(f"nvcc failed for the {name} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def round_robin(b, hq, hkv, s, d, causal, window, n_ctas):
    """The static schedule: sm90_items' order dealt out one item a CTA."""
    codes = np.asarray([c for c, _ in fa.sm90_items(b, hq, hkv, s, d, causal, window)],
                       np.int32)
    lists = [codes[c::n_ctas] for c in range(n_ctas)]
    starts = np.zeros(n_ctas + 1, np.int32)
    starts[1:] = np.cumsum([len(x) for x in lists])
    return np.concatenate(lists), starts


def _graph_ms(fn, reps: int = 10, iters: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bwd_main(reps: int) -> int:
    """The backward's variants at BWD_SHAPES (causal, d = 128) and
    BWD_D256_SHAPES (causal, d = 256)."""
    libs = build(bwd_variants(), base=fa.BWD_SM90)
    gen = torch.Generator(device="cuda").manual_seed(0)
    base_lib = _build.load(fa.BWD_SM90)
    runs = [("base", base_lib, fa.BWD_SM90)]
    runs += [(name, lib, fa.BWD_SM90) for name, lib in libs.items()]
    runs += [("mma_sync", None, fa.BWD_MMA_SYNC)]
    inputs = {}
    shapes = {name: (*x, 128, None, None) for name, x in BWD_SHAPES.items()}
    shapes.update({name: (b, hq, hkv, s, 256, window, cap)
                   for name, (b, hq, hkv, s, window, cap) in BWD_D256_SHAPES.items()})
    for shape, (b, hq, hkv, s, d, window, cap) in shapes.items():
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        if cap is not None:
            q = q * 8  # as chip_smoke.py's softcap rows: the scores reach the cap
        out, lse = fa.flash_attention_fwd(q, k, v, window=window, softcap=cap)
        inputs[shape] = (q, k, v, out, lse, torch.randn_like(out), window, cap)
    try:
        for rep in range(reps):
            for name, lib, source in runs:
                if lib is not None:
                    _build._loaded[fa.BWD_SM90] = lib
                line = []
                for shape, (q, k, v, out, lse, dout, window, cap) in inputs.items():
                    args, _ = fa._bwd_launch_args(q, k, v, out, lse, dout, True, None, window,
                                                  cap, source)
                    dq = _graph_ms(lambda: fa._launch_bwd("dq", args["dq"]))
                    dkv = _graph_ms(lambda: fa._launch_bwd("dkv", args["dkv"]))
                    b, hq, s, d = q.shape
                    w = min(window or s, s)
                    pairs = w * (w + 1) // 2 + (s - w) * w
                    flop = 10 * b * hq * d * pairs
                    line.append(f"{shape} dq {dq:.4f} dkv {dkv:.4f} ms "
                                f"({flop / (dq + dkv) / 1e9:.0f} TFLOP/s)")
                print(f"rep {rep} bwd {name}: " + " ".join(line), flush=True)
    finally:
        _build._loaded[fa.BWD_SM90] = base_lib
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--bwd", action="store_true", help="the backward's variants")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    if args.bwd:
        return bwd_main(args.reps)
    libs = build(variants())
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {name: tuple(torch.randn((b, h, s, 128), generator=gen, device="cuda")
                          .to(torch.bfloat16) for h in (hq, hkv, hkv))
              for name, (b, hq, hkv, s) in SHAPES.items()}
    base_lib = _build.load(fa.SM90)
    real_schedule = fa._sm90_schedule_on

    static = {}

    def static_schedule(device, *key):  # built before the graph capture, as the wrapper's
        if key not in static:
            n_ctas = torch.cuda.get_device_properties(device).multi_processor_count
            order, starts = round_robin(*key, n_ctas)
            static[key] = (torch.from_numpy(order).to(device),
                           torch.from_numpy(starts).to(device), n_ctas)
        return static[key]

    runs = [("base", base_lib, real_schedule, fa.SM90), ("roundrobin", base_lib, static_schedule,
                                                          fa.SM90)]
    runs += [(name, lib, real_schedule, fa.SM90) for name, lib in libs.items()]
    runs += [("mma_sync", None, real_schedule, fa.MMA_SYNC)]
    try:
        for rep in range(args.reps):
            for name, lib, schedule, source in runs:
                if lib is not None:
                    _build._loaded[fa.SM90] = lib
                fa._sm90_schedule_on = schedule
                line = []
                for shape, (q, k, v) in inputs.items():
                    ms = _graph_ms(lambda: fa.flash_attention_fwd(q, k, v, source=source))
                    b, hq, s = q.shape[0], q.shape[1], q.shape[2]
                    flop = 4 * b * hq * 128 * s * (s + 1) // 2
                    line.append(f"{shape} {ms:.4f} ms ({flop / ms / 1e9:.0f} TFLOP/s)")
                print(f"rep {rep} {name}: " + " ".join(line), flush=True)
    finally:
        _build._loaded[fa.SM90] = base_lib
        fa._sm90_schedule_on = real_schedule
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
