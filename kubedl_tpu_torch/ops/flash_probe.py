"""Time variants of ops/csrc/flash_fwd_sm90.cu (K1/K4) at chip_smoke.py's
phase-2 shapes, to see what holds the kernel back. Needs an NVIDIA GPU and
nvcc:

    python -m kubedl_tpu_torch.ops.flash_probe [--reps 3]

Each variant is launched through ops/flash_attention.py's wrapper:
  base        the kernel and its host schedule as they are;
  roundrobin  the same kernel on a static schedule: the items in the same
              order (`sm90_items`), CTA c taking items c, c + n, c + 2n, ...
              with no balancing;
  nosoftmax   the source with each tile's softmax replaced by rounding the
              raw scores to bf16: the products, the loads and the epilogue
              alone (its output is wrong; only its time is read);
  mma_sync    flash_fwd.cu, the mma.sync kernel, at the same shapes.
Device time of 10 launches captured in a CUDA graph, median of 7 replays.
Prints the card's name and power limit, then one line per variant and
repetition, in ms and TFLOP/s over the (query, key) pairs the masks keep.
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
# name: (b, hq, hkv, s); causal, d = 128
SHAPES = {"b4_h32_s1024": (4, 32, 32, 1024), "gqa_s1024": (4, 32, 8, 1024),
          "b8_h32_s256": (8, 32, 32, 256), "b1_h8_s8320": (1, 8, 8, 8320)}


def variants() -> dict:
    """{name: source} of the variants built from a patched copy."""
    src = (_build.CSRC / "flash_fwd_sm90.cu").read_text()
    if _SOFTMAX not in src:
        raise RuntimeError("flash_probe: the softmax dispatch in flash_fwd_sm90.cu moved")
    return {"nosoftmax": src.replace(_SOFTMAX, _NO_SOFTMAX)}


def build(sources: dict) -> dict:
    """nvcc each variant beside the port's libraries (the header too);
    returns {name: ctypes library}."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.includes(_build.CSRC / "flash_fwd_sm90.cu"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"flash_fwd_sm90_{name}.cu"
        cu.write_text(src)
        so = out_dir / f"libflash_fwd_sm90_{name}.so"
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_probe: needs a CUDA device")
    libs = build(variants())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
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
