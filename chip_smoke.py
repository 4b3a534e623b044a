"""Drive kubedl_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, each printing its own line of numbers:
  1. device and build: the card's name and power limit, the CUDA kernels
     built from ops/csrc/ in parallel, one nvcc a source (seconds,
     registers, spills; flash_fwd_sm90.cu, flash_bwd_sm90.cu and
     gmm_sm90.cu must show no spill and no wgmma wait that ptxas injected);
  2. the flash forward against its plain PyTorch version on the card, at
     the 7B prefill shapes, serving's short buckets and the variants the
     model can ask for (GQA, window, softcap, d=64, a long sequence): the
     kernel kernel_source routes to (flash_fwd_sm90.cu at d <= 128), the
     mma.sync kernel of flash_fwd.cu at the same shape, and
     scaled_dot_product_attention, each timed as device time (10 launches
     in a CUDA graph, median of 7 replays), the plain version and one
     whole wrapper call (CUDA events, median of 7 after 2 warm-ups), beside
     the least time the card could take;
  3. full-width, full-depth Llama-7B, fresh init on the card: one
     1000-token prefill through the kernel and through plain attention,
     last-token logits compared;
  4. the HTTP server (kubedl_tpu_torch.train.serve) in this process on a
     free port, 8 greedy requests (6 concurrent clients across buckets,
     then one batch of a prompt twice), every answer checked, launch
     counts checked against the prefill dispatches.
  2b. the backward kernels (dq, dkv) against the f32 plain backward at the
     7B training shapes and the variants (GQA, window, softcap, d=64,
     d=256, a long sequence): the source bwd_kernel_source routes to
     (flash_bwd_sm90.cu at d <= 128) and, at d <= 128, flash_bwd.cu's
     mma.sync kernels at the same shape, each two launches bit-identical
     and timed as device time (CUDA graphs), beside one whole wrapper
     call, the plain version and the library (scaled_dot_product_attention
     backward: forward and backward less forward, device time);
  5. gradients through the model at full width, 2 layers: loss_fn and
     every gradient through the kernels against plain attention, with the
     launch counts of full remat;
  6. the trainer (kubedl_tpu_torch.train.trainer) on full-width,
     full-depth Llama-7B in this process: 6 steps, losses and gradient
     norms finite, launch counts, step time, tokens/s, model FLOP share,
     peak memory, and one step under torch.profiler;
  7. the trainer's options (bench-1b: accumulation, chunked CE, "dots"
     remat, cosine schedule) and its preemption contract: a subprocess
     trainer SIGTERMed after its first checkpoint exits 113, and its rerun
     resumes from that checkpoint and exits 0.
  2c. the grouped matmul kernels of gmm_sm90.cu (K6 and its
     transposed-weight use, K7 with f32 and bf16 output, K5 and K8 on bf16
     and int8 weights) against their plain versions at Mixtral-8x7B widths
     on tile maps from the real dispatch plan of seeded routing (training,
     prefill, decode, 512-row tiles, two experts unrouted), two launches of
     each bit-identical and K7's unrouted experts exactly zero, with
     kernel, plain and library (torch._grouped_mm) times beside the bound;
  8. MoE gradients at Mixtral width, 2 layers, b=2, S=1024: loss_fn and
     every gradient through the kernels against the same model with
     models/moe.py's grouped products pointed at the plain versions, and
     the launch counts of full remat;
  9. MoE training at Mixtral width, 4 of 32 layers: 6 steps of
     make_train_step with AdamW and clip 1.0 at b=4, 1024-token rows;
     losses, grad norms, step time, tokens/s, active-parameter FLOP share,
     peak memory, one profiled step;
  10. MoE serving, Mixtral-8x7B at full width and depth in int8, built
     layer by layer on the card: a 2-layer prefill through the kernels
     against the plain versions, then the serving engine (8 slots, 1024
     positions) answers 8 greedy requests and one prompt sent twice.
  11. the sharded slice, on a one-rank NCCL group formed by
     train/coordinator.py's rendezvous: (a) full-width, full-depth
     Llama-7B through make_train_step on a one-device DeviceMesh (the
     sharded code: DTensor leaves, local views, the sharded optimizer), 6
     steps at b=4 and 1024-token rows, in turns with the one-device step on
     the same init and batches (one device, sharded, sharded, one device);
     its first loss against the one-device loss, the flash launch counts
     against phase 6's, step time and peak memory beside the one-device
     step's and phase 6's; (b)
     the expert-parallel dropless body (models/moe.py
     `_dropless_mlp_sharded`) at Mixtral widths on a one-rank expert group,
     2 layers, b=2, S=1024, forward and backward against `_dropless_mlp`
     on the same inputs: routing exact, nothing dropped, outputs and
     gradients within phase 8's tolerance, K5, K6 and K7 launched; (c) the
     gang's preemption contract at bench-1b: a subprocess trainer in a
     one-rank group SIGTERMed after its first sharded checkpoint exits 113,
     and its rerun resumes from it and exits 0.
  12. tensor-parallel serving and the int8 KV cache, in the same one-rank
     group: full-width, full-depth Llama-7B (fresh init, bf16) on the
     serving engine with phase 4's traffic (8 slots, 1024 positions, 6
     prompts at once, then one prompt twice, 32 greedy tokens each), in
     turns one device, mesh, int8 KV, int8 KV, mesh, one device: (a) the
     parameters through shard_tree onto a {"tensor": 1} DeviceMesh into
     ServingEngine(mesh=...), the same tokens bit for bit and the same flash
     launches as the one-device engine, decode ms a tick and prompt tok/s
     beside it; (b) ServingEngine(kv_dtype="int8"): int8 cache leaves, the
     cache's bytes against the bf16 cache's, every request's first token
     equal to the bf16 run's, peak memory, decode ms a tick, and the share
     of greedy tokens that agree with the bf16 run.
Each phase prints its seconds. Then one JSON line of per-kernel numbers
and, last, the device line.
`--out PATH` also writes every number of the run to PATH as JSON. Any
failure raises; the script exits non-zero and prints no result. It needs a
CUDA device and the repository beside it.
"""
import argparse
import contextlib
import dataclasses
import gc
import glob
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
OUT_TOL, LSE_TOL = 2e-2, 1e-3
MODEL_PROMPT = 1000
SERVE_LENGTHS = (17, 100, 250, 513, 700, 992)  # + 32 new tokens <= max_len 1024
SERVE_NEW = 32
# the serving prefill cluster of the longest prompts: 4 rows padded to 1024
MAIN_SHAPE = "7b_b4_s1024"
# the training path's attention: --batch 4 --seq-len 1024 feeds tokens[:, :-1]
MAIN_BWD_SHAPE = "7b_b4_s1023"
BWD_TOL = 2e-2            # max|kernel - plain| / max|plain|, each of dq, dk, dv
GRAD_TOL = 5e-2           # phases 5 and 8, per gradient leaf (bf16 model, 2 layers)
GMM_TOL, TGMM_TOL = 2e-2, 1e-3  # max|kernel - plain| / max|plain|: bf16 out, f32 out
# phase 2c: (tokens routed top-2 of 8, experts that may take a row)
GMM_SHAPES = {
    "train_R8184": (4092, 8),       # b=4 rows of 1024, S=1023 after the shift
    "prefill_R8192": (4096, 8),     # the serving prefill cluster: 4 rows of 1024
    "decode_R16": (8, 8),           # one tick of 8 slots
    "tile512_R32768": (16384, 8),   # large enough for 512-row tiles
    "skewed_R8184": (4092, 6),      # two experts own no row
}
# the shape each kernel's JSON numbers come from: its main path's
MAIN_GMM = {"gmm_swiglu": "train_R8184", "gmm": "train_R8184", "tgmm": "train_R8184",
            "gmm_scaled": "decode_R16"}
# the case each kernel's JSON numbers come from: the training step's K7
# writes bf16 (the weights' dtype)
MAIN_CASE = {"gmm_swiglu": "gmm_swiglu", "gmm": "gmm", "tgmm": "tgmm_bf16",
             "gmm_scaled": "gmm_scaled"}
# each gmm kernel's place in a (K5, K6, K7, K8) launch count
MAIN_INDEX = {"gmm_swiglu": 0, "gmm": 1, "tgmm": 2, "gmm_scaled": 3}
SOURCES = ("flash_fwd_sm90", "flash_fwd", "flash_bwd_sm90", "flash_bwd", "gmm", "gmm_sm90")
# held to no spill and no injected wait
WGMMA_SOURCES = ("flash_fwd_sm90", "flash_bwd_sm90", "gmm_sm90")
MOE_SERVE_LENGTHS = (17, 100, 250, 400, 513, 700, 850, 992)  # + 32 new <= 1024
WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")


def _time_ms(fn, warmup=2, iters=7):
    for _ in range(warmup):
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


def _graph_ms(fn, reps=10, iters=7):
    """Device time of one call of fn: reps calls captured in a CUDA graph,
    replayed between CUDA events (median of iters); the host's cost of each
    call, which _time_ms includes when it exceeds the kernel's, is not."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    for _ in range(2):
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
    del graph
    return statistics.median(times)


def _attended_pairs(s, causal, window):
    """(query, key) pairs the masks keep: the work these inputs need."""
    if not causal:
        return s * s
    if window is None:
        return s * (s + 1) // 2
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def phase_device():
    from kubedl_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {name} (count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda})", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    _build.build(*SOURCES)
    print(f"build: {len(SOURCES)} sources in {time.perf_counter() - t0:.2f} s (parallel nvcc)",
          flush=True)
    for src in SOURCES:
        print(f"build: {src}.cu in {_build.build_seconds[src]:.2f} s -> "
              f"{_build.library_path(src)}", flush=True)
        for line in _build.ptxas_report(src).splitlines():
            print(f"build:   {line}", flush=True)
    for src in WGMMA_SOURCES:
        report = _build.ptxas_report(src)
        spills = [ln for ln in report.splitlines()
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        if spills or "warpgroup.wait is injected" in report:
            raise AssertionError(f"{src}.cu: ptxas spilled or serialized wgmma:\n" + report)
    build = {src: dict(seconds=_build.build_seconds[src], ptxas=_build.ptxas_report(src))
             for src in SOURCES}
    return name, smi, build


def phase_kernels():
    """The flash forward vs its plain version on the card; returns {shape
    name: numbers}."""
    import torch.nn.functional as F

    from kubedl_tpu_torch.ops import flash_attention as fa

    # name: (b, hq, hkv, s, d, causal, window, softcap)
    shapes = {
        "7b_b8_s128": (8, 32, 32, 128, 128, True, None, None),    # serving's short buckets
        "7b_b8_s256": (8, 32, 32, 256, 128, True, None, None),
        "7b_b4_s512": (4, 32, 32, 512, 128, True, None, None),
        "7b_b4_s1000": (4, 32, 32, 1000, 128, True, None, None),
        MAIN_SHAPE: (4, 32, 32, 1024, 128, True, None, None),
        "7b_b4_s2048": (4, 32, 32, 2048, 128, True, None, None),
        "gqa_32q_8kv_s1024": (4, 32, 8, 1024, 128, True, None, None),
        "window256_s2048": (4, 32, 32, 2048, 128, True, 256, None),
        "softcap50_s1024": (4, 32, 32, 1024, 128, True, None, 50.0),
        "d64_s1024": (4, 32, 32, 1024, 64, True, None, None),
        "long_b1_h8_s8320": (1, 8, 8, 8320, 128, True, None, None),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, (b, hq, hkv, s, d, causal, window, softcap) in shapes.items():
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        kw = dict(causal=causal, window=window, softcap=softcap)
        source = fa.kernel_source(d)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        out_err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
        mma_sync_ms = mma_sync_err = mma_sync_lse_err = None
        if source != fa.MMA_SYNC:  # the PR 1 kernel at the same shape, in the same run
            old, old_lse = fa.flash_attention_fwd(q, k, v, source=fa.MMA_SYNC, **kw)
            torch.cuda.synchronize()
            mma_sync_err = (old.float() - ref).abs().max().item()
            mma_sync_lse_err = (old_lse - ref_lse).abs().max().item()
            del old, old_lse
            mma_sync_ms = _graph_ms(lambda: fa.flash_attention_fwd(
                q, k, v, source=fa.MMA_SYNC, **kw))
        del ref, ref_lse
        kernel_ms = _graph_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        wrapper_ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw))
        library_ms = None
        if softcap is None:  # scaled_dot_product_attention has no softcap
            mask = None
            if window is not None:
                mask = fa._mask(s, causal, window, q.device)
            library_ms = _graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=hq != hkv))
        flops = 4 * b * hq * d * _attended_pairs(s, causal, window)
        nbytes = 2 * s * d * b * (2 * hq + 2 * hkv) + 4 * b * hq * s
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        r = dict(shape=[b, hq, hkv, s, d], causal=causal, window=window,
                 softcap=softcap, source=f"{source}.cu", out_max_abs_err=out_err,
                 lse_max_abs_err=lse_err, kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
                 mma_sync_ms=mma_sync_ms, mma_sync_err=mma_sync_err,
                 mma_sync_lse_err=mma_sync_lse_err,
                 speedup_vs_mma_sync=None if mma_sync_ms is None else mma_sync_ms / kernel_ms,
                 plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 share_of_bound=bound_ms / kernel_ms,
                 tflops=flops / kernel_ms / 1e9)
        results[name] = r
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        old = "n/a" if mma_sync_ms is None else \
            f"{mma_sync_ms:.4f} (x{r['speedup_vs_mma_sync']:.2f}, err {mma_sync_err:.2e})"
        print(f"kernel {name} [{source}.cu]: kernel_ms={kernel_ms:.4f} "
              f"wrapper_ms={wrapper_ms:.4f} mma_sync_ms={old} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={bound_ms:.4f} ({r['bound_by']}) "
              f"share={r['share_of_bound']:.3f} tflops={r['tflops']:.1f} "
              f"out_err={out_err:.3e} lse_err={lse_err:.3e}", flush=True)
        if not finite or out_err > OUT_TOL or lse_err > LSE_TOL:
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at {name}: "
                f"finite={finite} out_err={out_err} (tol {OUT_TOL}) "
                f"lse_err={lse_err} (tol {LSE_TOL})")
        if mma_sync_err is not None and (mma_sync_err > OUT_TOL or mma_sync_lse_err > LSE_TOL):
            raise AssertionError(f"the mma.sync forward disagrees at {name}: out "
                                 f"{mma_sync_err} lse {mma_sync_lse_err}")
        del q, k, v, out, lse
    return results


def phase_model():
    """7B prefill through the kernel vs through plain attention."""
    import dataclasses

    from kubedl_tpu_torch.models import decode, llama
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    config = llama.LlamaConfig.llama_7b()
    t0 = time.perf_counter()
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = llama.param_count(params)
    prompt = torch.randint(0, config.vocab_size, (1, MODEL_PROMPT),
                           generator=torch.Generator(device="cuda").manual_seed(1),
                           device="cuda", dtype=torch.int32)
    out = {}
    for label, cfg in (("kernel", config),
                       ("plain", dataclasses.replace(config, use_flash=False))):
        for _ in range(2):  # the first call warms cuBLAS; the second is timed
            flash_attention.launches = 0
            cache = decode.init_kv_cache(cfg, 1, MODEL_PROMPT, uniform=True,
                                         device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = decode.prefill(params, prompt, cache, cfg)
            torch.cuda.synchronize()
            out[label] = (logits[0].float(), time.perf_counter() - t0,
                          flash_attention.launches)
            del cache
    (lk, tk, nk), (lp, tp, npl) = out["kernel"], out["plain"]
    if nk != config.n_layers or npl != 0:
        raise AssertionError(f"prefill launched the kernel {nk} times (expected "
                             f"{config.n_layers}), the plain path {npl} (expected 0)")
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite 7B logits")
    max_abs = (lk - lp).abs().max().item()
    scale = lp.abs().max().item()
    ak, ap = int(lk.argmax()), int(lp.argmax())
    # a differing argmax passes only as a near-tie within the measured error
    tie_gap = (lp[ap] - lp[ak]).item()
    print(f"model: llama-7b {n_params / 1e9:.3f}B params, init {init_s:.2f} s; "
          f"prefill {MODEL_PROMPT} tokens kernel {tk * 1e3:.1f} ms "
          f"plain {tp * 1e3:.1f} ms (second calls); last-token logits "
          f"max_abs_diff={max_abs:.4e} (max |logit| {scale:.3f}, rel "
          f"{max_abs / scale:.3e}) argmax {ak} vs {ap} "
          f"{'agree' if ak == ap else f'gap {tie_gap:.3e}'}", flush=True)
    # bf16 activations through 32 layers: the kernel rounds p to bf16 before
    # p.v and sums in another order than the f32 plain attention
    if max_abs > 0.05 * scale or (ak != ap and tie_gap > max_abs):
        raise AssertionError("7B prefill through the kernel disagrees with "
                             "plain attention")
    del params
    torch.cuda.empty_cache()
    return dict(n_params=n_params, init_s=init_s, logits_max_abs=max_abs,
                logits_max=scale, argmax_agree=ak == ap)


def _post(base, body, timeout=600):
    req = urllib.request.Request(f"{base}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _profile_engine(engine):
    """Where the serving time goes: one admission wave (8 prompts of 500
    tokens, one prefill) and 8 decode ticks of the full slot batch, each
    under torch.profiler. Device busy time is the union of the CUDA kernel
    intervals; idle share = 1 - busy / wall (the profiler's own host cost
    is inside wall, so idle is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = torch.Generator().manual_seed(3)
    for _ in range(engine.slots):
        engine.submit(torch.randint(1, 32000, (500,), generator=rng).tolist(), 9)
    out = {}
    for label, fn, ticks in (("prefill", engine._admit, 0),
                             ("decode", lambda: engine.step_block(8), 8)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, end = 0.0, float("-inf")
        for r0, r1 in spans:  # union of kernel intervals
            start = max(r0, end)
            if r1 > start:
                busy_us += r1 - start
            end = max(end, r1)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        out[label] = dict(
            wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
            idle_share=1 - busy_us / 1e3 / wall_ms if spans else None,
            kernels=len(spans), ticks=ticks,
            top=[(name[:60], us / 1e3) for name, us in top])
        share = "not measured" if not spans else f"{out[label]['idle_share']:.3f}"
        per = f", {len(spans) / ticks:.0f} kernels/tick" if ticks else ""
        print(f"profile {label}: wall {wall_ms:.1f} ms (profiled), device busy "
              f"{busy_us / 1e3:.1f} ms, idle share {share}, {len(spans)} kernels{per}; "
              f"top: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in out[label]["top"]),
              flush=True)
    while engine.has_pending():
        engine.step_block(8)
    return out


def phase_serve():
    """The port's HTTP server on Llama-7B: returns (numbers, kernel launches)."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention
    from kubedl_tpu_torch.train import serve

    args = serve.parse_args(["--model", "llama-7b", "--allow-fresh-init",
                             "--slots", "8", "--max-len", "1024", "--port", "0",
                             "--bind", "127.0.0.1"])
    t0 = time.perf_counter()
    httpd, svc = serve.build_server(args)
    setup_s = time.perf_counter() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    print(f"serve: {base} up in {setup_s:.2f} s (fresh 7B init on the card)",
          flush=True)
    try:
        rng = torch.Generator().manual_seed(2)
        prompts = [torch.randint(1, 32000, (n,), generator=rng).tolist()
                   for n in SERVE_LENGTHS]
        dup = prompts[2]
        flash_attention.launches = 0
        results = [None] * len(prompts)

        def client(i):
            results[i] = _post(base, {"tokens": prompts[i],
                                      "max_new_tokens": SERVE_NEW})

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        pair = _post(base, {"requests": [{"tokens": dup, "max_new_tokens": SERVE_NEW},
                                         {"tokens": dup, "max_new_tokens": SERVE_NEW}]})
        wall_s = time.perf_counter() - t0
        launches = flash_attention.launches
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        engine_ticks = svc.engine.stats()["ticks"]
        with svc._lock:  # the pump is idle; keep it off the engine meanwhile
            profile = _profile_engine(svc.engine)
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
        httpd.server_close()
        svc.stop()
    del httpd, svc, thread  # the engine and its 7B weights go with them
    answers = results + pair["results"]
    for n, a in zip(list(SERVE_LENGTHS) + [len(dup)] * 2, answers):
        if a is None or a.get("error") or len(a["tokens"]) != SERVE_NEW:
            raise AssertionError(f"request of {n} prompt tokens failed: {a}")
        if not all(0 <= t < 32000 for t in a["tokens"]):
            raise AssertionError(f"token out of vocab: {a['tokens']}")
    if pair["results"][0]["tokens"] != pair["results"][1]["tokens"]:
        raise AssertionError("one prompt sent twice gave different tokens")
    if health != {"ok": True}:
        raise AssertionError(f"/healthz: {health}")
    n_layers = 32
    if launches < n_layers * stats["prefill_batches"] or launches == 0:
        raise AssertionError(
            f"flash kernel launched {launches} times for "
            f"{stats['prefill_batches']} prefill dispatches x {n_layers} layers")
    prompt_tokens = sum(SERVE_LENGTHS) + 2 * len(dup)
    decode_tokens = stats["tokens_out"] - len(answers)  # first tokens come from prefill
    numbers = dict(
        requests=len(answers), wall_s=wall_s, prompt_tokens=prompt_tokens,
        tokens_out=stats["tokens_out"], prefill_batches=stats["prefill_batches"],
        prefill_time_s=stats["prefill_time_s"], decode_time_s=stats["decode_time_s"],
        ticks=engine_ticks, profile=profile,
        prefill_tok_s=prompt_tokens / stats["prefill_time_s"],
        decode_tok_s=decode_tokens / stats["decode_time_s"],
        served_tok_s=stats["tokens_out"] / wall_s, flash_launches=launches)
    print(f"serve: {len(answers)} requests ok in {wall_s:.2f} s; prefill "
          f"{stats['prefill_batches']} dispatches {stats['prefill_time_s']:.3f} s "
          f"({numbers['prefill_tok_s']:.0f} prompt tok/s); decode "
          f"{stats['decode_time_s']:.3f} s over {engine_ticks} ticks "
          f"({stats['decode_time_s'] / max(engine_ticks, 1) * 1e3:.1f} ms/tick, "
          f"{numbers['decode_tok_s']:.1f} tok/s); "
          f"tokens_out {stats['tokens_out']} ({numbers['served_tok_s']:.1f} tok/s "
          f"served); flash launches {launches}", flush=True)
    return numbers, launches


def _bwd_bounds(b, hq, hkv, s, d, causal, window):
    """(flop, bytes) of the least work: dq alone (3 products: s, dO.v^T,
    ds.k), dkv alone (4: s, dO.v^T, p^T.dO, ds^T.q) and the whole backward
    (5 products, 10 b h d pairs FLOP) against q, k, v, o, dO, LSE read once
    and dq, dk, dv written once."""
    pairs = b * hq * d * _attended_pairs(s, causal, window)
    q_b, kv_b, row_b = 2 * b * hq * s * d, 2 * b * hkv * s * d, 4 * b * hq * s
    dq = (6 * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + q_b)   # q dO k v lse delta -> dq
    dkv = (8 * pairs, 2 * q_b + 2 * kv_b + 2 * row_b + 2 * kv_b)
    whole = (10 * pairs, 3 * q_b + 2 * kv_b + row_b + q_b + 2 * kv_b)  # + o; lse
    return {"dq": dq, "dkv": dkv, "bwd": whole}


def _bound(flop, nbytes):
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# the backward kernels' tiles: source -> ((q rows, key rows) of a dq
# item's tile, (key rows, q rows) of a dkv item's tile)
BWD_TILES = {"flash_bwd_sm90": ((128, 64), (128, 64)), "flash_bwd": ((64, 64), (64, 32))}


def _loaded_pairs(s, causal, window, rows, cols, by_key):
    """(query, key) pairs of the tiles a kernel loads for one head: items
    of `rows` query rows (key rows when by_key) over streamed tiles of
    `cols` rows, from the diagonal and within the window, as the kernels'
    live ranges run; masked pairs included."""
    tiles = 0
    for t in range(-(-s // rows)):
        r0, n = t * rows, -(-s // cols)
        if by_key:
            if window:
                n = min(n, (min(r0 + rows, s) - 1 + window - 1) // cols + 1)
            tiles += max(n - (r0 // cols if causal else 0), 0)
        else:
            if causal:
                n = min(n, (r0 + rows - 1) // cols + 1)
            lo = r0 - window + 1 if window else 0
            tiles += n - (lo // cols if lo > 0 else 0)
    return tiles * rows * cols


def _executed_share(source, b, hq, s, d, causal, window):
    """The least backward work (5 products a kept pair) over what the two
    kernels run: 3 products a loaded pair in dq, 4 in dkv."""
    (qr, kc), (kr, qc) = BWD_TILES[source]
    run = 6 * d * _loaded_pairs(s, causal, window, qr, kc, False) \
        + 8 * d * _loaded_pairs(s, causal, window, kr, qc, True)
    return 10 * d * _attended_pairs(s, causal, window) / run


def phase_bwd_kernels():
    """The dq and dkv kernels against the f32 plain backward; returns
    {shape name: numbers}: the routed source's at the top level, flash_bwd.cu's
    under "mma_sync" where the route is flash_bwd_sm90.cu."""
    import torch.nn.functional as F

    from kubedl_tpu_torch.ops import flash_attention as fa

    # name: (b, hq, hkv, s, d, causal, window, softcap)
    shapes = {
        MAIN_BWD_SHAPE: (4, 32, 32, 1023, 128, True, None, None),
        "7b_b4_s1024": (4, 32, 32, 1024, 128, True, None, None),
        "7b_b4_s2048": (4, 32, 32, 2048, 128, True, None, None),
        "gqa_32q_8kv_s1024": (4, 32, 8, 1024, 128, True, None, None),
        "window256_s2048": (4, 32, 32, 2048, 128, True, 256, None),
        "softcap50_s1024": (4, 32, 32, 1024, 128, True, None, 50.0),
        "d64_s1024": (4, 32, 32, 1024, 64, True, None, None),
        "d256_b2_h8_s1024": (2, 8, 8, 1024, 256, True, None, None),
        "b1_h8_s8192": (1, 8, 8, 8192, 128, True, None, None),
    }
    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for name, (b, hq, hkv, s, d, causal, window, softcap) in shapes.items():
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        dout = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                           lse, dout.float(), **kw)
        routed = fa.bwd_kernel_source(d)
        runs = {}
        for source in (routed, fa.BWD_MMA_SYNC) if routed != fa.BWD_MMA_SYNC else (routed,):
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, source=source, **kw)
            again = fa.flash_attention_bwd(q, k, v, out, lse, dout, source=source, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            errs, finite = {}, True
            for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
                finite = finite and bool(torch.isfinite(g.float()).all())
                errs[gname] = ((g.float() - r).abs().max() / r.abs().max()).item()
                errs[gname + "_abs"] = (g.float() - r).abs().max().item()
            del got, again
            launch_args, _ = fa._bwd_launch_args(q, k, v, out, lse, dout, causal, None,
                                                 window, softcap, source)
            dq_ms = _graph_ms(lambda: fa._launch_bwd("dq", launch_args["dq"]))
            dkv_ms = _graph_ms(lambda: fa._launch_bwd("dkv", launch_args["dkv"]))
            del launch_args
            runs[source] = dict(source=f"{source}.cu", errors=errs, finite=finite,
                                deterministic=same, dq_ms=dq_ms, dkv_ms=dkv_ms,
                                executed_work_share=_executed_share(source, b, hq, s, d, causal,
                                                                    window))
            if not finite or not same or max(errs[g] for g in ("dq", "dk", "dv")) > BWD_TOL:
                raise AssertionError(
                    f"{source}.cu disagrees with the plain backward at {name}: finite={finite} "
                    f"deterministic={same} errors={errs} (tol {BWD_TOL})")
        del ref
        wrapper_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw),
                            iters=3)
        library_ms = None
        if softcap is None and window is None:  # no library call has these
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                      enable_gqa=hq != hkv)

            # device time, as the kernels': timed by events, the host's cost of
            # autograd shows through
            fwd_bwd = _graph_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), dout))
            with torch.no_grad():
                fwd_only = _graph_ms(sdpa)
            library_ms = fwd_bwd - fwd_only
        work = _bwd_bounds(b, hq, hkv, s, d, causal, window)
        r = dict(shape=[b, hq, hkv, s, d], causal=causal, window=window, softcap=softcap,
                 **runs[routed], wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                 library_ms=library_ms)
        for part in ("dq", "dkv", "bwd"):
            r[f"{part}_bound_ms"], r[f"{part}_bound_by"] = _bound(*work[part])
        kernel_ms = r["dq_ms"] + r["dkv_ms"]
        r["share_of_bound"] = r["bwd_bound_ms"] / kernel_ms
        r["tflops"] = work["bwd"][0] / kernel_ms / 1e9
        old = runs.get(fa.BWD_MMA_SYNC) if routed != fa.BWD_MMA_SYNC else None
        r["mma_sync"] = old
        r["speedup_vs_mma_sync"] = None if old is None else \
            (old["dq_ms"] + old["dkv_ms"]) / kernel_ms
        results[name] = r
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        errs = r["errors"]
        vs = "n/a" if old is None else \
            (f"{old['dq_ms']:.4f}+{old['dkv_ms']:.4f} (x{r['speedup_vs_mma_sync']:.2f}, "
             f"rel_err dq={old['errors']['dq']:.2e} dk={old['errors']['dk']:.2e} "
             f"dv={old['errors']['dv']:.2e})")
        print(f"bwd {name} [{routed}.cu]: dq_ms={r['dq_ms']:.4f} (bound {r['dq_bound_ms']:.4f} "
              f"{r['dq_bound_by']}) dkv_ms={r['dkv_ms']:.4f} (bound {r['dkv_bound_ms']:.4f} "
              f"{r['dkv_bound_by']}) mma_sync={vs} wrapper_ms={wrapper_ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib} bwd_bound_ms={r['bwd_bound_ms']:.4f} "
              f"({r['bwd_bound_by']}) share={r['share_of_bound']:.3f} "
              f"executed_work_share={r['executed_work_share']:.3f} tflops={r['tflops']:.1f} "
              f"rel_err dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e} "
              f"deterministic={r['deterministic']}", flush=True)
        del q, k, v, out, lse, dout
    return results


def _counts():
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    return (flash_attention.launches, flash_attention.bwd_dq_launches,
            flash_attention.bwd_dkv_launches)


def _reset_counts():
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    flash_attention.bwd_dq_launches = 0
    flash_attention.bwd_dkv_launches = 0


def phase_grads():
    """loss_fn and every gradient at full width, 2 layers, b=2, S=1024,
    through the kernels against plain attention."""
    import dataclasses

    from kubedl_tpu_torch.models import llama

    config = dataclasses.replace(llama.LlamaConfig.llama_7b(), n_layers=2)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, config.vocab_size, (2, 1025), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(4))
    out = {}
    for label, cfg in (("kernel", config),
                       ("plain", dataclasses.replace(config, use_flash=False))):
        tree = llama.tree_map(lambda x: x.detach().requires_grad_(True), params)
        leaves = list(llama.tree_leaves(tree))
        _reset_counts()
        loss = llama.loss_fn(tree, tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[label] = (loss.item(), grads, _counts())
    n = config.n_layers
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    if ck != (2 * n, n, n) or cp != (0, 0, 0):
        raise AssertionError(f"gradient launches (fwd, dq, dkv): kernel path {ck} "
                             f"(expected {(2 * n, n, n)} under full remat), plain {cp}")
    names = ["embed"] + [f"layers.{i}.{k}" for i, layer in enumerate(params["layers"])
                         for k in layer] + [k for k in params if k not in ("embed", "layers")]
    errs = {}
    for nm, a, b in zip(names, gk, gp):
        if a.dtype != b.dtype or not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"gradient {nm}: dtype {a.dtype} vs {b.dtype} or not finite")
        errs[nm] = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    worst = max(errs, key=errs.get)
    loss_rel = abs(lk - lp) / abs(lp)
    print(f"grads: llama-7b width, 2 layers, b=2 S=1024: loss kernel {lk:.6f} plain "
          f"{lp:.6f} (rel {loss_rel:.2e}); worst gradient {worst} rel {errs[worst]:.3e} "
          f"over {len(errs)} leaves (tol {GRAD_TOL}); launches fwd/dq/dkv {ck}", flush=True)
    if loss_rel > 1e-2 or errs[worst] > GRAD_TOL:
        raise AssertionError("gradients through the kernels disagree with plain attention")
    del params, out, gk, gp
    return dict(loss_kernel=lk, loss_plain=lp, loss_rel=loss_rel, grad_rel_err=errs,
                launches=list(ck))


def _trace_spans(trace_dir):
    spans = []
    for path in sorted(glob.glob(os.path.join(trace_dir, "*.jsonl"))):
        if path.endswith(".steps.jsonl"):
            continue
        with open(path) as f:
            spans += [json.loads(line) for line in f if line.strip()]
    return spans


def _kernel_profile(trace_json, wall_ms):
    """Device busy time (union of kernel intervals), idle share and top
    kernels of a torch.profiler Chrome trace."""
    with open(trace_json) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kern)
    busy_us, end = 0.0, float("-inf")
    for r0, r1 in spans:
        start = max(r0, end)
        if r1 > start:
            busy_us += r1 - start
        end = max(end, r1)
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    groups = {"gmm kernels": 0.0, "flash kernels": 0.0, "GEMM (cuBLAS)": 0.0,
              "elementwise and other": 0.0}
    for n, us in by_name.items():
        if "gmm_kernel" in n:  # gmm_kernel<...>, gmm_sm90_gmm_kernel, tgmm_sm90_gmm_kernel
            groups["gmm kernels"] += us / 1e3
        elif "flash_" in n:
            groups["flash kernels"] += us / 1e3
        elif any(t in n.lower() for t in ("nvjet", "gemm", "gemv", "cutlass", "xmma")):
            groups["GEMM (cuBLAS)"] += us / 1e3
        else:
            groups["elementwise and other"] += us / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, kernels=len(kern),
                idle_share=(1 - busy_us / 1e3 / wall_ms) if kern else None,
                top=[(n[:70], us / 1e3) for n, us in top], groups=groups)


def _run_trainer(argv, tag):
    """trainer.main(argv) in this process with its spans exported to a
    fresh trace dir; returns (rc, train spans, trace dir)."""
    from kubedl_tpu_torch.train import trainer

    trace_dir = os.path.join(WORK, f"trace-{tag}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in ("KUBEDL_TRACE_DIR", "POD_NAME")}
    os.environ.update(KUBEDL_TRACE_DIR=trace_dir, POD_NAME=f"chip-smoke-{tag}")
    try:
        rc = trainer.main(argv)
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    steps = [sp for sp in _trace_spans(trace_dir)
             if sp["name"] in ("train.compile", "train.step")]
    steps.sort(key=lambda sp: sp["attrs"]["step"])
    return rc, steps, trace_dir


def phase_train(n_params):
    """The trainer on full-width, full-depth Llama-7B, 6 steps; n_params is
    the model's parameter count (phase 3)."""
    from kubedl_tpu_torch.models import llama

    steps, n_layers, batch, seq = 6, 32, 4, 1024
    profile_dir = os.path.join(WORK, "profile-7b")
    shutil.rmtree(profile_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    rc, spans, _ = _run_trainer(
        ["--model", "llama-7b", "--batch", str(batch), "--seq-len", str(seq),
         "--steps", str(steps), "--log-every", "1", "--grad-clip", "1.0",
         "--profile-dir", profile_dir, "--profile-steps", "1"], "7b")
    wall_s = time.perf_counter() - t0
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0 or len(spans) != steps:
        raise AssertionError(f"7B trainer: rc={rc}, {len(spans)} step spans of {steps}")
    losses = [sp["attrs"]["loss"] for sp in spans]
    gnorms = [sp["attrs"]["grad_norm"] for sp in spans]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"7B trainer: non-finite loss or grad_norm {losses} {gnorms}")
    if abs(losses[0] - math.log(32000)) > 1.5:
        raise AssertionError(f"7B first loss {losses[0]} not within 1.5 of ln 32000")
    want = (2 * steps * n_layers, steps * n_layers, steps * n_layers)
    if counts != want:
        raise AssertionError(f"7B trainer launches (fwd, dq, dkv) {counts}, expected {want}")
    step_s = statistics.median(sp["dur"] for sp in spans[1:])
    tokens = batch * (seq - 1)
    config = llama.LlamaConfig.llama_7b()
    attn_flop = 12 * n_layers * batch * config.n_heads * config.head_dim * \
        _attended_pairs(seq - 1, True, None)
    model_flop = 6 * n_params * tokens + attn_flop
    mfu = model_flop / (step_s * PEAK_BF16_FLOPS)
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    if len(traces) != 1:
        raise AssertionError(f"7B trainer wrote {len(traces)} profile traces")
    prof = _kernel_profile(traces[0], spans[1]["dur"] * 1e3)
    share = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.3f}"
    print(f"train: llama-7b {steps} steps b={batch} seq={seq} in {wall_s:.1f} s (init "
          f"included); losses {', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}", flush=True)
    print(f"train: step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; first step "
          f"{spans[0]['dur'] * 1e3:.1f} ms), {tokens / step_s:.0f} tok/s, model FLOP "
          f"share (6*N*T + 12*L*b*h*d*pairs over step time x 989e12) {mfu:.3f}; peak "
          f"allocated {peak_gb:.2f} GB; launches fwd/dq/dkv {counts}", flush=True)
    print(f"profile train step: wall {prof['wall_ms']:.1f} ms (profiled), device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share {share}, {prof['kernels']} kernels; "
          f"top: " + "; ".join(f"{n} {ms:.2f} ms" for n, ms in prof["top"]), flush=True)
    print("profile train step by kind: " + "; ".join(
        f"{k} {ms:.1f} ms" for k, ms in prof["groups"].items()), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    opt = _optimizer_alone(config)
    return dict(optimizer=opt, losses=losses, grad_norms=gnorms, step_ms=step_s * 1e3,
                first_step_ms=spans[0]["dur"] * 1e3, tok_s=tokens / step_s,
                model_flop_per_step=model_flop, model_flop_share=mfu, peak_gb=peak_gb,
                launches=list(counts), wall_s=wall_s, profile=prof)


def _optimizer_alone(config):
    """The trainer's optimizer (clip + AdamW, leaf by leaf) alone on the 7B
    leaves, against its bound: p, g, mu, nu read and p, mu, nu written."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim

    leaves = list(llama.tree_leaves(
        llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")))
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = [torch.randn(p.shape, generator=gen, device="cuda").mul_(1e-3).to(p.dtype)
             for p in leaves]
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    state = tx.init(leaves)
    ms = _time_ms(lambda: tx.apply(leaves, grads, state), warmup=1, iters=3)
    nbytes = 7 * sum(p.numel() * p.element_size() for p in leaves)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"optimizer: clip + AdamW over {len(leaves)} leaves of 7B: {ms:.1f} ms a step, "
          f"bound {bound_ms:.1f} ms (bytes)", flush=True)
    del leaves, grads, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=bound_ms)


def _latest_ckpt(path):
    steps = [int(d) for d in os.listdir(path) if d.isdigit()] if os.path.isdir(path) else []
    return max(steps) if steps else None


def phase_options():
    """bench-1b with the trainer's options in process; then a subprocess
    trainer preempted by SIGTERM and resumed."""
    _reset_counts()
    steps = 4
    rc, spans, _ = _run_trainer(
        ["--model", "bench-1b", "--batch", "4", "--seq-len", "512", "--steps", str(steps),
         "--accum-steps", "2", "--ce-chunks", "4", "--remat", "dots",
         "--lr-schedule", "cosine", "--warmup-steps", "2", "--log-every", "1"], "1b")
    counts = _counts()
    losses = [sp["attrs"]["loss"] for sp in spans]
    gnorms = [sp["attrs"]["grad_norm"] for sp in spans]
    if rc != 0 or len(spans) != steps or not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"bench-1b trainer: rc={rc} losses={losses} grad_norm={gnorms}")
    # "dots" recomputes the flash forward too: twice a layer a micro-step
    if counts != (2 * steps * 16, steps * 16, steps * 16):
        raise AssertionError(f"bench-1b launches (fwd, dq, dkv) {counts}")
    print(f"options: bench-1b accum 2, ce_chunks 4, remat dots, cosine warmup 2: "
          f"{steps} steps, losses {', '.join(f'{x:.4f}' for x in losses)}, grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}, launches fwd/dq/dkv {counts}", flush=True)

    ckpt = os.path.join(WORK, "ckpt-tiny")
    shutil.rmtree(ckpt, ignore_errors=True)
    cmd = [sys.executable, "-m", "kubedl_tpu_torch.train.trainer", "--model", "tiny",
           "--steps", "500", "--batch", "8", "--seq-len", "65", "--log-every", "1000",
           "--checkpoint-path", ckpt, "--checkpoint-interval", "10"]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while _latest_ckpt(ckpt) is None and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        if proc.poll() is not None or _latest_ckpt(ckpt) is None:
            raise AssertionError(f"tiny trainer ended or stalled before its first "
                                 f"checkpoint: rc={proc.poll()}")
        proc.send_signal(signal.SIGTERM)
        first_out = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    at = _latest_ckpt(ckpt)
    if proc.returncode != 113 or at is None or "preempted: checkpoint saved" not in first_out:
        raise AssertionError(f"SIGTERM: rc={proc.returncode} (expected 113), checkpoint "
                             f"{at}:\n{first_out[-2000:]}")
    rerun = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                           timeout=600)
    if rerun.returncode != 0 or f"restored checkpoint at step {at}" not in rerun.stdout \
            or _latest_ckpt(ckpt) != 500:
        raise AssertionError(f"resume: rc={rerun.returncode}, latest {_latest_ckpt(ckpt)}:\n"
                             f"{rerun.stdout[-2000:]}{rerun.stderr[-2000:]}")
    print(f"preemption: tiny trainer SIGTERMed, exit 113 with a checkpoint at step {at}; "
          f"rerun restored step {at}, exit 0, final checkpoint at step 500", flush=True)
    return dict(bench_1b=dict(losses=losses, grad_norms=gnorms, launches=list(counts)),
                preempted_at=at)


def _free_port():
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _one_rank_group():
    """This process as a group of one over NCCL, formed by the port's own
    rendezvous from an address, as a pod of one would form it."""
    import torch.distributed as dist

    from kubedl_tpu_torch.train import coordinator

    if not dist.is_initialized():
        torch.cuda.set_device(0)
        coordinator.initialize(coordinator.ProcessInfo(
            coordinator_address=f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0),
            backend="nccl")


def _run_7b_steps(config, batches, mesh=None):
    """make_train_step on a fresh 7B init (seed 0) over `batches`, on one
    device (mesh None) or through the sharded code on `mesh`: (losses,
    grad norms, step times in s, flash launches (fwd, dq, dkv), peak GB,
    the one-device loss of the first batch before any step)."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import ShardingRules
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    rules = ShardingRules()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    with torch.no_grad():
        plain_loss = llama.loss_fn(params, batches[0], config).item()
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    if mesh is None:
        init_state, train_step = make_train_step(lambda p, b: llama.loss_fn(p, b, config), tx)
    else:
        init_state, train_step = make_train_step(
            lambda p, b: llama.loss_fn(p, b, config, mesh=mesh, rules=rules), tx, mesh,
            llama.param_specs(config, rules), rules.spec("batch", None), rules)
    state = init_state(params)
    del params
    kind = type(next(iter(llama.tree_leaves(state.params)))).__name__
    if (kind == "DTensor") != (mesh is not None):
        raise AssertionError(f"7B step on mesh {mesh}: leaves are {kind}")
    _reset_counts()
    losses, gnorms, times = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        times.append(time.perf_counter() - t0)
    counts = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return losses, gnorms, times, counts, peak_gb, plain_loss


def phase_sharded_step(train):
    """11a: the 7B step through the sharded code on a one-device mesh, in
    turns with the one-device step on the same init and batches (one
    device, sharded, sharded, one device), beside phase 6 (`train`, the
    trainer's numbers on the same card)."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel.mesh import build_mesh

    _one_rank_group()
    steps, batch, seq = 6, 4, 1024
    config = llama.LlamaConfig.llama_7b()
    mesh = build_mesh({"data": 1}, device_type="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    batches = [torch.randint(0, config.vocab_size, (batch, seq), generator=gen, device="cuda",
                             dtype=torch.int32) for _ in range(steps)]
    turns = {}
    for label in ("one_device", "sharded", "sharded", "one_device"):
        turns.setdefault(label, []).append(
            _run_7b_steps(config, batches, mesh if label == "sharded" else None))
    for losses, gnorms, _, counts, _, plain_loss in turns["sharded"]:
        if not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError(f"sharded 7B step: non-finite loss or grad_norm {losses} "
                                 f"{gnorms}")
        loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
        if loss_rel > 1e-2:  # phase 5's bf16 loss tolerance
            raise AssertionError(f"sharded 7B first loss {losses[0]} vs one-device "
                                 f"{plain_loss}")
        if list(counts) != train["launches"]:
            raise AssertionError(f"sharded 7B launches (fwd, dq, dkv) {counts}, phase 6 "
                                 f"{train['launches']}")
    med = {k: [statistics.median(t[2][1:]) * 1e3 for t in v] for k, v in turns.items()}
    losses, gnorms, times, counts, peak_gb, plain_loss = turns["sharded"][0]
    loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    one_losses = turns["one_device"][0][0]
    step_ms = statistics.mean(med["sharded"])
    ratio6 = step_ms / train["step_ms"]
    ratio1 = step_ms / statistics.mean(med["one_device"])
    print(f"sharded step: llama-7b on a one-device DeviceMesh (one-rank NCCL group), "
          f"{steps} steps b={batch} seq={seq}; first loss {losses[0]:.6f} vs one-device "
          f"{plain_loss:.6f} (rel {loss_rel:.2e}); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} (one-device step: "
          f"{', '.join(f'{x:.4f}' for x in one_losses)}); grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}", flush=True)
    print(f"sharded step: step {step_ms:.1f} ms (median of steps 2-{steps}, turns "
          f"{', '.join(f'{x:.1f}' for x in med['sharded'])}) vs the one-device step "
          f"{', '.join(f'{x:.1f}' for x in med['one_device'])} in turns (ratio {ratio1:.4f}) "
          f"and phase 6's {train['step_ms']:.1f} ms (ratio {ratio6:.4f}); peak allocated "
          f"{peak_gb:.2f} GB vs phase 6's {train['peak_gb']:.2f} GB; launches fwd/dq/dkv "
          f"{counts}", flush=True)
    return dict(losses=losses, grad_norms=gnorms, plain_loss=plain_loss, loss_rel=loss_rel,
                one_device_losses=one_losses, step_ms=step_ms, turns_ms=med,
                first_step_ms=times[0] * 1e3, ratio_to_one_device=ratio1,
                ratio_to_phase6=ratio6, peak_gb=peak_gb, launches=list(counts))


def phase_ep_body():
    """11b: the expert-parallel dropless body on a one-rank expert group at
    Mixtral widths, 2 layers, against the one-device dropless route."""
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh

    _one_rank_group()
    mesh = build_mesh({"expert": 1}, device_type="cuda")
    rules = ShardingRules()
    config = _mixtral(2)
    e, k, d = config.n_experts, config.expert_top_k, config.d_model
    s = 2 * 1024
    gen = torch.Generator(device="cuda").manual_seed(12)
    layers, worst, counts, want_counts = [], {}, (0, 0, 0, 0), (0, 0, 0, 0)
    names = ("router", "w1", "w3", "w2")
    for li in range(config.n_layers):
        params = moe.moe_init(d, config.d_ff, e, dtype=torch.bfloat16, generator=gen,
                              device="cuda")
        h = (torch.randn(s, d, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
        dy = torch.randn(s, d, generator=gen, device="cuda").to(torch.bfloat16)
        out = {}
        for route in ("one_device", "sharded"):
            leaves = [h.detach().requires_grad_(True)] + [
                params[n].detach().requires_grad_(True) for n in names]
            p = dict(zip(names, leaves[1:]))
            _reset_gmm_counts()
            if route == "sharded":
                stats = {}
                y, aux = moe._dropless_mlp_sharded(
                    leaves[0], p, top_k=k, quota_factor=1.0, mesh=mesh, rules=rules, e=e,
                    stats=stats)
            else:
                experts, _, gates, _, (me, ce) = moe._top_k_gating(
                    leaves[0].float() @ p["router"], k, s + 1, need_slots=False)
                y = moe._dropless_mlp(leaves[0], p, experts, gates, e)
                aux = e * (me * ce).sum()
                stats = dict(experts=experts)
            grads = torch.autograd.grad((y.float() * dy.float()).sum() + aux, leaves)
            torch.cuda.synchronize()
            out[route] = (y.detach(), aux.item(), grads, stats, _gmm_counts())
        (yp, ap, gp, sp, cp), (ys, as_, gs, ss, cs) = out["one_device"], out["sharded"]
        if not torch.equal(ss["experts"], sp["experts"]) or not bool(ss["kept"].all()):
            raise AssertionError(f"EP body layer {li}: routing differs or an entry dropped")
        groups_p = moe._counts(sp["experts"].reshape(-1), e)
        groups_s = moe._counts(ss["experts"].reshape(-1)[ss["kept"].reshape(-1)], e)
        if not torch.equal(groups_p, groups_s):
            raise AssertionError(f"EP body layer {li}: expert group sizes differ")
        errs = {"y": _rel(ys, yp), "aux": abs(as_ - ap) / abs(ap)}
        for nm, a, b in zip(("h",) + names, gs, gp):
            errs["d" + nm] = _rel(a, b)
        if max(errs.values()) > GRAD_TOL or not all(c > 0 for c in cs[:3]) or cs != cp:
            raise AssertionError(f"EP body layer {li}: errors {errs}, launches K5/K6/K7/K8 "
                                 f"sharded {cs} vs the one-device route {cp}")
        counts = tuple(a + b for a, b in zip(counts, cs))
        want_counts = tuple(a + b for a, b in zip(want_counts, cp))
        layers.append(dict(errors=errs, launches=list(cs), group_sizes=groups_s.tolist()))
        for nm, v in errs.items():
            worst[nm] = max(worst.get(nm, 0.0), v)
        del params, h, dy, out, gp, gs
    print(f"ep body: _dropless_mlp_sharded on a one-rank expert group, Mixtral widths, "
          f"{config.n_layers} layers of S={s}: routing and group sizes exact, nothing "
          f"dropped; worst rel errors " + ", ".join(f"{n} {v:.2e}" for n, v in worst.items())
          + f" (tol {GRAD_TOL}); launches K5/K6/K7/K8 {counts} (one-device route "
          f"{want_counts})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=layers, worst=worst, launches=list(counts))


def phase_gang_preemption():
    """11c: a subprocess trainer in a one-rank group (bench-1b, sharded
    checkpoints) SIGTERMed after its first checkpoint, then resumed."""
    ckpt = os.path.join(WORK, "ckpt-gang-1b")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = [sys.executable, "-m", "kubedl_tpu_torch.train.trainer", "--model", "bench-1b",
            "--batch", "4", "--seq-len", "512", "--log-every", "1000",
            "--checkpoint-path", ckpt, "--checkpoint-interval", "5", "--checkpoint-keep", "1"]
    root = os.path.dirname(os.path.abspath(__file__))

    def env():
        return dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                    KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
                    KUBEDL_NUM_PROCESSES="1", KUBEDL_PROCESS_ID="0", KUBEDL_MESH="data=1")

    proc = subprocess.Popen(argv + ["--steps", "1000"], cwd=root, env=env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while _latest_ckpt(ckpt) is None and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        if proc.poll() is not None or _latest_ckpt(ckpt) is None:
            raise AssertionError(f"bench-1b gang trainer ended or stalled before its first "
                                 f"checkpoint: rc={proc.poll()}")
        proc.send_signal(signal.SIGTERM)
        first_out = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    at = _latest_ckpt(ckpt)
    sharded = at is not None and os.path.isfile(os.path.join(ckpt, str(at), ".metadata"))
    if proc.returncode != 113 or not sharded or "preempted: checkpoint saved" not in first_out \
            or "devices=1" not in first_out:
        raise AssertionError(f"gang SIGTERM: rc={proc.returncode} (expected 113), sharded "
                             f"checkpoint {at} {sharded}:\n{first_out[-2000:]}")
    rerun = subprocess.run(argv + ["--steps", str(at + 2)], cwd=root, env=env(),
                           capture_output=True, text=True, timeout=600)
    if rerun.returncode != 0 or f"restored checkpoint at step {at}" not in rerun.stdout \
            or _latest_ckpt(ckpt) != at + 2:
        raise AssertionError(f"gang resume: rc={rerun.returncode}, latest "
                             f"{_latest_ckpt(ckpt)}:\n{rerun.stdout[-2000:]}{rerun.stderr[-2000:]}")
    print(f"gang preemption: bench-1b trainer in a one-rank NCCL group SIGTERMed, exit 113 "
          f"with a sharded checkpoint at step {at}; rerun restored step {at}, exit 0, "
          f"final checkpoint at step {at + 2}", flush=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(preempted_at=at)

def _drive_engine(engine, prompts, dup):
    """Phase 4's traffic on a ServingEngine, driven as the server's pump
    drives it (step_block(8)): every prompt at once, then `dup` twice.
    Counts the flash launches of this run alone."""
    from kubedl_tpu_torch.ops.flash_attention import flash_attention

    flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_tick = []  # decode seconds a tick of each step_block that ticked
    reqs = []
    for wave in (prompts, [dup, dup]):
        batch = [engine.submit(p, SERVE_NEW) for p in wave]
        reqs += batch
        while not all(r.done for r in batch):
            ticks, dec = engine._ticks, engine._decode_time
            engine.step_block(8)
            if engine._ticks > ticks:
                per_tick.append((engine._decode_time - dec) / (engine._ticks - ticks))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash_attention.launches
    st = engine.stats()
    prompt_tokens = sum(len(p) for p in prompts) + 2 * len(dup)
    return dict(tokens=[r.tokens for r in reqs], errors=[r.error for r in reqs],
                launches=launches, wall_s=wall_s, ticks=st["ticks"],
                tick_ms_median=statistics.median(per_tick) * 1e3,
                decode_ms_per_tick=st["decode_time_s"] / st["ticks"] * 1e3,
                prefill_tok_s=prompt_tokens / st["prefill_time_s"],
                kv_cache_bytes=st["kv_cache_bytes"],
                cache_dtypes=sorted({str(t.dtype) for name in ("k", "v")
                                     for t in engine.cache[name]}))


TP_TURNS = ("one_device", "mesh", "int8_kv", "int8_kv", "mesh", "one_device")


def phase_tp_serving():
    """12: Llama-7B on the serving engine through the sharded decode on a
    one-device mesh (a) and with the int8 KV cache (b), in turns with the
    one-device bf16-cache engine on the same parameters and traffic."""
    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, shard_tree

    _one_rank_group()
    config, rules = llama.LlamaConfig.llama_7b(), ShardingRules()
    mesh = build_mesh({"tensor": 1}, device_type="cuda")
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    sharded = shard_tree(params, mesh, llama.param_specs(config, rules))
    kinds = {"one_device": (params, {}), "mesh": (sharded, dict(mesh=mesh, rules=rules)),
             "int8_kv": (params, dict(kv_dtype="int8"))}
    rng = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()
               for n in SERVE_LENGTHS]
    dup = prompts[2]
    turns = {}
    for label in TP_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tree, kw = kinds[label]
        engine = ServingEngine(tree, config, slots=8, max_len=1024, **kw)
        out = _drive_engine(engine, prompts, dup)
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del engine
        turns.setdefault(label, []).append(out)
    del params, sharded, kinds
    ref = turns["one_device"][0]
    for label, runs in turns.items():
        for run in runs:
            bad = [(n, e, len(t)) for n, e, t in zip(list(SERVE_LENGTHS) + [len(dup)] * 2,
                                                     run["errors"], run["tokens"])
                   if e or len(t) != SERVE_NEW or not all(0 <= x < 32000 for x in t)]
            if bad:
                raise AssertionError(f"12 {label}: failed requests (prompt, error, tokens) {bad}")
            if run["tokens"][-1] != run["tokens"][-2]:
                raise AssertionError(f"12 {label}: one prompt sent twice gave different tokens")
            if run["launches"] < config.n_layers:
                raise AssertionError(f"12 {label}: flash launched {run['launches']} times")
            if label != "int8_kv":  # 12a: bit for bit, the same launches
                if run["tokens"] != ref["tokens"] or run["launches"] != ref["launches"]:
                    raise AssertionError(
                        f"12a {label}: tokens equal {run['tokens'] == ref['tokens']}, "
                        f"launches {run['launches']} vs {ref['launches']}")
                if run["cache_dtypes"] != ["torch.bfloat16"]:
                    raise AssertionError(f"12a {label}: cache {run['cache_dtypes']}")
            else:  # 12b
                if run["cache_dtypes"] != ["torch.int8"]:
                    raise AssertionError(f"12b: the int8 engine's cache is {run['cache_dtypes']}")
                if run["kv_cache_bytes"] > 0.51 * ref["kv_cache_bytes"]:
                    raise AssertionError(f"12b: cache {run['kv_cache_bytes']} bytes against "
                                         f"bf16's {ref['kv_cache_bytes']}")
                firsts = [t[0] for t in run["tokens"]]
                if firsts != [t[0] for t in ref["tokens"]]:
                    raise AssertionError("12b: a first token differs from the bf16 run's "
                                         "(prefill does not read the cache)")

    def mean(label, key):
        return statistics.mean(r[key] for r in turns[label])

    tick_ratio = mean("mesh", "tick_ms_median") / mean("one_device", "tick_ms_median")
    i8 = turns["int8_kv"][0]
    agree = sum(a == b for x, y in zip(i8["tokens"], ref["tokens"]) for a, b in zip(x, y))
    agree_share = agree / sum(len(t) for t in ref["tokens"])
    bytes_ratio = i8["kv_cache_bytes"] / ref["kv_cache_bytes"]
    for label, runs in turns.items():
        print(f"tp serving {label}: " + "; ".join(
            f"decode {r['decode_ms_per_tick']:.2f} ms/tick (median {r['tick_ms_median']:.2f}, "
            f"{r['ticks']} ticks), prefill {r['prefill_tok_s']:.0f} prompt tok/s, "
            f"peak {r['peak_gb']:.2f} GB, cache {r['kv_cache_bytes'] / 1e9:.3f} GB "
            f"{r['cache_dtypes']}, flash launches {r['launches']}" for r in runs), flush=True)
    print(f"tp serving: 12a mesh tokens equal the one-device engine's bit for bit, median "
          f"tick ratio mesh/one-device {tick_ratio:.4f}; 12b int8 cache "
          f"{i8['kv_cache_bytes'] / 1e9:.3f} GB vs bf16 {ref['kv_cache_bytes'] / 1e9:.3f} GB "
          f"(ratio {bytes_ratio:.4f}), first tokens equal, greedy tokens agreeing with the "
          f"bf16 run {agree}/{sum(len(t) for t in ref['tokens'])} ({agree_share:.4f})",
          flush=True)
    return dict(turns=turns, order=list(TP_TURNS), tick_ratio=tick_ratio,
                bytes_ratio=bytes_ratio, agree_share=agree_share,
                launches_mesh=turns["mesh"][0]["launches"],
                launches_int8=turns["int8_kv"][0]["launches"])

# -- the MoE slice: grouped matmul kernels, gradients, training, int8 serving --


def _mixtral(n_layers):
    """Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json:
    d_model 4096, 32 q / 8 kv heads, d_ff 14336, 8 experts top 2, vocab
    32000, rope_theta 1e6, rms_eps 1e-5, bf16) at n_layers of its 32."""
    from kubedl_tpu_torch.models import llama

    return llama.LlamaConfig(vocab_size=32000, d_model=4096, n_layers=n_layers, n_heads=32,
                             n_kv_heads=8, d_ff=14336, max_seq_len=32768, rope_theta=1e6,
                             rms_eps=1e-5, n_experts=8, expert_top_k=2)


def _gmm_counts():
    from kubedl_tpu_torch.ops import gmm as G

    return (G.gmm_swiglu.launches, G.gmm.launches, G.tgmm.launches, G.gmm_scaled.launches)


def _reset_gmm_counts():
    from kubedl_tpu_torch.ops import gmm as G

    G.gmm_swiglu.launches = G.gmm.launches = G.tgmm.launches = G.gmm_scaled.launches = 0


@contextlib.contextmanager
def _moe_through_plain(routing):
    """For the length of the block, models/moe.py's grouped products are the
    plain versions (autograd of plain PyTorch) and its routing replays the
    expert choices of the kernel run (`routing`, recorded by `_recorded`):
    the reference side of phases 8 and 10. bf16 rounding that differs
    between the two sides would otherwise flip a near-tie and send a token
    to another expert, which is a different computation. The package itself
    has no such switch. Yields the number of replayed choices that the
    plain side's own routing would have made differently."""
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.ops import gmm as G

    saved = moe.gmm, moe.gmm_scaled, moe.gmm_swiglu, moe._top_k_gating
    calls = iter(routing)
    flips = [0]

    def gating(gate_logits, top_k, capacity, need_slots=True):
        if need_slots:
            raise AssertionError("routing replay covers the dropless route only")
        own = saved[3](gate_logits, top_k, capacity, need_slots=False)
        experts = next(calls)
        flips[0] += int((own[0] != experts).sum())
        probs = torch.softmax(gate_logits, dim=-1)
        gates = probs.gather(1, experts.T.long()).T.float()
        weights = gates / gates.sum(dim=0, keepdim=True).clamp_min(1e-9)
        s = gate_logits.shape[0]
        ce = torch.zeros_like(own[4][1]).index_add_(
            0, experts[0].long(), torch.full((s,), 1.0 / s, device=gate_logits.device))
        return experts, own[1], weights, own[3], (probs.mean(dim=0), ce)

    moe.gmm = lambda lhs, rhs, te, row_tile=G.TILE_M: G.gmm_plain(lhs, rhs, te)
    moe.gmm_scaled = lambda lhs, rhs, te, s, row_tile=G.TILE_M: G.gmm_scaled_plain(
        lhs, rhs, te, s)
    moe.gmm_swiglu = lambda lhs, w1, w3, te, s1, s3, row_tile=G.TILE_M: G.gmm_swiglu_plain(
        lhs, w1, w3, te, s1, s3)
    moe._top_k_gating = gating
    try:
        yield flips
    finally:
        moe.gmm, moe.gmm_scaled, moe.gmm_swiglu, moe._top_k_gating = saved
        if next(calls, None) is not None:
            raise AssertionError("the plain run routed fewer times than the kernel run")


@contextlib.contextmanager
def _recorded(routing):
    """Append the expert choices of every routing call in the block to
    `routing` (the kernel side of phases 8 and 10)."""
    from kubedl_tpu_torch.models import moe

    real = moe._top_k_gating

    def gating(*args, **kwargs):
        out = real(*args, **kwargs)
        routing.append(out[0].detach().clone())
        return out

    moe._top_k_gating = gating
    try:
        yield
    finally:
        moe._top_k_gating = real


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _library(fn):
    """(ms, None) for one PyTorch call, or (None, why) when this torch has
    no such call for these layouts: the yardstick only, never the port."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return _time_ms(fn), None


def phase_gmm_kernels():
    """K5-K8 against their plain versions at Mixtral widths; returns
    {shape: {kernel case: numbers}}."""
    from kubedl_tpu_torch.models import moe
    from kubedl_tpu_torch.ops import gmm as G

    d, ff, e = 4096, 14336, 8
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def scales(n, fan_in):  # ~max|w| / 127 of a trunc-normal / sqrt(fan_in) column
        return (torch.rand((e, n), generator=gen, device="cuda") * 0.5 + 0.75) * (
            2 * fan_in ** -0.5 / 127)

    w1, w3, w2 = randn(e, d, ff, scale=d ** -0.5), randn(e, d, ff, scale=d ** -0.5), \
        randn(e, ff, d, scale=ff ** -0.5)
    q1, q3, q2 = codes(e, d, ff), codes(e, d, ff), codes(e, ff, d)
    s1, s3, s2 = scales(ff, d), scales(ff, d), scales(d, ff)
    ones = torch.ones((e, ff), device="cuda")
    results = {}
    for name, (t, live) in GMM_SHAPES.items():
        logits = torch.randn((t, e), generator=gen, device="cuda")
        logits[:, live:] = -1e4
        experts = moe._top_k_gating(logits, 2, t + 1, need_slots=False)[0]
        eid = experts.reshape(-1)
        order, dest, _, te, m_pad = moe._dispatch_plan(eid, e)
        r, tile = eid.numel(), m_pad // te.numel()
        group = moe._counts(eid, e)
        owned = int((group > 0).sum())
        offs = torch.cumsum((group + tile - 1) // tile * tile, 0).to(torch.int32)
        src_rows = torch.arange(t, device="cuda").repeat(2)

        def routed(width, scale=1.0):  # real rows in the padded layout, zero padding
            return moe._permute(randn(t, width, scale=scale), src_rows, order, dest, m_pad)

        x = routed(d)
        h = G.gmm_swiglu_cuda(x, w1, w3, te, ones, ones)
        dy, dg = routed(d), routed(ff, 0.1)
        wb, sb = 2 * owned * d * ff, 4 * owned * ff  # one stack's bytes (bf16), scales
        io = 2 * r * (d + ff)                        # the routed rows in and out
        bf16 = torch.bfloat16
        cases = {  # name: (kernel, plain, library or None, tolerance, flop, bytes)
            "gmm_swiglu": (lambda: G.gmm_swiglu_cuda(x, w1, w3, te, ones, ones),
                           lambda: G.gmm_swiglu_plain(x, w1, w3, te, ones, ones),
                           None, GMM_TOL, 4 * r * d * ff, 2 * wb + io),
            "gmm_swiglu_int8": (lambda: G.gmm_swiglu_cuda(x, q1, q3, te, s1, s3),
                                lambda: G.gmm_swiglu_plain(x, q1, q3, te, s1, s3),
                                None, GMM_TOL, 4 * r * d * ff, wb + 2 * sb + io),
            "gmm": (lambda: G.gmm_cuda(h, w2, te), lambda: G.gmm_plain(h, w2, te),
                    lambda: torch._grouped_mm(h, w2, offs=offs), GMM_TOL,
                    2 * r * d * ff, wb + io),
            "gmm_T": (lambda: G.gmm_cuda(dy, w2.transpose(1, 2), te),
                      lambda: G.gmm_plain(dy, w2.transpose(1, 2), te),
                      lambda: torch._grouped_mm(dy, w2.transpose(1, 2), offs=offs), GMM_TOL,
                      2 * r * d * ff, wb + io),
            "gmm_scaled": (lambda: G.gmm_cuda(h, q2, te, s2),
                           lambda: G.gmm_scaled_plain(h, q2, te, s2), None, GMM_TOL,
                           2 * r * d * ff, wb // 2 + 4 * owned * d + io),
            "gmm_scaled_bf16": (lambda: G.gmm_cuda(h, w2, te, s2),
                                lambda: G.gmm_scaled_plain(h, w2, te, s2), None, GMM_TOL,
                                2 * r * d * ff, wb + 4 * owned * d + io),
            "tgmm": (lambda: G.tgmm_cuda(x, dg, te, e), lambda: G.tgmm_plain(x, dg, te, e),
                     lambda: torch._grouped_mm(x.t(), dg, offs=offs), TGMM_TOL,
                     2 * r * d * ff, io + 4 * e * d * ff),
            # the training step's K7: the weights' dtype, one rounding of the f32 sum
            "tgmm_bf16": (lambda: G.tgmm_cuda(x, dg, te, e, out_dtype=bf16),
                          lambda: G.tgmm_plain(x, dg, te, e, out_dtype=bf16),
                          lambda: torch._grouped_mm(x.t(), dg, offs=offs), GMM_TOL,
                          2 * r * d * ff, io + 2 * e * d * ff),
        }
        unrouted = [i for i in range(e) if int(group[i]) == 0]
        shape = {}
        for kname, (kern, plain, lib, tol, flop, nbytes) in cases.items():
            got = kern()
            same, zero = torch.equal(got, kern()), True
            if kname.startswith("tgmm"):
                zero = all(got[i].abs().max().item() == 0.0 for i in unrouted)
            torch.cuda.synchronize()
            ref = plain()
            err, abs_err = _rel(got, ref), (got.float() - ref.float()).abs().max().item()
            finite = bool(torch.isfinite(got.float()).all())
            del got, ref
            kernel_ms = _time_ms(kern)
            plain_ms = _time_ms(plain, warmup=1, iters=3)
            library_ms, why = (None, "no single PyTorch call computes it") if lib is None \
                else _library(lib)
            if kname == "tgmm" and library_ms is not None:
                why = "bf16 output: torch._grouped_mm refuses an f32 out_dtype here"
            elif kname == "tgmm_bf16" and library_ms is not None:
                why = "like for like: bf16 output"
            bound_ms, bound_by = _bound(flop, nbytes)
            n = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                     library_note=why, bound_ms=bound_ms, bound_by=bound_by,
                     share_of_bound=bound_ms / kernel_ms, tflops=flop / kernel_ms / 1e9,
                     rel_err=err, max_abs_err=abs_err, deterministic=same,
                     unrouted_zero=zero, routed_rows=r,
                     m_pad=m_pad, row_tile=tile, executed_share=m_pad / r,
                     experts_owning_rows=owned)
            shape[kname] = n
            lib_s = f"{library_ms:.4f}" if library_ms is not None else f"n/a ({why})"
            print(f"gmm {name} {kname}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.3f} "
                  f"library_ms={lib_s} bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"share={n['share_of_bound']:.3f} tflops={n['tflops']:.1f} rel_err={err:.2e} "
                  f"R={r} m_pad={m_pad} tile={tile} m_pad/R={m_pad / r:.3f} owned={owned} "
                  f"deterministic={same}"
                  + (f" unrouted_zero={zero} ({len(unrouted)} unrouted)"
                     if kname.startswith("tgmm") else "")
                  + (f" tile_n={G.sm90_tile_n(m_pad, d, G.EPI_SCALE, G._sms(x.device))}"
                     if kname.startswith("gmm_scaled") else ""), flush=True)
            if not finite or not same or not zero or err > tol:
                raise AssertionError(f"{kname} disagrees with its plain version at {name}: "
                                     f"finite={finite} deterministic={same} "
                                     f"unrouted_zero={zero} rel_err={err} (tol {tol})")
        results[name] = shape
        del x, h, dy, dg
    del w1, w3, w2, q1, q3, q2
    gc.collect()
    torch.cuda.empty_cache()
    return results


def _leaf_names(tree, prefix=""):
    """Dotted names in llama.tree_leaves order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_names(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1]


def phase_moe_grads():
    """loss_fn and every gradient of a 2-layer Mixtral-width model, b=2,
    S=1024, through the gmm kernels against the plain versions."""
    from kubedl_tpu_torch.models import llama

    config = _mixtral(2)
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.randint(0, config.vocab_size, (2, 1025), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(9))
    out, routing, flips = {}, [], [0]
    for label in ("kernel", "plain"):
        tree = llama.tree_map(lambda x: x.detach().requires_grad_(True), params)
        leaves = list(llama.tree_leaves(tree))
        _reset_gmm_counts()
        with _recorded(routing) if label == "kernel" else _moe_through_plain(routing) as f:
            loss = llama.loss_fn(tree, tokens, config)
            grads = torch.autograd.grad(loss, leaves)
        flips = f if label == "plain" else flips
        torch.cuda.synchronize()
        out[label] = (loss.item(), grads, _gmm_counts())
        del tree, leaves, loss
    n = config.n_layers
    (lk, gk, ck), (lp, gp, cp) = out["kernel"], out["plain"]
    # per layer under full remat: forward K5 + K6 (w2), again in the
    # recompute; w2's backward K6 (dlhs) + K7; the SwiGLU's backward 2 K6
    # recomputing gate and up, 2 K6 for dlhs, 2 K7 for dw1 and dw3
    want = (2 * n, 7 * n, 3 * n, 0)
    if ck != want or cp != (0, 0, 0, 0):
        raise AssertionError(f"MoE gradient launches (K5, K6, K7, K8): kernel path {ck} "
                             f"(expected {want}), plain path {cp}")
    errs = {}
    for nm, a, b in zip(_leaf_names(params), gk, gp):
        if a.dtype != b.dtype or not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"gradient {nm}: dtype {a.dtype} vs {b.dtype} or not finite")
        errs[nm] = _rel(a, b)
    worst = max(errs, key=errs.get)
    loss_rel = abs(lk - lp) / abs(lp)
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    print(f"moe grads: Mixtral width, 2 layers, b=2 S=1024: loss kernel {lk:.6f} plain "
          f"{lp:.6f} (rel {loss_rel:.2e}); worst gradient {worst} rel {errs[worst]:.3e} over "
          f"{len(errs)} leaves (tol {GRAD_TOL}; next: "
          + ", ".join(f"{k} {v:.2e}" for k, v in top[1:]) + f"); launches K5/K6/K7/K8 {ck}; "
          f"{len(routing)} routing calls replayed, {flips[0]} of "
          f"{sum(r.numel() for r in routing)} choices a near-tie flipped", flush=True)
    if loss_rel > 1e-2 or errs[worst] > GRAD_TOL:
        raise AssertionError("MoE gradients through the kernels disagree with the plain path")
    del params, out, gk, gp
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_kernel=lk, loss_plain=lp, loss_rel=loss_rel, grad_rel_err=errs,
                launches=list(ck), routing_flips=flips[0])


def phase_moe_train():
    """Mixtral width, 4 of 32 layers: 6 make_train_step steps, b=4, rows of
    1024 tokens, AdamW with clip 1.0 (the trainer's optimizer)."""
    from torch.profiler import ProfilerActivity, profile

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    steps, batch, seq = 6, 4, 1024
    config = _mixtral(4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = llama.init(config, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = llama.param_count(params)
    expert = sum(layer["moe"][w].numel() for layer in params["layers"]
                 for w in ("w1", "w3", "w2"))
    active = n_params - expert * (1 - config.expert_top_k / config.n_experts)
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    init_state, train_step = make_train_step(lambda p, b: llama.loss_fn(p, b, config), tx)
    state = init_state(params)
    del params
    gen = torch.Generator(device="cuda").manual_seed(10)
    batches = [torch.randint(0, config.vocab_size, (batch, seq), generator=gen, device="cuda",
                             dtype=torch.int32) for _ in range(steps + 1)]
    _reset_gmm_counts()
    _reset_counts()
    losses, gnorms, times = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i])
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        times.append(time.perf_counter() - t0)
    counts, flash = _gmm_counts(), _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = config.n_layers
    want = (2 * n * steps, 7 * n * steps, 3 * n * steps, 0)
    if counts != want:
        raise AssertionError(f"MoE train launches (K5, K6, K7, K8) {counts}, expected {want}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"MoE train: non-finite loss or grad_norm {losses} {gnorms}")
    if abs(losses[0] - math.log(config.vocab_size)) > 1.5:
        raise AssertionError(f"MoE first loss {losses[0]} not within 1.5 of ln 32000")
    step_s = statistics.median(times[1:])
    tokens = batch * (seq - 1)
    attn_flop = 12 * n * batch * config.n_heads * config.head_dim * \
        _attended_pairs(seq - 1, True, None)
    model_flop = 6 * active * tokens + attn_flop
    mfu = model_flop / (step_s * PEAK_BF16_FLOPS)
    profile_dir = os.path.join(WORK, "profile-moe")
    shutil.rmtree(profile_dir, ignore_errors=True)
    os.makedirs(profile_dir)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[steps])
        metrics["loss"].item()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(profile_dir, "step.json")
    prof.export_chrome_trace(trace)
    prof_numbers = _kernel_profile(trace, wall_ms)
    share = "not measured" if prof_numbers["idle_share"] is None else \
        f"{prof_numbers['idle_share']:.3f}"
    print(f"moe train: Mixtral width, {n} layers ({n_params / 1e9:.3f}B params, "
          f"{active / 1e9:.3f}B active), {steps} steps b={batch} seq={seq}; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}", flush=True)
    print(f"moe train: step {step_s * 1e3:.1f} ms (median of steps 2-{steps}; first "
          f"{times[0] * 1e3:.1f} ms), {tokens / step_s:.0f} tok/s, active-parameter FLOP "
          f"share (6*N_active*T + attention = {model_flop:.3e} over step x 989e12) {mfu:.3f}; "
          f"peak allocated {peak_gb:.2f} GB; launches K5/K6/K7/K8 {counts}, flash "
          f"fwd/dq/dkv {flash}", flush=True)
    print(f"profile moe train step: wall {prof_numbers['wall_ms']:.1f} ms (profiled), device "
          f"busy {prof_numbers['device_busy_ms']:.1f} ms, idle share {share}, "
          f"{prof_numbers['kernels']} kernels; top: " + "; ".join(
              f"{nm} {ms:.2f} ms" for nm, ms in prof_numbers["top"]), flush=True)
    print("profile moe train step by kind: " + "; ".join(
        f"{k} {ms:.1f} ms" for k, ms in prof_numbers["groups"].items()), flush=True)
    print(f"moe train summary: step {step_s * 1e3:.1f} ms, gmm kernels "
          f"{prof_numbers['groups']['gmm kernels']:.1f} ms of "
          f"{prof_numbers['device_busy_ms']:.1f} ms device time in the profiled step",
          flush=True)
    del state, batches, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(n_params=n_params, active_params=active, losses=losses, grad_norms=gnorms,
                step_ms=step_s * 1e3, first_step_ms=times[0] * 1e3, tok_s=tokens / step_s,
                model_flop_per_step=model_flop, active_flop_share=mfu, peak_gb=peak_gb,
                launches=list(counts), flash_launches=list(flash), profile=prof_numbers)


def _int8_tree(config, gen):
    """The int8 tree of a fresh init built layer by layer on the card: each
    layer is drawn in bf16 and quantized before the next is drawn, so the
    bf16 model never exists whole."""
    from kubedl_tpu_torch.models import llama, quant

    params = quant.quantize_params(llama.init(dataclasses.replace(config, n_layers=0), gen,
                                              device="cuda"))
    for _ in range(config.n_layers):
        params["layers"].append(quant.quantize_layer(llama.init_layer(config, gen, "cuda")))
        torch.cuda.empty_cache()
    return params


def phase_moe_serve():
    """Mixtral-8x7B, int8, full width and depth, on the serving engine."""
    from kubedl_tpu_torch.models import decode, quant
    from kubedl_tpu_torch.models.serving import ServingEngine

    gen = torch.Generator(device="cuda").manual_seed(11)
    # a 2-layer int8 prefill through the kernels against the plain versions
    cfg2 = _mixtral(2)
    small = _int8_tree(cfg2, gen)
    prompt = torch.randint(1, cfg2.vocab_size, (2, 512), generator=gen, device="cuda",
                           dtype=torch.int32)
    got, routing = {}, []
    for label in ("kernel", "plain"):
        _reset_gmm_counts()
        cache = decode.init_kv_cache(cfg2, 2, 512, uniform=True, device="cuda")
        with _recorded(routing) if label == "kernel" else _moe_through_plain(routing):
            logits, _ = decode.prefill(small, prompt, cache, cfg2)
        torch.cuda.synchronize()
        got[label] = (logits.float(), _gmm_counts())
        del cache
    (lk, ck), (lp, cp) = got["kernel"], got["plain"]
    prefill_rel = _rel(lk, lp)
    print(f"moe serve: 2-layer int8 prefill of 2 x 512 tokens, last-token logits through the "
          f"kernels vs plain: rel {prefill_rel:.3e} (tol {GRAD_TOL}); launches K5/K6/K7/K8 "
          f"{ck} vs {cp}", flush=True)
    if ck != (2, 0, 0, 2) or cp != (0, 0, 0, 0) or prefill_rel > GRAD_TOL \
            or not bool(torch.isfinite(lk).all()):
        raise AssertionError("int8 MoE prefill through the kernels disagrees with the plain path")
    # a decode step of the 2-layer tree with any host sync made an error:
    # routing, dispatch and the kernels must not stall a tick on the host
    cache = decode.init_kv_cache(cfg2, 2, 520, device="cuda")
    _, cache = decode.prefill(small, prompt, cache, cfg2)
    tok = lk.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_logits, _ = decode.decode_step(small, tok, cache, cfg2, check=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError("non-finite int8 MoE decode-step logits")
    print("moe serve: a 2-layer int8 decode step ran with host syncs made errors "
          "(torch.cuda.set_sync_debug_mode): none", flush=True)
    del small, got, lk, lp, cache, step_logits
    gc.collect()
    torch.cuda.empty_cache()

    config = _mixtral(32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _int8_tree(config, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tree_gb = quant.tree_bytes(params) / 1e9
    engine = ServingEngine(params, config, slots=8, max_len=1024)
    rng = torch.Generator().manual_seed(12)
    prompts = [torch.randint(1, config.vocab_size, (n,), generator=rng).tolist()
               for n in MOE_SERVE_LENGTHS]
    dup = prompts[2]
    _reset_gmm_counts()
    _reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, SERVE_NEW) for p in prompts]
    while engine.has_pending():
        engine.step_block()
    pair = [engine.submit(dup, SERVE_NEW) for _ in range(2)]
    while engine.has_pending():
        engine.step_block()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts, flash = _gmm_counts(), _counts()
    stats = engine.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in reqs + pair:
        if r.error or len(r.tokens) != SERVE_NEW or not all(0 <= x < 32000 for x in r.tokens):
            raise AssertionError(f"request of {len(r.prompt)} prompt tokens: error "
                                 f"{r.error}, {len(r.tokens)} tokens")
    if pair[0].tokens != pair[1].tokens:
        raise AssertionError("one prompt sent twice gave different tokens")
    forwards = stats["prefill_batches"] + stats["ticks"]
    if counts != (32 * forwards, 0, 0, 32 * forwards):
        raise AssertionError(f"int8 serving launches (K5, K6, K7, K8) {counts}; expected K5 = "
                             f"K8 = 32 layers x {forwards} forwards and no K6, K7")
    if flash[0] < 32 * stats["prefill_batches"] or flash[1:] != (0, 0):
        raise AssertionError(f"int8 serving flash launches (fwd, dq, dkv) {flash} for "
                             f"{stats['prefill_batches']} prefill dispatches x 32 layers")
    n_req = len(reqs) + len(pair)
    prompt_tokens = sum(MOE_SERVE_LENGTHS) + 2 * len(dup)
    numbers = dict(
        layers=config.n_layers, tree_gb=tree_gb, init_s=init_s, requests=n_req,
        wall_s=wall_s, prompt_tokens=prompt_tokens, tokens_out=stats["tokens_out"],
        prefill_batches=stats["prefill_batches"], ticks=stats["ticks"],
        prefill_time_s=stats["prefill_time_s"], decode_time_s=stats["decode_time_s"],
        prefill_tok_s=prompt_tokens / stats["prefill_time_s"],
        decode_tok_s=(stats["tokens_out"] - n_req) / stats["decode_time_s"],
        peak_gb=peak_gb, launches=list(counts), flash_launches=flash[0],
        prefill_rel_err=prefill_rel)
    print(f"moe serve: Mixtral-8x7B int8, 32 layers, tree {tree_gb:.2f} GB built in "
          f"{init_s:.1f} s; {n_req} requests ok in {wall_s:.2f} s; prefill "
          f"{stats['prefill_batches']} dispatches {stats['prefill_time_s']:.3f} s "
          f"({numbers['prefill_tok_s']:.0f} prompt tok/s); decode {stats['decode_time_s']:.3f} s "
          f"over {stats['ticks']} ticks ({stats['decode_time_s'] / max(stats['ticks'], 1) * 1e3:.1f}"
          f" ms/tick, {numbers['decode_tok_s']:.1f} tok/s); launches K5/K6/K7/K8 {counts}, "
          f"flash fwd {flash[0]}; "
          f"peak allocated {peak_gb:.2f} GB", flush=True)
    numbers["profile"] = _profile_engine(engine)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


def _phase(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _free(after):
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"memory: {left / 1e9:.3f} GB allocated after {after}", flush=True)
    if left >= 1e9:
        raise AssertionError(f"{left / 1e9:.2f} GB still allocated after {after}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="also write all of the run's numbers to this JSON file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, smi, build = _phase("1 device and build", phase_device)
    kernels = _phase("2 flash forward kernel", phase_kernels)
    bwd = _phase("2b flash backward kernels", phase_bwd_kernels)
    gmm = _phase("2c grouped matmul kernels", phase_gmm_kernels)
    model = _phase("3 7B prefill", phase_model)
    serving, launches = _phase("4 7B serving over HTTP", phase_serve)
    _free("serving")
    grads = _phase("5 7B-width gradients", phase_grads)
    _free("gradients")
    train = _phase("6 7B trainer", phase_train, model["n_params"])
    options = _phase("7 trainer options and preemption", phase_options)
    _free("training")
    moe_grads = _phase("8 MoE gradients", phase_moe_grads)
    _free("MoE gradients")
    moe_train = _phase("9 MoE training", phase_moe_train)
    _free("MoE training")
    moe_serve = _phase("10 MoE int8 serving", phase_moe_serve)
    _free("MoE serving")
    sharded = _phase("11a sharded 7B step", phase_sharded_step, train)
    _free("the sharded step")
    ep = _phase("11b expert-parallel body", phase_ep_body)
    _free("the expert-parallel body")
    gang = _phase("11c gang preemption", phase_gang_preemption)
    _free("gang preemption")
    tp = _phase("12 tensor-parallel serving and the int8 KV cache", phase_tp_serving)
    _free("tensor-parallel serving")
    import torch.distributed as dist

    dist.destroy_process_group()
    main_k, main_b = kernels[MAIN_SHAPE], bwd[MAIN_BWD_SHAPE]
    bwd_rows = []
    for part, gname, line in (("dq", ("dq",), 291), ("dkv", ("dk", "dv"), 336)):
        bwd_rows.append({
            "name": f"flash_bwd_{part}",
            "route": "cuda",
            "source": f"kubedl_tpu_torch/ops/csrc/{main_b['source']}",
            "replaces": f"kubedl_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][1 if part == "dq" else 2],
            "max_abs_err": max(r["errors"][g + "_abs"] for r in bwd.values()
                               if r["source"] == main_b["source"] for g in gname),
            "ms": main_b[f"{part}_ms"],
            "plain_ms": main_b["plain_ms"],
            "bound_ms": main_b[f"{part}_bound_ms"],
            "bound_by": main_b[f"{part}_bound_by"],
            "library_ms": main_b["library_ms"],
        })
    # K5, K6, K7 from the MoE training run; K8 from int8 serving
    gmm_launches = {"gmm_swiglu": moe_train["launches"][0], "gmm": moe_train["launches"][1],
                    "tgmm": moe_train["launches"][2], "gmm_scaled": moe_serve["launches"][3]}
    gmm_rows = []
    for kname, line in (("gmm", 130), ("gmm_scaled", 147), ("gmm_swiglu", 170),
                        ("tgmm", 276)):
        main_g = gmm[MAIN_GMM[kname]][MAIN_CASE[kname]]
        gmm_rows.append({
            "name": kname,
            "launches_by_path": {"moe_train": moe_train["launches"][MAIN_INDEX[kname]],
                                 "ep_dropless_body": ep["launches"][MAIN_INDEX[kname]],
                                 "moe_int8_serving": moe_serve["launches"][MAIN_INDEX[kname]]},
            "route": "cuda",
            "source": "kubedl_tpu_torch/ops/csrc/gmm_sm90.cu",
            "replaces": f"kubedl_tpu/ops/gmm.py:{line}",
            "launches": gmm_launches[kname],
            "max_abs_err": max(v["max_abs_err"] for sh in gmm.values()
                               for k, v in sh.items() if k.startswith(kname)
                               and (kname != "gmm" or k in ("gmm", "gmm_T"))),
            "ms": main_g["kernel_ms"],
            "plain_ms": main_g["plain_ms"],
            "bound_ms": main_g["bound_ms"],
            "bound_by": main_g["bound_by"],
            "library_ms": main_g["library_ms"],
        })
    report = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": f"kubedl_tpu_torch/ops/csrc/{main_k['source']}",
        "replaces": "kubedl_tpu/ops/flash_attention.py:107",
        "launches": launches,
        # the same kernel on every path that runs attention at d = 128
        "launches_by_path": {"7b_serving": launches, "7b_train": train["launches"][0],
                             "moe_train": moe_train["flash_launches"][0],
                             "7b_sharded_step": sharded["launches"][0],
                             "moe_int8_serving": moe_serve["flash_launches"],
                             "7b_tp_serving": tp["launches_mesh"],
                             "7b_int8_kv_serving": tp["launches_int8"]},
        "max_abs_err": max(r["out_max_abs_err"] for r in kernels.values()),
        "ms": main_k["kernel_ms"],
        "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"],
        "bound_by": main_k["bound_by"],
        "library_ms": main_k["library_ms"],
    }] + bwd_rows + gmm_rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, build=build, kernels=kernels,
                           bwd_kernels=bwd, gmm_kernels=gmm, model=model, serving=serving,
                           grads=grads, train=train, options=options, moe_grads=moe_grads,
                           moe_train=moe_train, moe_serve=moe_serve, sharded_step=sharded,
                           ep_body=ep, gang_preemption=gang, tp_serving=tp,
                           seconds=time.perf_counter() - t_start),
                      f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
