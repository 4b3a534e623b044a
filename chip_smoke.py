"""Drive kubedl_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases, each printing its own line of numbers:
  1. device and build: the card's name and power limit, the CUDA kernels
     built from ops/csrc/ in parallel (seconds, registers, spills);
  2. each kernel against its plain PyTorch version on the card, at the
     7B prefill shapes and the variants the model can ask for (GQA,
     window, softcap, d=64, a long sequence), with kernel, plain and
     library times (CUDA events, median of 7 after 2 warm-ups) beside the
     least time the card could take;
  3. full-width, full-depth Llama-7B, fresh init on the card: one
     1000-token prefill through the kernel and through plain attention,
     last-token logits compared;
  4. the HTTP server (kubedl_tpu_torch.train.serve) in this process on a
     free port, 8 greedy requests (6 concurrent clients across buckets,
     then one batch of a prompt twice), every answer checked, launch
     counts checked against the prefill dispatches.
  2b. the backward kernels (dq, dkv) against the f32 plain backward at the
     7B training shapes and the variants (GQA, window, softcap, d=64,
     d=256, a long sequence), two launches bit-identical, with kernel,
     plain and library (scaled_dot_product_attention backward) times;
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
Then one JSON line of per-kernel numbers and, last, the device line.
`--out PATH` also writes every number of the run to PATH as JSON. Any
failure raises; the script exits non-zero and prints no result. It needs a
CUDA device and the repository beside it.
"""
import argparse
import gc
import glob
import json
import math
import os
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
GRAD_TOL = 5e-2           # phase 5, per gradient leaf (bf16 model, 2 layers)
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
    _build.build("flash_fwd", "flash_bwd")
    print(f"build: both sources in {time.perf_counter() - t0:.2f} s (parallel nvcc)",
          flush=True)
    for src in ("flash_fwd", "flash_bwd"):
        print(f"build: {src}.cu in {_build.build_seconds[src]:.2f} s -> "
              f"{_build.library_path(src)}", flush=True)
        for line in _build.ptxas_report(src).splitlines():
            print(f"build:   {line}", flush=True)
    return name, smi


def phase_kernels():
    """Kernel vs plain on the card; returns {shape name: numbers}."""
    import torch.nn.functional as F

    from kubedl_tpu_torch.ops import flash_attention as fa

    # name: (b, hq, hkv, s, d, causal, window, softcap)
    shapes = {
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
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        out_err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
        del ref, ref_lse
        kernel_ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw))
        library_ms = None
        if softcap is None:  # scaled_dot_product_attention has no softcap
            mask = None
            if window is not None:
                mask = fa._mask(s, causal, window, q.device)
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=hq != hkv))
        flops = 4 * b * hq * d * _attended_pairs(s, causal, window)
        nbytes = 2 * s * d * b * (2 * hq + 2 * hkv) + 4 * b * hq * s
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        r = dict(shape=[b, hq, hkv, s, d], causal=causal, window=window,
                 softcap=softcap, out_max_abs_err=out_err, lse_max_abs_err=lse_err,
                 kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=bound_ms,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 share_of_bound=bound_ms / kernel_ms,
                 tflops=flops / kernel_ms / 1e9)
        results[name] = r
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel {name}: kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={bound_ms:.4f} ({r['bound_by']}) "
              f"share={r['share_of_bound']:.3f} tflops={r['tflops']:.1f} "
              f"out_err={out_err:.3e} lse_err={lse_err:.3e}", flush=True)
        if not finite or out_err > OUT_TOL or lse_err > LSE_TOL:
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at {name}: "
                f"finite={finite} out_err={out_err} (tol {OUT_TOL}) "
                f"lse_err={lse_err} (tol {LSE_TOL})")
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


def phase_bwd_kernels():
    """The dq and dkv kernels against the f32 plain backward; returns
    {shape name: numbers}."""
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
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, g) for a, g in zip(again, got))
        del again
        ref = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(),
                                           lse, dout.float(), **kw)
        errs, finite = {}, True
        for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
            finite = finite and bool(torch.isfinite(g.float()).all())
            errs[gname] = ((g.float() - r).abs().max() / r.abs().max()).item()
            errs[gname + "_abs"] = (g.float() - r).abs().max().item()
        del ref, got
        launch_args, _ = fa._bwd_launch_args(q, k, v, out, lse, dout, causal, None,
                                             window, softcap)
        dq_ms = _time_ms(lambda: fa._launch_bwd("dq", launch_args["dq"]))
        dkv_ms = _time_ms(lambda: fa._launch_bwd("dkv", launch_args["dkv"]))
        wrapper_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw))
        del launch_args
        plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw),
                            iters=3)
        library_ms = None
        if softcap is None and window is None:  # no library call has these
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                      enable_gqa=hq != hkv)

            fwd_bwd = _time_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), dout))
            with torch.no_grad():
                fwd_only = _time_ms(sdpa)
            library_ms = fwd_bwd - fwd_only
        work = _bwd_bounds(b, hq, hkv, s, d, causal, window)
        r = dict(shape=[b, hq, hkv, s, d], causal=causal, window=window, softcap=softcap,
                 errors=errs, finite=finite, deterministic=same,
                 dq_ms=dq_ms, dkv_ms=dkv_ms, wrapper_ms=wrapper_ms,
                 plain_ms=plain_ms, library_ms=library_ms)
        for part in ("dq", "dkv", "bwd"):
            r[f"{part}_bound_ms"], r[f"{part}_bound_by"] = _bound(*work[part])
        r["share_of_bound"] = r["bwd_bound_ms"] / (dq_ms + dkv_ms)
        r["executed_work_share"] = 10 / 14  # 5 products a score needed, 7 run
        results[name] = r
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"bwd {name}: dq_ms={dq_ms:.4f} (bound {r['dq_bound_ms']:.4f} "
              f"{r['dq_bound_by']}) dkv_ms={dkv_ms:.4f} (bound {r['dkv_bound_ms']:.4f} "
              f"{r['dkv_bound_by']}) wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bwd_bound_ms={r['bwd_bound_ms']:.4f} "
              f"({r['bwd_bound_by']}) share={r['share_of_bound']:.3f} "
              f"rel_err dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e} "
              f"deterministic={same}", flush=True)
        if not finite or not same or max(errs[g] for g in ("dq", "dk", "dv")) > BWD_TOL:
            raise AssertionError(
                f"flash_bwd disagrees with its plain version at {name}: finite={finite} "
                f"deterministic={same} errors={errs} (tol {BWD_TOL})")
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
    groups = {"flash kernels": 0.0, "GEMM (cuBLAS)": 0.0, "elementwise and other": 0.0}
    for n, us in by_name.items():
        if "flash_" in n:
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
    name, smi = phase_device()
    kernels = phase_kernels()
    bwd = phase_bwd_kernels()
    model = phase_model()
    serving, launches = phase_serve()
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    print(f"memory: {left / 1e9:.3f} GB allocated after serving", flush=True)
    if left >= 1e9:
        raise AssertionError(f"{left / 1e9:.2f} GB still allocated after serving")
    grads = phase_grads()
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(model["n_params"])
    options = phase_options()
    main_k, main_b = kernels[MAIN_SHAPE], bwd[MAIN_BWD_SHAPE]
    bwd_rows = []
    for part, gname, line in (("dq", ("dq",), 291), ("dkv", ("dk", "dv"), 336)):
        bwd_rows.append({
            "name": f"flash_bwd_{part}",
            "route": "cuda",
            "source": "kubedl_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"kubedl_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][1 if part == "dq" else 2],
            "max_abs_err": max(r["errors"][g + "_abs"] for r in bwd.values() for g in gname),
            "ms": main_b[f"{part}_ms"],
            "plain_ms": main_b["plain_ms"],
            "bound_ms": main_b[f"{part}_bound_ms"],
            "bound_by": main_b[f"{part}_bound_by"],
            "library_ms": main_b["library_ms"],
        })
    report = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "kubedl_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "kubedl_tpu/ops/flash_attention.py:107",
        "launches": launches,
        "max_abs_err": max(r["out_max_abs_err"] for r in kernels.values()),
        "ms": main_k["kernel_ms"],
        "plain_ms": main_k["plain_ms"],
        "bound_ms": main_k["bound_ms"],
        "bound_by": main_k["bound_by"],
        "library_ms": main_k["library_ms"],
    }] + bwd_rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, kernels=kernels, bwd_kernels=bwd,
                           model=model, serving=serving, grads=grads, train=train,
                           options=options, seconds=time.perf_counter() - t_start),
                      f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
