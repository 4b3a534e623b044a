"""Drive kubedl_tpu_torch's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its own line of numbers:
  1. device and build: the card's name and power limit, the CUDA kernel
     built from ops/csrc/ (seconds, registers, spills);
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
Then one JSON line of per-kernel numbers and, last, the device line.
`--out PATH` also writes every number of the run to PATH as JSON. Any
failure raises; the script exits non-zero and prints no result. It needs a
CUDA device and the repository beside it.
"""
import argparse
import json
import os
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
    _build.build("flash_fwd")
    print(f"build: flash_fwd.cu in {_build.build_seconds['flash_fwd']:.2f} s -> "
          f"{_build.library_path('flash_fwd')}", flush=True)
    for line in _build.ptxas_report("flash_fwd").splitlines():
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
    model = phase_model()
    serving, launches = phase_serve()
    main_k = kernels[MAIN_SHAPE]
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
    }]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, kernels=kernels, model=model,
                           serving=serving, seconds=time.perf_counter() - t_start),
                      f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
