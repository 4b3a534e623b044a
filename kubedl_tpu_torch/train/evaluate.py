"""Evaluation workload: a checkpoint in, perplexity out
(kubedl_tpu/train/evaluate.py), on one device.

    python -m kubedl_tpu_torch.train.evaluate --hf-model DIR --data-path 'shard-*.bin'

Resolves weights as generate and serve do (train/generate.py
`resolve_params`: --hf-model, a trainer checkpoint, a LoRA merge), scores
the token shards of --data-path (native/loader.py, batch i = batch_at(i),
a deterministic full pass, so two checkpoints compare bit for bit) or 8
synthetic batches, and prints one JSON line: the mean next-token NLL of
models/llama.py `loss_fn` and its perplexity. It runs on the card unless
--device cpu is given; KUBEDL_MESH may ask for no more than this one
device (exit 2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

MODELS = ["tiny", "bench-150m", "bench-1b", "llama-7b"]


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-evaluate-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"), choices=MODELS)
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""),
                   help="local Hugging Face checkpoint dir; overrides "
                        "--model/--checkpoint-path")
    p.add_argument("--checkpoint-path", default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""),
                   help="trainer checkpoint dir; the newest step's params are used")
    p.add_argument("--lora-checkpoint-path", default="",
                   help="merge the newest adapter checkpoint into the base "
                        "weights before scoring")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--allow-fresh-init", action="store_true",
                   help="score random weights when no checkpoint exists")
    p.add_argument("--data-path", default=os.environ.get("KUBEDL_DATA_PATH", ""),
                   help="glob of token shard files (trainer format); synthetic "
                        "tokens when empty")
    p.add_argument("--batch", type=int, default=int(os.environ.get("KUBEDL_BATCH", 8)))
    p.add_argument("--seq-len", type=int, default=int(os.environ.get("KUBEDL_SEQ_LEN", 1024)))
    p.add_argument("--max-batches", type=int, default=0,
                   help="cap scored batches (0 = the full pass)")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to score on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import glob as globlib
    import math
    import time

    import numpy as np
    import torch

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel.mesh import mesh_from_env
    from kubedl_tpu_torch.train.generate import resolve_params
    from kubedl_tpu_torch.utils.device import resolve_device

    try:
        axes = mesh_from_env(1)
    except ValueError as e:
        print(f"{e} (evaluation runs on one device; a mesh is not ported yet, "
              f"ROADMAP.md)", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    try:
        params, config = resolve_params(
            args.model, args.hf_model, args.checkpoint_path, args.allow_fresh_init,
            lora_checkpoint_path=args.lora_checkpoint_path, lora_alpha=args.lora_alpha,
            seed=args.seed, label="eval", device=dev)
    except ValueError as e:  # an adapter directory with no checkpoint
        print(f"error: {e}", file=sys.stderr)
        return 1
    if params is None:
        return 1
    print(f"mesh: {axes} model={args.hf_model or args.model} seq={args.seq_len} "
          f"processes=1", flush=True)

    if args.data_path:
        from kubedl_tpu_torch.native.loader import PyTokenLoader

        shard_paths = sorted(globlib.glob(args.data_path))
        if not shard_paths:
            print(f"no shards match {args.data_path!r}", file=sys.stderr)
            return 1
        loader = PyTokenLoader(shard_paths, batch=args.batch, seq_len=args.seq_len,
                               seed=args.seed)
        if loader.n_windows < args.batch:
            # batch_at wraps window ids modulo n_windows: a short set would
            # score some windows twice and bias the mean
            print(f"only {loader.n_windows} windows for a global batch of "
                  f"{args.batch} — shrink --batch", file=sys.stderr)
            return 1
        n_batches = loader.n_windows // args.batch
        dropped = loader.n_windows - n_batches * args.batch
        if dropped:
            print(f"note: dropping {dropped} remainder windows (static batch shapes)",
                  flush=True)
        get = loader.batch_at
        print(f"data: {len(shard_paths)} shards, {loader.n_windows} windows -> "
              f"{n_batches} global batches", flush=True)
    else:
        rng = np.random.default_rng(args.seed)
        fixed = rng.integers(1, config.vocab_size,
                             (8, args.batch, args.seq_len)).astype(np.int32)
        n_batches = len(fixed)
        get = fixed.__getitem__
        print(f"data: {n_batches} synthetic batches (no --data-path)", flush=True)
    if args.max_batches:
        n_batches = min(n_batches, args.max_batches)

    total_nll = 0.0
    t0 = None
    with torch.no_grad():
        for i in range(n_batches):
            tokens = torch.from_numpy(np.ascontiguousarray(get(i))).to(dev)
            # loss_fn: the mean next-token CE over seq_len - 1 positions
            total_nll += float(llama.loss_fn(params, tokens, config))
            if t0 is None:
                t0 = time.time()  # steady-state clock: batch 0 builds the kernels
            if args.log_every and ((i + 1) % args.log_every == 0 or i + 1 == n_batches):
                mean = total_nll / (i + 1)
                print(f"batch {i + 1}/{n_batches}: nll={mean:.4f} "
                      f"ppl={math.exp(min(mean, 30.0)):.2f}", flush=True)
    mean_nll = total_nll / n_batches
    tokens = n_batches * args.batch * (args.seq_len - 1)
    dt = max(time.time() - (t0 or time.time()), 1e-9)
    print(json.dumps({
        "metric": "eval_perplexity",
        "perplexity": round(math.exp(min(mean_nll, 30.0)), 4),
        "nll": round(mean_nll, 6),
        "tokens": tokens,
        # steady state: the first batch starts the clock but is not counted
        "tokens_per_sec": round((tokens - args.batch * (args.seq_len - 1)) / dt
                                if n_batches > 1 else 0.0, 0),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
