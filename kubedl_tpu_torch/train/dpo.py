"""DPO post-training workload: preference pairs in, an aligned policy out
(kubedl_tpu/train/dpo.py), on one device.

    python -m kubedl_tpu_torch.train.dpo --hf-model DIR --data-path pairs.jsonl

Reads JSONL preference data, runs the DPO step (train/preference.py),
checkpoints the whole policy TrainState (train/checkpoint.py, so generate
and serve restore it with the ordinary --checkpoint-path, and a rerun
resumes from the newest step), and logs the implicit reward margin and
the preference accuracy. One JSON object a line:

    {"prompt": [ids...], "chosen": [ids...], "rejected": [ids...]}

With --hf-model the fields may also be strings, encoded by the
checkpoint's own tokenizer (train/generate.py `encode_field`). Pairs are
right-padded to --seq-len (prompt and the longer continuation must fit).
The frozen reference is the starting policy: the base weights of
--hf-model, --ref-checkpoint-path or a fresh init; its logprobs are
computed once per batch and kept. It runs on the card unless --device cpu
is given; KUBEDL_MESH may ask for no more than this one device (exit 2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

MODELS = ["tiny", "bench-150m", "bench-1b", "llama-7b"]


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-dpo-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"), choices=MODELS)
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""),
                   help="local Hugging Face checkpoint dir: the policy's and the "
                        "reference's starting weights")
    p.add_argument("--ref-checkpoint-path", default="",
                   help="trainer checkpoint dir of the base weights (else fresh "
                        "init / --hf-model)")
    p.add_argument("--data-path", default=os.environ.get("KUBEDL_DATA_PATH", ""),
                   help="JSONL preference pairs; synthetic pairs when empty")
    p.add_argument("--steps", type=int, default=int(os.environ.get("KUBEDL_STEPS", 100)))
    p.add_argument("--batch", type=int, default=int(os.environ.get("KUBEDL_BATCH", 8)))
    p.add_argument("--seq-len", type=int, default=int(os.environ.get("KUBEDL_SEQ_LEN", 512)))
    p.add_argument("--lr", type=float, default=5e-7)
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-path", default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""))
    p.add_argument("--checkpoint-interval", type=int, default=200)
    p.add_argument("--allow-fresh-init", action="store_true",
                   help="train from random base weights when --ref-checkpoint-path "
                        "holds none (otherwise that is an error)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def load_pairs(path: str, seq_len: int, tokenizer=None):
    """JSONL -> (tokens [n, 2, T], prompt_lens [n], seq_lens [n, 2]) numpy
    int32; pairs that cannot fit seq_len, or whose continuation is empty,
    are skipped with a count. Fields are id lists or, with a tokenizer,
    strings."""
    import numpy as np

    from kubedl_tpu_torch.train.generate import encode_field

    toks, plens, slens = [], [], []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            prompt = encode_field(rec["prompt"], tokenizer, "prompt")
            chosen = prompt + encode_field(rec["chosen"], tokenizer, "chosen",
                                           continuation=True)
            rejected = prompt + encode_field(rec["rejected"], tokenizer, "rejected",
                                             continuation=True)
            if (max(len(chosen), len(rejected)) > seq_len or len(prompt) < 1
                    or len(chosen) == len(prompt) or len(rejected) == len(prompt)):
                # an empty continuation makes one logprob side exactly zero:
                # a degenerate gradient, not a preference
                skipped += 1
                continue
            row = np.zeros((2, seq_len), np.int32)
            row[0, :len(chosen)] = chosen
            row[1, :len(rejected)] = rejected
            toks.append(row)
            plens.append(len(prompt))
            slens.append([len(chosen), len(rejected)])
    if not toks:
        raise ValueError(f"no usable pairs in {path!r} at seq_len {seq_len}")
    if skipped:
        print(f"data: skipped {skipped} pairs exceeding --seq-len {seq_len}", flush=True)
    return np.stack(toks), np.asarray(plens, np.int32), np.asarray(slens, np.int32)


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import mesh_from_env
    from kubedl_tpu_torch.train.checkpoint import CheckpointManager
    from kubedl_tpu_torch.train.generate import load_tokenizer, restore_or_init
    from kubedl_tpu_torch.train.preference import make_dpo_step
    from kubedl_tpu_torch.utils.device import resolve_device

    try:
        axes = mesh_from_env(1)
    except ValueError as e:
        print(f"{e} (DPO runs on one device; a mesh is not ported yet, ROADMAP.md)",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    tokenizer = None
    if args.hf_model:
        from kubedl_tpu_torch.models.import_hf import load_hf

        base, config = load_hf(args.hf_model, device=dev)
        tokenizer = load_tokenizer(args.hf_model)
    else:
        config = llama.LlamaConfig.config_for(args.model)
        base = restore_or_init(
            config, args.ref_checkpoint_path,
            allow_fresh_init=args.allow_fresh_init or not args.ref_checkpoint_path,
            seed=args.seed, label="base", device=dev)
        if base is None:
            return 1
    print(f"mesh: {axes} model={args.hf_model or args.model} beta={args.beta}", flush=True)

    tx = optim.adamw(args.lr, weight_decay=0.0)
    if args.grad_clip > 0:
        tx = optim.chain(optim.clip_by_global_norm(args.grad_clip), tx)
    init_state, ref_fn, step = make_dpo_step(base, config, tx, beta=args.beta,
                                             accum_steps=args.accum_steps)
    state = init_state(base)
    del base

    # the whole set on the host (preference sets are small next to
    # pretraining corpora); batches cycle through a seeded permutation
    rng = np.random.default_rng(args.seed)
    if args.data_path:
        tokens, plens, slens = load_pairs(args.data_path, args.seq_len, tokenizer=tokenizer)
        print(f"data: {len(tokens)} pairs from {args.data_path}", flush=True)
    else:
        n = max(args.batch * 4, 32)
        tokens = rng.integers(1, config.vocab_size, (n, 2, args.seq_len)).astype(np.int32)
        plens = rng.integers(1, max(args.seq_len // 4, 2), (n,)).astype(np.int32)
        slens = rng.integers(args.seq_len // 2, args.seq_len + 1, (n, 2)).astype(np.int32)
        for i in range(n):  # a shared prompt across each pair
            tokens[i, 1, :plens[i]] = tokens[i, 0, :plens[i]]
        print(f"data: {n} synthetic pairs (no --data-path)", flush=True)

    mngr = None
    start_step = 0
    if args.checkpoint_path:
        mngr = CheckpointManager(args.checkpoint_path, max_to_keep=2)
        latest = mngr.latest_step()
        if latest is not None:
            # preemption resume: pick the schedule up where it stopped
            state = mngr.restore(latest, state)
            start_step = latest
            print(f"restored policy checkpoint at step {start_step}", flush=True)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    n_pairs = len(tokens)
    order = rng.permutation(n_pairs)
    ref_cache = {}
    t0 = time.time()
    for it in range(start_step + 1, args.steps + 1):
        lo = ((it - 1) * args.batch) % n_pairs
        idx = np.take(order, range(lo, lo + args.batch), mode="wrap")
        batch = (on_device(tokens[idx]), on_device(plens[idx]), on_device(slens[idx]))
        key = (lo, args.batch)
        if key not in ref_cache:
            ref_cache[key] = ref_fn(batch)
        state, metrics = step(state, (*batch, ref_cache[key]))
        if it % args.log_every == 0 or it == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {it}: loss={m['loss']:.4f} margin={m['reward_margin']:.3f} "
                  f"acc={m['preference_accuracy']:.2f}", flush=True)
        if mngr is not None and (it % args.checkpoint_interval == 0 or it == args.steps):
            mngr.save(it, state)  # returns once the state is on the host
    if mngr is not None:
        mngr.wait_until_finished()  # the final write lands before the exit
        print(f"saved policy checkpoint at step {args.steps}", flush=True)
    print(f"done: {args.steps - start_step} steps in {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
