"""Batch generation, the inference companion to train/trainer.py
(kubedl_tpu/train/generate.py), and the weight resolution that the
generate and serve entry points share.

    python -m kubedl_tpu_torch.train.generate --model tiny --checkpoint-path DIR

restores the params of the newest step the port's trainer saved under
DIR (train/checkpoint.py; the optimizer state is dropped), or draws fresh
ones when no path is given (or, with --allow-fresh-init, when the path
holds no checkpoint), then generates through models/decode.py: `generate`,
or `generate_speculative` with --speculative-k and a draft model.
--hf-model DIR reads a local Hugging Face checkpoint directory instead
(models/import_hf.py `load_hf`; it wins over --model and --checkpoint-path).
--lora-checkpoint-path merges the newest adapters a trainer --lora-rank run
saved there into the base (models/lora.py `restore_and_merge`, scale
--lora-alpha over the rank); a path with no adapters is an error (exit 1).
It runs on the card unless --device cpu is given.

`load_tokenizer` and `encode_field` are the tokenizer paths that serve,
dpo and evaluate share: transformers' AutoTokenizer from the --hf-model
directory when transformers imports, else id-list data only.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.utils.device import resolve_device

MODELS = ["tiny", "bench-150m", "bench-1b", "llama-7b"]


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-generate-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"), choices=MODELS)
    p.add_argument("--checkpoint-path", default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""),
                   help="trainer checkpoint dir; the newest step's params are used")
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""),
                   help="local Hugging Face checkpoint dir; overrides --model/"
                        "--checkpoint-path (models/import_hf.py)")
    p.add_argument("--allow-fresh-init", action="store_true",
                   help="use random weights when --checkpoint-path holds no "
                        "checkpoint (otherwise that is an error)")
    p.add_argument("--lora-checkpoint-path", default="",
                   help="merge the newest adapter checkpoint of a trainer "
                        "--lora-rank run into the base weights")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--batch", type=int, default=int(os.environ.get("KUBEDL_BATCH", 8)))
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 (models/quant.py)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache with bf16 per-position scales")
    p.add_argument("--speculative-k", type=int, default=0,
                   help="speculative decoding: the draft proposes K tokens per "
                        "target verify pass (--batch 1)")
    p.add_argument("--draft-model", default="tiny", choices=MODELS,
                   help="draft model config for --speculative-k")
    p.add_argument("--draft-checkpoint-path", default="",
                   help="trainer checkpoint dir of the draft (fresh init if empty)")
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def restore_params(path, label="params", device="cuda"):
    """The params of the newest step under `path` on `device`, or None if
    it holds none. A one-device step (state.pt) is read memory-mapped; a
    sharded step (torch.distributed.checkpoint) is read whole into one
    tree. The optimizer state is not read."""
    from kubedl_tpu_torch.train import checkpoint

    latest = checkpoint.latest_step(path)
    if latest is None:
        return None
    dev = resolve_device(device)
    step_dir = os.path.join(path, str(latest))
    if os.path.isfile(os.path.join(step_dir, checkpoint.STATE_FILE)):
        saved = torch.load(os.path.join(step_dir, checkpoint.STATE_FILE),
                           map_location="cpu", mmap=True, weights_only=True)
        tree = saved["params"]
    else:
        from torch.distributed.checkpoint.state_dict_loader import _load_state_dict_from_keys

        tree = _load_state_dict_from_keys({"params"}, checkpoint_id=step_dir)["params"]
    print(f"restored {label} params from checkpoint step {latest}", flush=True)
    # a copy off the file, with no autograd state (the trainer's leaves
    # require grad; inference must not record a graph)
    return llama.tree_map(lambda t: t.detach().to(dev, copy=True), tree)


def load_tokenizer(hf_model: str):
    """transformers' AutoTokenizer for an --hf-model directory, or None with
    a warning (the id-list APIs still work): the one tokenizer-loading block
    of serve, dpo and evaluate."""
    if not hf_model:
        return None
    try:
        import transformers

        return transformers.AutoTokenizer.from_pretrained(hf_model)
    except Exception as e:  # noqa: BLE001 — id-list data still works
        print(f"no tokenizer loaded ({e}); id-list data only", flush=True)
        return None


def encode_field(value, tokenizer, field: str, continuation: bool = False):
    """A JSONL field -> token ids: id lists pass through; strings encode
    through the tokenizer. Prompts encode with the tokenizer's special
    tokens (as serve encodes request text, so the trained prompt
    distribution is the served one); continuations (chosen, rejected,
    completions) never get BOS/EOS spliced mid-sequence."""
    if isinstance(value, str):
        if tokenizer is None:
            raise ValueError(
                f"{field!r} is text but no tokenizer is available — "
                f"pass --hf-model (and check the 'no tokenizer loaded' "
                f"warning if you already did), or pre-tokenize to id "
                f"lists")
        return list(tokenizer.encode(value, add_special_tokens=not continuation))
    return [int(t) for t in value]


def resolve_params(model, hf_model="", checkpoint_path="", allow_fresh_init=False,
                   lora_checkpoint_path="", lora_alpha=None, seed=0, label="target",
                   device="cuda"):
    """(params, config): --hf-model's directory, else the named model from
    its checkpoint or fresh; then an optional LoRA merge. (None, None) when
    a required checkpoint is missing (the error is printed). Raises
    ValueError when `lora_checkpoint_path` holds no adapters, and
    FileNotFoundError naming a checkpoint directory that cannot be read."""
    if hf_model:
        from kubedl_tpu_torch.models.import_hf import load_hf

        params, config = load_hf(hf_model, device=device)
    else:
        config = llama.LlamaConfig.config_for(model)
        params = restore_or_init(config, checkpoint_path, allow_fresh_init, seed=seed,
                                 label=label, device=device)
        if params is None:
            return None, None
    if lora_checkpoint_path:
        from kubedl_tpu_torch.models.lora import restore_and_merge

        params = restore_and_merge(params, lora_checkpoint_path, alpha=lora_alpha)
    return params, config


def restore_or_init(config, checkpoint_path="", allow_fresh_init=False, seed=0,
                    label="target", device="cuda"):
    """Checkpoint params, fresh params (a generator seeded with `seed`), or
    None with the error printed: an explicit path with nothing under it is
    a missing mount or a wrong dir unless --allow-fresh-init says
    otherwise."""
    params = None
    if checkpoint_path:
        params = restore_params(checkpoint_path, label, device)
        if params is None:
            if not allow_fresh_init:
                print(f"error: no checkpoint under {checkpoint_path} "
                      f"(pass --allow-fresh-init to serve random weights)",
                      file=sys.stderr)
                return None
            print(f"no checkpoint under {checkpoint_path}; using fresh init", flush=True)
    if params is None:
        # init only when serving fresh weights: a 7B init beside a restored
        # checkpoint would double peak memory
        dev = resolve_device(device)
        params = llama.init(config, torch.Generator(device=dev).manual_seed(seed), device=dev)
    return params


def main(argv=None) -> int:
    args = parse_args(argv)
    from kubedl_tpu_torch.models import decode

    try:
        params, config = resolve_params(
            args.model, args.hf_model, args.checkpoint_path, args.allow_fresh_init,
            lora_checkpoint_path=args.lora_checkpoint_path, lora_alpha=args.lora_alpha,
            seed=args.seed, device=args.device)
    except ValueError as e:  # an adapter directory with no checkpoint
        print(f"error: {e}", file=sys.stderr)
        return 1
    if params is None:
        return 1
    dev = resolve_device(args.device)
    if args.int8:
        from kubedl_tpu_torch.models import quant

        params = quant.quantize_params(params)
    prompt = torch.randint(0, config.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(args.seed + 1),
                           dtype=torch.int32).to(dev)
    kv_dtype = "int8" if args.kv_int8 else None
    spec_stats = {}
    if args.speculative_k:
        if args.speculative_k < 2:
            print("error: --speculative-k must be >= 2 (k=1 degenerates to "
                  "vanilla greedy with an extra draft pass)", file=sys.stderr)
            return 2
        if args.batch != 1:
            print("error: --speculative-k requires --batch 1", file=sys.stderr)
            return 2
        draft_config = llama.LlamaConfig.config_for(args.draft_model)
        if draft_config.vocab_size != config.vocab_size:
            print(f"error: --draft-model {args.draft_model} vocab "
                  f"{draft_config.vocab_size} != target vocab {config.vocab_size}; "
                  f"the models must share a tokenizer", file=sys.stderr)
            return 2
        draft = None
        if args.draft_checkpoint_path:
            draft = restore_params(args.draft_checkpoint_path, "draft", dev)
            if draft is None:
                if not args.allow_fresh_init:
                    # an empty draft dir is a missing mount; a random draft
                    # would only make speculation slower than plain decode
                    print(f"error: no checkpoint under {args.draft_checkpoint_path} "
                          f"(pass --allow-fresh-init for a random draft)",
                          file=sys.stderr)
                    return 1
                print(f"no checkpoint under {args.draft_checkpoint_path}; "
                      f"using fresh draft init", flush=True)
        if draft is None:
            draft = llama.init(draft_config,
                               torch.Generator(device=dev).manual_seed(args.seed + 3),
                               device=dev)
        if args.int8:
            from kubedl_tpu_torch.models import quant

            draft = quant.quantize_params(draft)

        def gen(generator):
            toks, stats = decode.generate_speculative(
                params, draft, prompt, config, draft_config,
                max_new_tokens=args.max_new_tokens, k=args.speculative_k,
                kv_dtype=kv_dtype, return_stats=True, temperature=args.temperature,
                generator=generator)
            spec_stats.update(stats)
            return toks
    else:
        def gen(generator):
            return decode.generate(params, prompt, config, args.max_new_tokens,
                                   max_len=args.prompt_len + args.max_new_tokens,
                                   temperature=args.temperature, generator=generator,
                                   kv_dtype=kv_dtype)

    def timed():
        t0 = time.perf_counter()
        toks = gen(torch.Generator(device=dev).manual_seed(args.seed + 2)).cpu()
        return toks, time.perf_counter() - t0

    toks, first_s = timed()  # the first call builds the kernels
    toks, dt = timed()
    total = args.batch * args.max_new_tokens
    print(f"sample[0,:8]={toks[0, :8].tolist()}", flush=True)
    if args.speculative_k:
        print(f"speculative: rounds={spec_stats['rounds']} "
              f"acceptance={spec_stats['acceptance']:.2f}", flush=True)
    print(f"done: generated {args.batch}x{args.max_new_tokens} tokens in {dt:.2f}s "
          f"({total / max(dt, 1e-9):.0f} tok/s, first call {first_s:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
