"""GRPO post-training workload -- prompts in, a reward-tuned policy out
(kubedl_tpu/train/grpo.py), on one device.

    python -m kubedl_tpu_torch.train.grpo --hf-model DIR --data-path prompts.jsonl

Reads JSONL prompts, samples G completions a prompt from the CURRENT
policy with the KV-cache decode stack (models/decode.py `generate`),
scores them with a pluggable reward, and runs the GRPO update
(train/rl.py). Checkpoints the whole policy TrainState
(train/checkpoint.py), so generate and serve restore it with the ordinary
--checkpoint-path and a rerun resumes from the newest step.

Data format -- one JSON object a line:

    {"prompt": [ids...]}

With --hf-model the prompt may also be a string, encoded by the
checkpoint's own tokenizer (train/generate.py `encode_field`).

Rewards (pick one):
  --reward token-match   fraction of completion tokens == --reward-token
  --reward length        -|gen_len - --target-len| / max-new-tokens,
                         gen_len = tokens before the first --eos-id
  --reward-module m:fn   import m, call fn(prompt_ids, completion_ids)
                         -> float per completion

The frozen KL reference is the STARTING policy (--hf-model,
--ref-checkpoint-path or a fresh init), as in DPO. Prompt picks and the
sampling noise derive from the step index: step `it` draws from a
torch.Generator on the device seeded from numpy's SeedSequence((seed,
it)), so a resumed run continues the noise schedule. With KUBEDL_TRACE_DIR
set, each step, its rollout and each of its updates is a span
(grpo.step, grpo.rollout, grpo.update with the update's metrics). It runs
on the card unless --device cpu is given; KUBEDL_MESH may ask for no more
than this one device (exit 2).
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

MODELS = ["tiny", "bench-150m", "bench-1b", "llama-7b"]


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-grpo-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"), choices=MODELS)
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""),
                   help="Hugging Face base weights (policy AND reference init)")
    p.add_argument("--ref-checkpoint-path", default="",
                   help="trainer checkpoint dir of the base weights (else fresh "
                        "init / --hf-model)")
    p.add_argument("--data-path", default=os.environ.get("KUBEDL_DATA_PATH", ""),
                   help="JSONL prompts; synthetic prompts when empty")
    p.add_argument("--steps", type=int, default=int(os.environ.get("KUBEDL_STEPS", 50)),
                   help="rollout->update iterations")
    p.add_argument("--prompts-per-step", type=int, default=4)
    p.add_argument("--group-size", type=int, default=8,
                   help="G completions sampled per prompt")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--inner-epochs", type=int, default=1,
                   help="updates per rollout batch (ratio clipping only "
                        "bites past the first)")
    p.add_argument("--lr", type=float, default=1e-6)
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--kl-coef", type=float, default=0.04)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--reward", default="token-match", choices=["token-match", "length"])
    p.add_argument("--reward-token", type=int, default=5)
    p.add_argument("--target-len", type=int, default=16)
    p.add_argument("--eos-id", type=int, default=-1,
                   help=">=0: completions end at the first occurrence "
                        "(trims seq_lens and the length reward)")
    p.add_argument("--reward-module", default="",
                   help="'module.path:fn' overriding --reward")
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--checkpoint-path", default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""))
    p.add_argument("--checkpoint-interval", type=int, default=50)
    p.add_argument("--allow-fresh-init", action="store_true",
                   help="train from random base weights when no "
                        "--hf-model/--ref-checkpoint-path weights exist")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    if args.reward == "length" and not args.reward_module and args.eos_id < 0:
        p.error("--reward length needs --eos-id: without a stop token "
                "every completion is exactly --max-new-tokens long, every "
                "group's reward is constant, and training is a no-op")
    if args.temperature <= 0:
        p.error("--temperature must be > 0: greedy rollouts make all G "
                "samples of a group identical, which zeroes every "
                "group-normalized advantage")
    if args.group_size < 2:
        p.error("--group-size must be >= 2: the group mean is the "
                "baseline, so a single sample always has advantage 0 and "
                "the policy gradient vanishes")
    if args.inner_epochs > 1 and args.accum_steps > 1:
        p.error("--inner-epochs > 1 with --accum-steps > 1: MultiSteps "
                "defers the param update across micro-steps, so inner "
                "epochs would recompute identical gradients (params "
                "unchanged between them) — use one or the other")
    return args


def load_prompts(path: str, limit_len: int, tokenizer=None):
    """JSONL -> list of id-lists; prompts longer than limit_len are
    skipped with a count. Prompts may be id lists or (with a tokenizer
    from --hf-model) raw strings."""
    from kubedl_tpu_torch.train.generate import encode_field

    prompts, skipped = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ids = encode_field(json.loads(line)["prompt"], tokenizer, "prompt")
            if not ids or len(ids) > limit_len:
                skipped += 1
                continue
            prompts.append(ids)
    if skipped:
        print(f"data: skipped {skipped} prompts over {limit_len} tokens", flush=True)
    if not prompts:
        raise ValueError(f"no usable prompts in {path}")
    return prompts


def make_reward_fn(args):
    """(prompt_ids, completion_ids) -> float. completion_ids is already
    EOS-trimmed when --eos-id is set."""
    if args.reward_module:
        mod_name, _, fn_name = args.reward_module.partition(":")
        return getattr(importlib.import_module(mod_name), fn_name or "reward")
    if args.reward == "token-match":
        tok = args.reward_token

        def token_match(prompt_ids, completion_ids):
            if not completion_ids:
                return 0.0
            return sum(1 for t in completion_ids if t == tok) / len(completion_ids)

        return token_match

    def length_reward(prompt_ids, completion_ids):
        return -abs(len(completion_ids) - args.target_len) / max(args.max_new_tokens, 1)

    return length_reward


def sampling_generator(device, *entropy):
    """A torch.Generator on `device` seeded from numpy's
    SeedSequence(entropy): (seed, step), or (seed, 1000 + actor, step) for
    one actor of several."""
    import numpy as np
    import torch

    state = np.random.SeedSequence(tuple(int(e) for e in entropy)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def completion_rows(comp, tiled, tiled_plens, eos_id: int, reward_fn, n_cols: int,
                    behavior=None):
    """The training rows of one rollout batch, host-side: (tokens [n,
    n_cols] int32, seq_lens [n], rewards [n] f32, and with `behavior` ([n,
    K] sampling-time logprobs) the [n, n_cols - 1] grid that places
    completion token j of a row of prompt length pl at pl - 1 + j, zero
    elsewhere). With eos_id >= 0 a completion ends at its first EOS: the
    reward sees the text BEFORE the stop token, training keeps the stop
    token itself (emitting EOS is an action the gradient can credit)."""
    import numpy as np

    n = comp.shape[0]
    full = np.zeros((n, n_cols), np.int32)
    seq_lens = np.zeros(n, np.int32)
    rewards = np.zeros(n, np.float32)
    grid = None if behavior is None else np.zeros((n, n_cols - 1), np.float32)
    for i in range(n):
        pl = int(tiled_plens[i])
        c = comp[i]
        if eos_id >= 0:
            hits = np.nonzero(c == eos_id)[0]
            gen = c[: hits[0]] if len(hits) else c
            train_c = c[: hits[0] + 1] if len(hits) else c
        else:
            gen = train_c = c
        full[i, :pl] = tiled[i, :pl]
        full[i, pl:pl + len(train_c)] = train_c
        seq_lens[i] = pl + len(train_c)
        rewards[i] = reward_fn(list(tiled[i, :pl]), list(gen))
        if grid is not None:
            # index i of the grid holds log p(token i+1)
            grid[i, pl - 1:pl - 1 + len(train_c)] = behavior[i, :len(train_c)]
    return full, seq_lens, rewards, grid


def main(argv=None) -> int:
    args = parse_args(argv)

    import time

    import numpy as np
    import torch

    from kubedl_tpu_torch.models import decode, llama
    from kubedl_tpu_torch.obs.trace import tracer_from_env
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import mesh_from_env
    from kubedl_tpu_torch.train.checkpoint import CheckpointManager
    from kubedl_tpu_torch.train.generate import load_tokenizer, restore_or_init
    from kubedl_tpu_torch.train.rl import group_advantages, make_grpo_step
    from kubedl_tpu_torch.utils.device import resolve_device

    try:
        axes = mesh_from_env(1)
    except ValueError as e:
        print(f"{e} (GRPO runs on one device; a mesh is not ported yet, ROADMAP.md)",
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
    print(f"mesh: {axes} model={args.hf_model or args.model} "
          f"G={args.group_size} kl={args.kl_coef}", flush=True)

    tx = optim.adamw(args.lr, weight_decay=0.0)
    if args.grad_clip > 0:
        tx = optim.chain(optim.clip_by_global_norm(args.grad_clip), tx)
    # one update a rollout (the default) is strictly on-policy: the loss
    # uses its own detached forward for old_lp
    use_old = args.inner_epochs > 1
    init_state, _, ref_fn, step = make_grpo_step(
        base, config, tx, clip_eps=args.clip_eps, kl_coef=args.kl_coef,
        accum_steps=args.accum_steps, use_old_logprobs=use_old)
    state = init_state(base)
    del base

    rng = np.random.default_rng(args.seed)
    max_prompt = config.max_seq_len - args.max_new_tokens
    if args.data_path:
        prompts = load_prompts(args.data_path, max_prompt, tokenizer=tokenizer)
        print(f"data: {len(prompts)} prompts from {args.data_path}", flush=True)
    else:
        n = max(args.prompts_per_step * 4, 16)
        plen = min(16, max_prompt)
        prompts = [list(rng.integers(1, config.vocab_size, plen)) for _ in range(n)]
        print(f"data: {n} synthetic prompts (no --data-path)", flush=True)

    reward_fn = make_reward_fn(args)
    uniform = len({len(p) for p in prompts}) == 1
    pad_to = max(len(p) for p in prompts)
    K = args.max_new_tokens

    tracer = tracer_from_env()
    mngr = None
    start_step = 0
    if args.checkpoint_path:
        mngr = CheckpointManager(args.checkpoint_path, max_to_keep=2, tracer=tracer)
        latest = mngr.latest_step()
        if latest is not None:
            state = mngr.restore(latest, state)
            start_step = latest
            print(f"restored policy checkpoint at step {start_step}", flush=True)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    B, G = args.prompts_per_step, args.group_size
    t0 = time.time()
    try:
        for it in range(start_step + 1, args.steps + 1):
            # -- rollout: B prompts x G samples. Picks and noise derive from
            # the step index, so a resume continues the schedule ----------
            t_step = time.perf_counter()
            it_rng = np.random.default_rng((args.seed, it))
            pick = it_rng.choice(len(prompts), size=B, replace=len(prompts) < B)
            batch_prompts = [prompts[i] for i in pick]
            plens = np.array([len(p) for p in batch_prompts], np.int32)
            toks = np.zeros((B, pad_to), np.int32)
            for i, p in enumerate(batch_prompts):
                toks[i, :len(p)] = p
            tiled = np.repeat(toks, G, axis=0)          # [B*G, pad_to]
            tiled_plens = np.repeat(plens, G)           # [B*G]
            t_roll = time.perf_counter()
            with torch.no_grad():
                rolled = decode.generate(
                    state.params, on_device(tiled), config, K,
                    temperature=args.temperature,
                    generator=sampling_generator(dev, args.seed, it),
                    lengths=None if uniform else on_device(tiled_plens),
                    with_logprobs=use_old)
            comp, beh_lp = ((rolled[0].cpu().numpy(), rolled[1].cpu().numpy()) if use_old
                            else (rolled.cpu().numpy(), None))
            roll_s = time.perf_counter() - t_roll
            tracer.record("grpo.rollout", duration_s=roll_s, step=it, tokens=int(comp.size))

            # -- rewards + group-normalized advantages (host) -------------
            full, seq_lens, rewards, old_grid = completion_rows(
                comp, tiled, tiled_plens, args.eos_id, reward_fn, pad_to + K, beh_lp)
            adv = group_advantages(rewards.reshape(B, G)).reshape(-1)

            # -- the reference's logprobs, then the update(s) -------------
            lp_batch = (on_device(full), on_device(tiled_plens), on_device(seq_lens))
            ref_lp = ref_fn(lp_batch)
            if use_old:
                # old_lp comes from the rollout (sampling-time capture)
                train_batch = (*lp_batch, adv.to(dev), on_device(old_grid), ref_lp)
            else:
                train_batch = (*lp_batch, adv.to(dev), ref_lp)
            for epoch in range(args.inner_epochs):
                t_up = time.perf_counter()
                state, metrics = step(state, train_batch)
                m = {k: float(v) for k, v in metrics.items()}
                tracer.record("grpo.update", duration_s=time.perf_counter() - t_up,
                              step=it, epoch=epoch, reward=float(rewards.mean()), **m)

            tracer.record("grpo.step", duration_s=time.perf_counter() - t_step, step=it,
                          rollout_s=roll_s)
            if it % args.log_every == 0 or it == args.steps:
                print(f"step {it}: reward={rewards.mean():.3f}"
                      f"+-{rewards.std():.3f} loss={m['loss']:.4f} "
                      f"kl={m['kl']:.4f} clip={m['clip_frac']:.2f}", flush=True)
            if mngr is not None and (it % args.checkpoint_interval == 0 or it == args.steps):
                t_save = time.perf_counter()
                mngr.save(it, state)  # returns once the state is on the host
                if it == args.steps:
                    mngr.wait_until_finished()  # the final write lands before the exit
                tracer.record("ckpt.save", duration_s=time.perf_counter() - t_save, step=it,
                              final=it == args.steps)
    finally:
        tracer.close()
    if mngr is not None:
        print(f"saved policy checkpoint at step {args.steps}", flush=True)
    print(f"done: {args.steps - start_step} steps in {time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
