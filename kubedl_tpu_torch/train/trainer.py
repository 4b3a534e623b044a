"""Trainer -- the JAXJob workload runtime on PyTorch, one process and one
device (the port of kubedl_tpu/train/trainer.py).

Llama (models/llama.py) -> the one-device train step (parallel/
train_step.py, optimizer parallel/optim.py) -> checkpoints with
preemption-safe save and resume (train/checkpoint.py). The contract the
operator depends on is the JAX trainer's: the same flags and env defaults,
the same printed lines and trace spans, and on SIGTERM a final checkpoint
and then the retryable exit 113, so the ExitCode restart policy brings the
pod back and the trainer resumes from the latest step.

Usage (as a pod command; it runs on the card unless --device cpu):
    python -m kubedl_tpu_torch.train.trainer --model llama-7b --steps 100

Refused with exit 2, until ported (ROADMAP.md): --lora-rank, --hf-model,
pipeline stages (KUBEDL_PP_STAGES > 1, KUBEDL_PP_MPMD), live reshard
(KUBEDL_LIVE_RESHARD=1), more than one process (KUBEDL_NUM_PROCESSES) and
a mesh of more than one device (KUBEDL_MESH, KUBEDL_DCN_MESH).
"""
from __future__ import annotations

import argparse
import math
import os
import signal
import sys
import time
from typing import Dict, Optional

AXIS_ORDER = ("data", "fsdp", "stage", "tensor", "context", "expert")


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-trainer-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"),
                   choices=["tiny", "bench-1b", "llama-7b"])
    p.add_argument("--steps", type=int, default=int(os.environ.get("KUBEDL_STEPS", 100)))
    p.add_argument("--batch", type=int, default=int(os.environ.get("KUBEDL_BATCH", 8)))
    p.add_argument("--seq-len", type=int, default=int(os.environ.get("KUBEDL_SEQ_LEN", 512)))
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default=os.environ.get("KUBEDL_LR_SCHEDULE", "constant"),
                   help="cosine: warmup then cosine decay to 10%% of --lr "
                        "over --steps")
    p.add_argument("--warmup-steps", type=int,
                   default=int(os.environ.get("KUBEDL_WARMUP_STEPS", 0)),
                   help="linear LR warmup steps (used by both schedules)")
    p.add_argument("--grad-clip", type=float,
                   default=float(os.environ.get("KUBEDL_GRAD_CLIP", 0.0)),
                   help="clip gradients by global norm (0 = off)")
    p.add_argument("--eval-every", type=int,
                   default=int(os.environ.get("KUBEDL_EVAL_EVERY", 0)),
                   help="evaluate eval-set loss every N steps (0 = off)")
    p.add_argument("--eval-batches", type=int,
                   default=int(os.environ.get("KUBEDL_EVAL_BATCHES", 4)),
                   help="batches per eval pass (a fixed set each time)")
    p.add_argument("--eval-data-path",
                   default=os.environ.get("KUBEDL_EVAL_DATA_PATH", ""),
                   help="separate shards for a held-out set; without it the "
                        "eval set is a fixed probe of the training data")
    p.add_argument("--accum-steps", type=int,
                   default=int(os.environ.get("KUBEDL_ACCUM_STEPS", 1)),
                   help="gradient accumulation micro-steps per update")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data-path", default=os.environ.get("KUBEDL_DATA_PATH", ""),
                   help="glob of token shard files, e.g. /data/shard-*.bin")
    p.add_argument("--data-seed", type=int,
                   default=int(os.environ.get("KUBEDL_DATA_SEED", 0)),
                   help="shared shuffle seed")
    p.add_argument("--checkpoint-path",
                   default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""))
    p.add_argument("--checkpoint-interval",
                   type=int, default=int(os.environ.get("KUBEDL_CHECKPOINT_INTERVAL", 0)))
    p.add_argument("--checkpoint-keep",
                   type=int, default=int(os.environ.get("KUBEDL_CHECKPOINT_KEEP", 3)))
    p.add_argument("--lora-rank", type=int,
                   default=int(os.environ.get("KUBEDL_LORA_RANK", 0)),
                   help="not ported yet: refused when > 0")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""),
                   help="not ported yet: refused when set")
    p.add_argument("--remat", choices=["full", "dots", "none"],
                   default=os.environ.get("KUBEDL_REMAT", ""),
                   help="override the model's remat: full recompute, "
                        "matmul-saving 'dots' policy, or none")
    p.add_argument("--ce-chunks", type=int,
                   default=int(os.environ.get("KUBEDL_CE_CHUNKS", 0)),
                   help=">1: chunked cross-entropy (no [b,t,V] logits)")
    p.add_argument("--profile-dir", default=os.environ.get("KUBEDL_PROFILE_DIR", ""))
    p.add_argument("--profile-steps", type=int,
                   default=int(os.environ.get("KUBEDL_PROFILE_STEPS", 5)),
                   help="trace this many steps after the first into --profile-dir")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    # argparse checks `choices` only for command-line values, not env defaults
    if args.remat not in ("", "full", "dots", "none"):
        p.error(f"invalid KUBEDL_REMAT/--remat {args.remat!r} "
                f"(choose from full, dots, none)")
    if args.lr_schedule not in ("constant", "cosine"):
        p.error(f"invalid KUBEDL_LR_SCHEDULE/--lr-schedule "
                f"{args.lr_schedule!r} (choose from constant, cosine)")
    return args


def _parse_axes(value: str, fill: bool) -> Dict[str, int]:
    """"data=2,fsdp=4" -> axis sizes (KUBEDL_MESH / KUBEDL_DCN_MESH syntax);
    an empty KUBEDL_MESH (`fill`) means data=-1."""
    axes = {name: 1 for name in AXIS_ORDER}
    if not value:
        if fill:
            axes["data"] = -1
        return axes
    for part in value.split(","):
        if not part.strip():
            continue
        name, _, size = part.partition("=")
        name = name.strip()
        if name not in axes:
            raise ValueError(f"unknown mesh axis {name!r} (known: {AXIS_ORDER})")
        axes[name] = int(size)
    return axes


def mesh_from_env(visible: int) -> Dict[str, int]:
    """The mesh KUBEDL_MESH and KUBEDL_DCN_MESH ask for, with a -1 axis
    resolved against the `visible` devices (per DCN slice). Raises
    ValueError for a mesh of more than one device."""
    ici = _parse_axes(os.environ.get("KUBEDL_MESH", ""), fill=True)
    dcn = _parse_axes(os.environ.get("KUBEDL_DCN_MESH", ""), fill=False)
    wild = [k for k, v in ici.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"only one mesh axis may be -1, got {wild}")
    if wild:
        fixed = math.prod(v for v in ici.values() if v != -1)
        ici[wild[0]] = max(visible // max(math.prod(dcn.values()) * fixed, 1), 1)
    n = math.prod(ici.values()) * math.prod(dcn.values())
    if n > 1:
        raise ValueError(
            f"the mesh KUBEDL_MESH={os.environ.get('KUBEDL_MESH', '')!r} "
            f"KUBEDL_DCN_MESH={os.environ.get('KUBEDL_DCN_MESH', '')!r} asks for "
            f"{n} devices ({visible} visible); kubedl_tpu_torch trains on one "
            f"device until the sharded step is ported (ROADMAP.md)")
    return {k: ici[k] * dcn[k] for k in AXIS_ORDER}


def _refused(args, info) -> Optional[str]:
    """The message for an option this slice of the port refuses, or None."""
    if os.environ.get("KUBEDL_PP_MPMD") == "1":
        return ("spec.pipeline.mpmd pods must run the stage program: "
                "python -m kubedl_tpu.train.pipeline_trainer (this SPMD "
                "trainer would train the full model un-pipelined)")
    later = "is not ported to kubedl_tpu_torch yet (ROADMAP.md, trainer options refused)"
    if args.lora_rank > 0:
        return f"--lora-rank {args.lora_rank}: LoRA training {later}"
    if args.hf_model:
        return f"--hf-model {args.hf_model!r}: Hugging Face import {later}"
    if int(os.environ.get("KUBEDL_PP_STAGES", "1")) > 1:
        return (f"KUBEDL_PP_STAGES={os.environ['KUBEDL_PP_STAGES']}: pipeline "
                f"parallelism {later}")
    if info.live_reshard:
        return f"KUBEDL_LIVE_RESHARD=1: live reshard {later}"
    return None


def main(argv=None) -> int:
    t_main0 = time.perf_counter()
    args = parse_args(argv)

    from kubedl_tpu_torch.train import coordinator

    info = coordinator.process_info()
    refused = _refused(args, info)
    if refused:
        print(refused, file=sys.stderr)
        return 2  # permanent config error (utils/exit_codes.py)
    try:
        coordinator.initialize(info)
    except coordinator.MultiProcessNotPorted as e:
        print(str(e), file=sys.stderr)
        return 2

    # preemption flag flipped by SIGTERM; the previous handler comes back
    # when main returns (an in-process caller keeps its own)
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        return _run(args, info, preempted, t_main0)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


def _run(args, info, preempted, t_main0) -> int:
    import dataclasses

    import numpy as np
    import torch

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.obs.steps import StepStream
    from kubedl_tpu_torch.obs.trace import tracer_from_env
    from kubedl_tpu_torch.ops import _build
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train.checkpoint import CheckpointManager
    from kubedl_tpu_torch.utils.device import resolve_device
    from kubedl_tpu_torch.utils.exit_codes import EXIT_TPU_PREEMPTED, EXIT_XLA_COMPILE_ERROR

    device = resolve_device(args.device)
    try:
        mesh = mesh_from_env(torch.cuda.device_count() if device.type == "cuda" else 1)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2

    # flight recorder: spans to the pod's JSONL in the injected
    # KUBEDL_TRACE_DIR and a per-step heartbeat stream; inert without the env
    tracer = tracer_from_env()
    step_stream = StepStream.from_env()

    config = llama.LlamaConfig.config_for(args.model)
    if args.remat:
        config = dataclasses.replace(
            config, remat=args.remat != "none",
            remat_policy="dots" if args.remat == "dots" else None)
    if args.ce_chunks > 1:
        config = dataclasses.replace(config, ce_chunks=args.ce_chunks)
    model_name = args.model
    print(f"mesh: {mesh} devices=1 model={model_name} "
          f"params≈{config.n_layers}L/{config.d_model}d", flush=True)

    def loss(params, batch):
        return llama.loss_fn(params, batch, config)

    if args.lr_schedule == "cosine":
        # warmup -> cosine decay to 10% of peak over the run
        lr = optim.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=args.lr,
            warmup_steps=max(args.warmup_steps, 1),
            decay_steps=max(args.steps, args.warmup_steps + 1),
            end_value=args.lr * 0.1)
    elif args.warmup_steps > 0:
        lr = optim.linear_schedule(0.0, args.lr, args.warmup_steps)
    else:
        lr = args.lr
    tx = optim.adamw(lr, weight_decay=0.01)
    if args.grad_clip > 0:
        tx = optim.chain(optim.clip_by_global_norm(args.grad_clip), tx)
    try:
        if device.type == "cuda" and config.use_flash:
            _build.build("flash_fwd", "flash_bwd")  # a refused source fails here
        params = llama.init(config, torch.Generator(device=device).manual_seed(0),
                            device=device)
        init_state, train_step = make_train_step(loss, tx, accum_steps=args.accum_steps)
        state = init_state(params)
        del params
    except (torch.OutOfMemoryError, _build.BuildError) as e:
        print(f"compile/alloc failure: {e}", file=sys.stderr)
        return EXIT_XLA_COMPILE_ERROR

    mngr = None
    start_step = 0
    if args.checkpoint_path:
        mngr = CheckpointManager(args.checkpoint_path, max_to_keep=args.checkpoint_keep)
        latest = mngr.latest_step()
        if latest is not None and os.environ.get("KUBEDL_CHECKPOINT_RESTORE", "1") == "1":
            t_restore0 = time.perf_counter()
            state = mngr.restore(latest, state)
            start_step = state.step
            tracer.record("ckpt.restore", duration_s=time.perf_counter() - t_restore0,
                          step=start_step)
            print(f"restored checkpoint at step {start_step}", flush=True)

    saved_step = {"v": mngr.latest_step() if mngr else None}
    ckpt_stall = {"v": 0.0}  # checkpoint time the loop felt since the last record

    def save(step, final=False):
        if mngr is None:
            return
        t_save0 = time.perf_counter()
        did_save = saved_step["v"] != step
        if did_save:  # else: the interval hook already saved it
            mngr.save(step, state)
            saved_step["v"] = step
        if final:
            print(f"saved final checkpoint at step {step}", flush=True)
        if did_save or final:
            stall = time.perf_counter() - t_save0
            ckpt_stall["v"] += stall
            tracer.record("ckpt.save", duration_s=stall, step=step, final=final)

    # input: token shards, or synthetic batches. Batch id = step * world +
    # rank, so a resume at start_step continues the schedule.
    loader = None
    if args.data_path:
        import glob as globlib

        from kubedl_tpu_torch.native.loader import PyTokenLoader

        shard_paths = sorted(globlib.glob(args.data_path))
        if not shard_paths:
            print(f"no shards match {args.data_path!r}", file=sys.stderr)
            return 1
        loader = PyTokenLoader(shard_paths, batch=args.batch, seq_len=args.seq_len,
                               seed=args.data_seed)
        print(f"data: {len(shard_paths)} shards, {loader.n_windows} windows, "
              f"native=False", flush=True)

    rng = np.random.default_rng(info.process_id)

    def to_device(local):
        return torch.from_numpy(np.ascontiguousarray(local)).to(device)

    def next_batch(step: int):
        if loader is not None:
            local = loader.batch_at(step * info.num_processes + info.process_id)
        else:
            local = rng.integers(0, config.vocab_size, (args.batch, args.seq_len),
                                 dtype=np.int32)
        return to_device(local)

    tokens_per_step = args.batch * info.num_processes * (args.seq_len - 1)

    eval_loader = None
    if args.eval_every and args.eval_data_path:
        import glob as globlib

        from kubedl_tpu_torch.native.loader import PyTokenLoader

        eval_shards = sorted(globlib.glob(args.eval_data_path))
        if not eval_shards:
            print(f"no shards match {args.eval_data_path!r}", file=sys.stderr)
            return 1
        eval_loader = PyTokenLoader(eval_shards, batch=args.batch, seq_len=args.seq_len,
                                    seed=args.data_seed)

    def eval_pass(step: int) -> None:
        """Every pass scores the same fixed batches: held-out shards from id
        0, else a far region of the training loader, else a fixed rng."""
        erng = np.random.default_rng(10**9 + info.process_id)
        src = eval_loader if eval_loader is not None else loader
        losses = []
        with torch.no_grad():
            for i in range(args.eval_batches):
                if src is not None:
                    base = 0 if eval_loader is not None else 2**20
                    local = src.batch_at(base + i * info.num_processes + info.process_id)
                else:
                    local = erng.integers(0, config.vocab_size, (args.batch, args.seq_len),
                                          dtype=np.int32)
                losses.append(float(loss(state.params, to_device(local))))
        tag = "held-out" if eval_loader is not None else "probe"
        print(f"eval step {step}: loss={float(np.mean(losses)):.4f} "
              f"({args.eval_batches} {tag} batches)", flush=True)

    from kubedl_tpu_torch.train.profile_window import window_from_args

    prof = window_from_args(args, start_step)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # with the trace env every step syncs, so step times are wall-true;
    # KUBEDL_TRACE_STEP_SYNC=0 records dispatch times (synced=False)
    recording = tracer.exporting or step_stream is not None
    sync_steps = os.environ.get("KUBEDL_TRACE_STEP_SYNC", "1") == "1"
    first_step = True  # builds kernels' launch state and warms cuBLAS

    tracer.record("trainer.init", duration_s=time.perf_counter() - t_main0,
                  step=start_step, model=model_name, devices=1)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t_start = time.perf_counter()
    last_log = t_start
    try:
        for step in range(start_step, args.steps):
            if prof is not None:
                prof.maybe_start(step)
            t_step0 = time.perf_counter()
            batch = next_batch(step)
            data_s = time.perf_counter() - t_step0
            state, metrics = train_step(state, batch)
            if recording:
                loss_v = gnorm_v = None
                if sync_steps:
                    loss_v = float(metrics["loss"])  # syncs: the true step time
                    gnorm_v = float(metrics["grad_norm"])
                step_s = time.perf_counter() - t_step0
                was_compile, first_step = first_step, False
                tracer.record(
                    "train.compile" if was_compile else "train.step",
                    duration_s=step_s, step=step + 1, data_wait_s=round(data_s, 6),
                    **({"loss": loss_v, "grad_norm": gnorm_v} if loss_v is not None
                       else {"synced": False}))
                if step_stream is not None:
                    step_stream.record(step + 1, step_s, data_s=data_s, loss=loss_v,
                                       compile=was_compile, ckpt_s=ckpt_stall["v"])
                    ckpt_stall["v"] = 0.0
            if prof is not None and prof.should_stop(step):
                sync()
                prof.stop()
            if preempted["flag"]:
                sync()
                if prof is not None:
                    prof.stop()
                save(step + 1, final=True)
                tracer.record("trainer.preempted", step=step + 1)
                print("preempted: checkpoint saved, exiting retryable", flush=True)
                # the checkpoint is durable; exit at once, as the JAX trainer
                # does to skip interpreter shutdown
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(EXIT_TPU_PREEMPTED)
            if args.checkpoint_interval and (step + 1) % args.checkpoint_interval == 0:
                save(step + 1)
            if args.eval_every and (step + 1) % args.eval_every == 0:
                eval_pass(step + 1)
            if (step + 1) % args.log_every == 0:
                loss_v = float(metrics["loss"])
                now = time.perf_counter()
                sps = args.log_every / (now - last_log)
                last_log = now
                print(f"step {step + 1}: loss={loss_v:.4f} "
                      f"step/s={sps:.2f} tok/s={sps * tokens_per_step:.0f}", flush=True)
    finally:
        # SIGTERM or a raise inside the traced window must not leave the
        # profiler open (stop is idempotent)
        if prof is not None:
            prof.stop()

    sync()
    total = max(time.perf_counter() - t_start, 1e-9)
    steps_done = args.steps - start_step
    print(f"done: {steps_done} steps in {total:.1f}s "
          f"({steps_done / total:.2f} step/s, "
          f"{steps_done * tokens_per_step / total:.0f} tok/s)", flush=True)
    if device.type == "cuda":
        print(f"memory: peak allocated {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB "
              f"on {torch.cuda.get_device_name(device)}", flush=True)
    save(args.steps, final=True)
    tracer.record("trainer.done", step=args.steps, steps_done=steps_done,
                  wall_s=round(total, 3))
    if step_stream is not None:
        step_stream.close()
    tracer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
