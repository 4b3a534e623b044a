"""Trainer -- the JAXJob workload runtime on PyTorch (the port of
kubedl_tpu/train/trainer.py): one process per device, a gang of processes
training one model.

Llama (models/llama.py) -> the train step (parallel/train_step.py,
optimizer parallel/optim.py) -> checkpoints with preemption-safe save and
resume (train/checkpoint.py). The contract the operator depends on is the
JAX trainer's: the same flags and env defaults, the same printed lines and
trace spans, and on SIGTERM a final checkpoint and then the retryable exit
113, so the ExitCode restart policy brings the pod back and the trainer
resumes from the latest step.

A gang: the operator's KUBEDL_COORDINATOR_ADDRESS / KUBEDL_NUM_PROCESSES /
KUBEDL_PROCESS_ID form the torch.distributed group (train/coordinator.py),
KUBEDL_MESH and KUBEDL_DCN_MESH its DeviceMesh (parallel/mesh.py), whose
size must be the number of processes (else exit 2, before the
rendezvous). The step is then the sharded one over that mesh, with
sharded checkpoints. Process p's batches are the rows of its token block
(its coordinate over data x fsdp x expert): batch ids step * blocks +
block, so tensor and context peers feed the same rows. Rank 0 prints the
trainer's lines; every process records its own spans. A process without
an address trains alone on the one-device step. A pod with several cards
runs one trainer process a card under train/launch.py.

Context parallelism (a mesh context axis above 1; attention by the model
config's context_parallel, "ring" for every config named here): each
process takes its columns of its rows after the next-token shift
(parallel/mesh.py `seq_block`), so --seq-len minus 1 must divide by the
axis (else exit 2).

Usage (as a pod command; it runs on the card unless --device cpu):
    python -m kubedl_tpu_torch.train.trainer --model llama-7b --steps 100

--hf-model DIR (KUBEDL_HF_MODEL) starts from a local Hugging Face
checkpoint directory (models/import_hf.py) in place of --model's fresh
init; a checkpoint under --checkpoint-path still wins on resume.

--lora-rank R (KUBEDL_LORA_RANK) trains LoRA adapters only
(models/lora.py `make_lora_step`), on one device or in a gang (adapters
replicated, the base sharded): the optimizer state and the checkpoints hold
the adapters alone, which generate and serve merge or register with
--lora-checkpoint-path / --adapter.

Pipeline parallelism (KUBEDL_PP_STAGES > 1, with KUBEDL_PP_MICROBATCHES,
KUBEDL_PP_SCHEDULE gpipe|1f1b and KUBEDL_PP_INTERLEAVE): the mesh's stage
axis must equal KUBEDL_PP_STAGES; the layers are stacked and sharded over
it (models/llama.py `stack_params`, `param_specs_pp`) and the step runs
`loss_fn_pp` (parallel/pipeline.py schedules). Stage peers feed the same
rows. KUBEDL_PP_MPMD=1 pods run the stage program instead
(train/pipeline_trainer.py) and exit 2 here.

Refused with exit 2, until ported (ROADMAP.md): live reshard
(KUBEDL_LIVE_RESHARD=1).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import Optional

from kubedl_tpu_torch.parallel.mesh import mesh_from_env


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
                   help=">0: train LoRA adapters of this rank only "
                        "(models/lora.py); 0 = full fine-tune/pretrain")
    p.add_argument("--lora-alpha", type=float, default=None)
    p.add_argument("--hf-model", default=os.environ.get("KUBEDL_HF_MODEL", ""),
                   help="local Hugging Face checkpoint dir for the base "
                        "weights (models/import_hf.py)")
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


def _refused(args, info) -> Optional[str]:
    """The message for an option this slice of the port refuses, or None."""
    if os.environ.get("KUBEDL_PP_MPMD") == "1":
        return ("spec.pipeline.mpmd pods must run the stage program: "
                "python -m kubedl_tpu_torch.train.pipeline_trainer (this SPMD "
                "trainer would train the full model un-pipelined)")
    later = "is not ported to kubedl_tpu_torch yet (ROADMAP.md, trainer options refused)"
    if info.live_reshard:
        return f"KUBEDL_LIVE_RESHARD=1: live reshard {later}"
    return None


def _gang_mesh(info, seq_len: Optional[int] = None) -> "tuple[Optional[dict], Optional[str]]":
    """(the mesh's axis sizes, None) or (None, the reason to exit 2). The
    gang has one device per process, so the mesh must hold
    KUBEDL_NUM_PROCESSES devices; this runs before the rendezvous, so a
    mismatch never leaves peers waiting. `seq_len` is the trainer's, whose
    positions must split over a context axis; a program that passes none
    (train/vision.py, train/sparse.py) refuses a context axis."""
    try:
        axes = mesh_from_env(info.num_processes)
    except ValueError as e:
        return None, (f"{e} (one device per process: KUBEDL_NUM_PROCESSES="
                      f"{info.num_processes})")
    if axes["context"] > 1 and seq_len is None:
        return None, (f"mesh context={axes['context']}: context parallelism is not "
                      f"ported to kubedl_tpu_torch yet (ROADMAP.md)")
    if seq_len is not None and (seq_len - 1) % axes["context"]:
        return None, (f"--seq-len {seq_len}: its {seq_len - 1} positions do not split "
                      f"over the mesh context axis ({axes['context']}); seq_len - 1 "
                      f"must divide by it")
    pp_stages = int(os.environ.get("KUBEDL_PP_STAGES", "1"))
    if pp_stages > 1 and axes["stage"] != pp_stages:
        # the stacked layers shard over the mesh's stage axis
        return None, (f"KUBEDL_PP_STAGES={pp_stages} but the mesh stage axis "
                      f"is {axes['stage']} (spec.mesh.stage must "
                      f"match spec.pipeline.stages)")
    if info.num_processes > 1 and info.coordinator_address is None:
        return None, (f"KUBEDL_NUM_PROCESSES={info.num_processes} without "
                      f"KUBEDL_COORDINATOR_ADDRESS: the gang cannot meet")
    return axes, None


def main(argv=None) -> int:
    t_main0 = time.perf_counter()
    args = parse_args(argv)

    from kubedl_tpu_torch.train import coordinator

    info = coordinator.process_info()
    refused = _refused(args, info)
    axes = None
    if not refused:
        axes, refused = _gang_mesh(info, args.seq_len)
    if refused:
        print(refused, file=sys.stderr)
        return 2  # permanent config error (utils/exit_codes.py)

    from kubedl_tpu_torch.utils.device import process_device

    device = process_device(args.device)  # current before NCCL binds to it
    coordinator.initialize(info, backend="nccl" if device.type == "cuda" else "gloo")

    # preemption flag flipped by SIGTERM; the previous handler comes back
    # when main returns (an in-process caller keeps its own)
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        return _run(args, info, axes, device, preempted, t_main0)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


def _run(args, info, axes, device, preempted, t_main0) -> int:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.obs.steps import StepStream
    from kubedl_tpu_torch.obs.trace import tracer_from_env
    from kubedl_tpu_torch.ops import _build
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import (ShardingRules, build_mesh_from_env, seq_block,
                                                token_index)
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train.checkpoint import CheckpointManager
    from kubedl_tpu_torch.utils.exit_codes import EXIT_TPU_PREEMPTED, EXIT_XLA_COMPILE_ERROR

    rules = ShardingRules()
    mesh, world = None, 1
    block, n_blocks = 0, 1  # this process's token block of the global batch
    if dist.is_initialized():
        world = dist.get_world_size()
        mesh = build_mesh_from_env(world, device.type)
        block, n_blocks = token_index(mesh, rules)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0

    def say(*a, **kw):
        if rank0:
            print(*a, **kw)

    # flight recorder: spans to the pod's JSONL in the injected
    # KUBEDL_TRACE_DIR and a per-step heartbeat stream; inert without the env
    tracer = tracer_from_env()
    step_stream = StepStream.from_env()

    hf_base = None
    if args.hf_model:
        from kubedl_tpu_torch.models.import_hf import load_hf

        hf_base, config = load_hf(args.hf_model, device=device)
        say(f"base weights: {args.hf_model} ({config.n_layers}L/{config.d_model}d)",
            flush=True)
    else:
        config = llama.LlamaConfig.config_for(args.model)
    if args.remat:
        config = dataclasses.replace(
            config, remat=args.remat != "none",
            remat_policy="dots" if args.remat == "dots" else None)
    if args.ce_chunks > 1:
        config = dataclasses.replace(config, ce_chunks=args.ce_chunks)
    model_name = args.hf_model or args.model

    # pipeline parallelism: the operator-injected KUBEDL_PP_*, checked with
    # the shared shape rules (the stage axis was checked before the
    # rendezvous)
    pp_stages = int(os.environ.get("KUBEDL_PP_STAGES", "1"))
    pipelined = pp_stages > 1
    pp_micro = int(os.environ.get("KUBEDL_PP_MICROBATCHES", str(pp_stages)))
    pp_schedule = os.environ.get("KUBEDL_PP_SCHEDULE", "1f1b")
    pp_interleave = int(os.environ.get("KUBEDL_PP_INTERLEAVE", "1"))
    if pipelined:
        from kubedl_tpu_torch.api.validation import validate_pipeline_shapes

        errs = validate_pipeline_shapes(pp_stages, pp_micro, pp_interleave,
                                        n_layers=config.n_layers)
        if args.batch % pp_micro:
            errs.append(f"--batch {args.batch} not divisible by "
                        f"{pp_micro} microbatches")
        if args.lora_rank > 0:
            errs.append("--lora-rank is unsupported on the pipelined "
                        "path (adapters target unstacked projections)")
        if errs:
            print("pipeline config invalid: " + "; ".join(errs), file=sys.stderr)
            return 2  # permanent config error
    say(f"mesh: {axes} devices={world} model={model_name} "
        f"params≈{config.n_layers}L/{config.d_model}d", flush=True)
    if pipelined:
        from kubedl_tpu_torch.parallel.pipeline import bubble_fraction

        say(f"pipeline: {pp_schedule} stages={pp_stages} "
            f"microbatches={pp_micro} interleave={pp_interleave} "
            f"(bubble {bubble_fraction(pp_micro, pp_stages, pp_interleave):.3f})",
            flush=True)

    def loss(params, batch):
        if pipelined:
            return llama.loss_fn_pp(params, batch, config, mesh, rules=rules,
                                    n_microbatches=pp_micro, schedule=pp_schedule,
                                    interleave=pp_interleave)
        return llama.loss_fn(params, batch, config, mesh=mesh, rules=rules)

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
        params = (hf_base if hf_base is not None else
                  llama.init(config, torch.Generator(device=device).manual_seed(0),
                             device=device))
        hf_base = None  # the state holds the tree from here on
        if args.lora_rank > 0:
            # adapter-only training: gradients and optimizer state cover the
            # low-rank deltas; the frozen base rides through the step
            from kubedl_tpu_torch.models import lora as lora_mod

            adapters0, init_state, train_step = lora_mod.make_lora_step(
                params, config, tx, mesh, rules=rules, rank=args.lora_rank,
                alpha=args.lora_alpha, accum_steps=args.accum_steps)
            state = init_state(adapters0)
            n_ad = lora_mod.adapter_count(adapters0)
            say(f"lora: rank {args.lora_rank}, {n_ad} adapter params "
                f"({100.0 * n_ad / llama.param_count(params):.2f}% of base)", flush=True)
            if args.eval_every:
                say("note: --eval-every is skipped under --lora-rank "
                    "(restore with generate/serve --lora-checkpoint-path "
                    "to evaluate the merged model)", flush=True)
                args.eval_every = 0
        else:
            specs = None
            if pipelined:  # the stacked layout the stage axis shards
                params = llama.stack_params(params)
                specs = llama.param_specs_pp(config, rules)
            elif mesh is not None:
                specs = llama.param_specs(config, rules)
            init_state, train_step = make_train_step(
                loss, tx, mesh, specs, rules.spec("batch", None), rules,
                accum_steps=args.accum_steps)
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
            say(f"restored checkpoint at step {start_step}", flush=True)

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
            say(f"saved final checkpoint at step {step}", flush=True)
        if did_save or final:
            stall = time.perf_counter() - t_save0
            ckpt_stall["v"] += stall
            tracer.record("ckpt.save", duration_s=stall, step=step, final=final)

    # input: token shards, or synthetic batches. Batch id = step * blocks +
    # block (the rank's token block: tensor and context peers read the same
    # rows), so a resume at start_step continues the schedule; a context
    # rank keeps its columns of them.
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
        say(f"data: {len(shard_paths)} shards, {loader.n_windows} windows, "
            f"native=False", flush=True)

    rng = np.random.default_rng(block)

    def to_device(local):
        if mesh is not None:
            local = seq_block(local, mesh, rules)
        return torch.from_numpy(np.ascontiguousarray(local)).to(device)

    def next_batch(step: int):
        if loader is not None:
            local = loader.batch_at(step * n_blocks + block)
        else:
            local = rng.integers(0, config.vocab_size, (args.batch, args.seq_len),
                                 dtype=np.int32)
        return to_device(local)

    tokens_per_step = args.batch * n_blocks * (args.seq_len - 1)

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
        erng = np.random.default_rng(10**9 + block)
        src = eval_loader if eval_loader is not None else loader
        losses = []
        with torch.no_grad():
            for i in range(args.eval_batches):
                if src is not None:
                    base = 0 if eval_loader is not None else 2**20
                    local = src.batch_at(base + i * n_blocks + block)
                else:
                    local = erng.integers(0, config.vocab_size, (args.batch, args.seq_len),
                                          dtype=np.int32)
                losses.append(float(loss(state.params, to_device(local))))
        tag = "held-out" if eval_loader is not None else "probe"
        say(f"eval step {step}: loss={float(np.mean(losses)):.4f} "
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
                  step=start_step, model=model_name, devices=world)

    # every pod gets its own SIGTERM, and a collective save that ranks enter
    # at different steps deadlocks: the gang takes the MAX of the flag each
    # step, on a host (gloo) group, so the check never waits on the device
    flag_group = None
    if world > 1:
        flag_group = dist.new_group(backend="gloo") if device.type == "cuda" else None

    def stop_now() -> bool:
        if world == 1:
            return preempted["flag"]
        flag = torch.tensor([int(preempted["flag"])])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=flag_group)
        return bool(flag.item())
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
            if stop_now():
                sync()
                if prof is not None:
                    prof.stop()
                save(step + 1, final=True)
                tracer.record("trainer.preempted", step=step + 1)
                say("preempted: checkpoint saved, exiting retryable", flush=True)
                # the checkpoint is durable (the collective save returned on
                # every rank); exit at once, as the JAX trainer does: a clean
                # interpreter exit would run the process group's shutdown
                # while peers may still be in their last collective
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
                say(f"step {step + 1}: loss={loss_v:.4f} "
                    f"step/s={sps:.2f} tok/s={sps * tokens_per_step:.0f}", flush=True)
    finally:
        # SIGTERM or a raise inside the traced window must not leave the
        # profiler open (stop is idempotent)
        if prof is not None:
            prof.stop()

    sync()
    total = max(time.perf_counter() - t_start, 1e-9)
    steps_done = args.steps - start_step
    say(f"done: {steps_done} steps in {total:.1f}s "
        f"({steps_done / total:.2f} step/s, "
        f"{steps_done * tokens_per_step / total:.0f} tok/s)", flush=True)
    if device.type == "cuda":
        say(f"memory: peak allocated {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB "
            f"on {torch.cuda.get_device_name(device)}", flush=True)
    save(args.steps, final=True)
    tracer.record("trainer.done", step=args.steps, steps_done=steps_done,
                  wall_s=round(total, 3))
    if step_stream is not None:
        step_stream.close()
    tracer.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
