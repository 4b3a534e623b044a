"""Trainer -- the JAXJob workload runtime on PyTorch (the port of
kubedl_tpu/train/trainer.py): one process per device, a gang of processes
training one model.

Llama (models/llama.py) -> the train step (parallel/train_step.py,
optimizer parallel/optim.py) -> checkpoints with preemption-safe save and
resume (train/checkpoint.py: interval saves are asynchronous, a final save
waits for its write). The contract the operator depends on is the
JAX trainer's: the same flags and env defaults, the same printed lines and
trace spans, and on SIGTERM a final checkpoint and then the retryable exit
113, so the ExitCode restart policy brings the pod back and the trainer
resumes from the latest step.

A gang: the operator's KUBEDL_COORDINATOR_ADDRESS / KUBEDL_NUM_PROCESSES /
KUBEDL_PROCESS_ID form the torch.distributed group (train/coordinator.py),
KUBEDL_MESH and KUBEDL_DCN_MESH its DeviceMesh (parallel/mesh.py), whose
size must be the number of processes (else exit 2, before the
rendezvous; a live-reshard gang, which may resume on a staging's mesh,
checks it once its ranks agreed on the staging). The step is then the
sharded one over that mesh, with sharded checkpoints. Process p's batches
are the rows of its token block (its coordinate over data x fsdp x
expert): batch ids step * blocks + block, so tensor and context peers feed
the same rows. Rank 0 prints the trainer's lines; every process records
its own spans. A process without an address trains alone on the
one-device step. A pod with several cards runs one trainer process a card
under train/launch.py.

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

Live reshard (KUBEDL_LIVE_RESHARD=1; train/reshard_runtime.py): with a
control endpoint (KUBEDL_CONTROL_DIR, or KUBEDL_TRANSPORT=socket) the
trainer answers RESIZE messages at step boundaries. The gang acts at the
first step boundary where every rank holds an unanswered RESIZE (agreed on
the host group that carries the SIGTERM flag); chip counts that differ
between ranks fall back closed on every rank, and each rank replies to its
own message. A resize that keeps the chip count refits to the same mesh:
the state stays where it is (reply "ok", moved_mb 0); one that changes it
stages the state's blocks for the new chip count in KUBEDL_RESHARD_DIR and
exits 113 (reply "staged"), and the restart, with KUBEDL_NUM_PROCESSES the
new chip count, resumes from the staging on the staging's mesh in place of
KUBEDL_MESH. Every rank resumes from the staging or none does: the ranks
compare the staging each read before they build the mesh, and again after
each assembled its part. A one-process trainer asked for more chips stages
for them. Any failure banks a final checkpoint and exits 113 (reply
"fallback"). The rows a process takes stay --batch, so the global batch
scales with the world across a staged restart. The test seam
KUBEDL_RESHARD_TEST_DIGEST=1 prints the sha256 of the whole state (every
leaf gathered on the host) after a staged restore and before staging, for
bit-for-bit checks. Live reshard is refused with pipeline parallelism
(exit 2), as in the reference.
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
    """The message for a configuration this trainer refuses, or None."""
    if os.environ.get("KUBEDL_PP_MPMD") == "1":
        return ("spec.pipeline.mpmd pods must run the stage program: "
                "python -m kubedl_tpu_torch.train.pipeline_trainer (this SPMD "
                "trainer would train the full model un-pipelined)")
    if info.live_reshard and int(os.environ.get("KUBEDL_PP_STAGES", "1")) > 1:
        return ("pipeline config invalid: spec.elastic.liveReshard is unsupported with "
                "spec.pipeline (the reshard planner does not cover stage-stacked layouts)")
    return None


def _staging_wanted(args, info) -> bool:
    """Whether this run may resume from a live-reshard staging (the same on
    every rank of a gang: the operator injects the env)."""
    return bool(info.live_reshard and info.reshard_dir and args.lora_rank == 0)


def _agree_on_staging(staged, reshard_dir, group):
    """The staging every rank of the gang resumes from, or None on every
    rank: the ranks compare the (step, axes) each read before the
    rendezvous, and a difference (a file one rank could not read, a guard
    that tripped on one rank) drops it everywhere, cleared by rank 0.
    Collective; runs before the mesh is built, which the axes decide."""
    import torch.distributed as dist

    from kubedl_tpu_torch.train import reshard_runtime

    mine = None if staged is None else [staged[0], staged[1]]
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, mine, group=group)
    if all(s == seen[0] for s in seen):
        return staged
    print(f"live-reshard staging differs across the gang ((step, mesh) by rank: {seen}); "
          f"falling back to checkpoint restore", file=sys.stderr)
    if staged is not None:
        staged[2].close()
    if dist.get_rank() == 0:  # every rank is past its read (the gather)
        reshard_runtime.clear_staging(reshard_dir)
    return None


def _staged_restart(args, info):
    """(step, new axes, blocks) of the live-reshard staging this process
    resumes from, or None. Read before the rendezvous: a valid staging's
    mesh replaces KUBEDL_MESH. A published staging that is invalid, for
    another process count, larger than the granted slice or older than the
    newest checkpoint is cleared (a staging without a manifest may be a
    gang's in-flight one and stays)."""
    if not _staging_wanted(args, info):
        return None
    import math

    from kubedl_tpu_torch.train import reshard_runtime
    from kubedl_tpu_torch.train.checkpoint import latest_step

    d = info.reshard_dir
    staged = reshard_runtime.restore_staged(d, info.process_id, info.num_processes)
    if staged is None:
        if reshard_runtime.staging_exists(d):
            reshard_runtime.clear_staging(d)
        return None
    if os.environ.get("TPU_SLICE_TYPE"):
        # a stale staging must never re-inflate the mesh past the grant
        try:
            granted = reshard_runtime.slice_chips(os.environ["TPU_SLICE_TYPE"])
        except ValueError:
            granted = None
        if granted is not None and math.prod(staged[1].values()) != granted:
            print(f"staging topology {staged[1]} != granted {granted}-chip slice; "
                  f"falling back to checkpoint", file=sys.stderr)
            reshard_runtime.clear_staging(d)
            return None
    latest = latest_step(args.checkpoint_path) if args.checkpoint_path else None
    if latest is not None and latest > staged[0]:
        # a checkpoint newer than the staging wins: the staging is a quiesce
        # snapshot, replaying it over later saves would lose steps
        reshard_runtime.clear_staging(d)
        return None
    return staged


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
    axes = staged = None
    if not refused:
        staged = _staged_restart(args, info)
        # a gang that may resume from a staging picks its mesh once the
        # ranks agree on it (_run): a rank that refused KUBEDL_MESH here
        # would leave a peer with a staging waiting at the rendezvous
        gang_decides = (info.num_processes > 1 and info.coordinator_address is not None
                        and _staging_wanted(args, info))
        if staged is not None:
            axes = staged[1]
        elif not gang_decides:
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
        return _run(args, info, axes, device, preempted, t_main0, staged)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


def _run(args, info, axes, device, preempted, t_main0, staged=None) -> int:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.obs.steps import StepStream
    from kubedl_tpu_torch.obs.trace import tracer_from_env
    from kubedl_tpu_torch.ops import _build
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import (ShardingRules, build_mesh, build_mesh_from_env,
                                                seq_block, token_index)
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import reshard_runtime
    from kubedl_tpu_torch.train.checkpoint import CheckpointManager
    from kubedl_tpu_torch.utils.exit_codes import EXIT_TPU_PREEMPTED, EXIT_XLA_COMPILE_ERROR

    rules = ShardingRules()
    mesh, world = None, 1
    block, n_blocks = 0, 1  # this process's token block of the global batch
    # every pod gets its own SIGTERM and its own RESIZE, and a collective
    # that ranks enter at different steps deadlocks: the gang agrees on
    # both each step, and on a staged restart, on a host (gloo) group, so
    # the check never waits on the device
    flag_group = None
    if dist.is_initialized():
        world = dist.get_world_size()
        if world > 1 and device.type == "cuda":
            flag_group = dist.new_group(backend="gloo")
        if world > 1 and _staging_wanted(args, info):
            staged = _agree_on_staging(staged, info.reshard_dir, flag_group)
            if staged is None:  # KUBEDL_MESH decides, on every rank alike
                axes, refused = _gang_mesh(info, args.seq_len)
                if refused:
                    print(refused, file=sys.stderr)
                    return 2  # permanent config error
        mesh = (build_mesh(staged[1], world, device.type) if staged is not None
                else build_mesh_from_env(world, device.type))
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

    def fresh_params():
        if args.hf_model:
            from kubedl_tpu_torch.models.import_hf import load_hf

            return load_hf(args.hf_model, device=device)[0]
        return llama.init(config, torch.Generator(device=device).manual_seed(0), device=device)

    def gang_any(flag: bool) -> bool:
        """Whether any rank of the gang raised `flag` (collective)."""
        if world == 1:
            return flag
        v = torch.tensor([int(flag)])
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=flag_group)
        return bool(v.item())

    digest_on = os.environ.get(reshard_runtime.ENV_TEST_DIGEST) == "1"

    # the specs the planner reads the state with: those it is sharded
    # with, and on one device any spec holds the whole leaf
    plan_specs = llama.param_specs(config, rules)

    def say_digest(what, at_step):
        """The whole state's sha256 (the test seam; collective)."""
        if digest_on:
            d = reshard_runtime.state_digest(state, plan_specs, group=flag_group)
            if d is not None:
                say(f"live reshard: state sha256 {what} at step {at_step}: {d['*']}",
                    flush=True)

    try:
        if device.type == "cuda" and config.use_flash:
            _build.build("flash_fwd", "flash_bwd")  # a refused source fails here
        params = hf_base if hf_base is not None else fresh_params()
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
            if staged is not None:
                # the staged-restart lane: the previous incarnation quiesced
                # and staged its blocks for this topology; the template's
                # values are overwritten leaf by leaf. A gap on any rank
                # falls back closed on every rank, to the checkpoint below
                # from a fresh init: no rank trains on its staged part
                # while a peer restores.
                t_restage0 = time.perf_counter()
                read, err = {}, None
                try:
                    state = reshard_runtime.state_from_staging(staged[2], state, plan_specs,
                                                               stats=read)
                except Exception as e:  # noqa: BLE001 -- fallback closed
                    err = e
                staged[2].close()
                if gang_any(err is not None):
                    print(f"staging unusable ({err or 'a peer could not assemble its part'}); "
                          f"falling back to checkpoint restore", file=sys.stderr)
                    if rank0:  # every rank is past its read (the agreement)
                        reshard_runtime.clear_staging(info.reshard_dir)
                    staged = None
                    del state
                    params = fresh_params()
                    state = init_state(params)
                else:
                    # NOT cleared: a stale replay is caught by the guards
                    # of _staged_restart
                    restore_s = time.perf_counter() - t_restage0
                    say(f"restored live-reshard staging at step {staged[0]} "
                        f"(mesh {staged[1]})", flush=True)
                    say(f"live reshard: read {read.get('bytes', 0) / 2**20:.1f} MB in "
                        f"{read.get('blocks', 0)} blocks in {restore_s:.2f} s", flush=True)
        del params
    except (torch.OutOfMemoryError, _build.BuildError) as e:
        print(f"compile/alloc failure: {e}", file=sys.stderr)
        return EXIT_XLA_COMPILE_ERROR
    if staged is not None:
        say_digest("restored", staged[0])

    mngr = None
    start_step = staged[0] if staged is not None else 0
    if args.checkpoint_path:
        mngr = CheckpointManager(args.checkpoint_path, max_to_keep=args.checkpoint_keep,
                                 tracer=tracer)
        latest = mngr.latest_step()
        if staged is not None:
            pass  # the live-reshard staging beats a restore (start_step set above)
        elif latest is not None and os.environ.get("KUBEDL_CHECKPOINT_RESTORE", "1") == "1":
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
            mngr.save(step, state)  # returns once the state is on the host
            saved_step["v"] = step
        if final:
            mngr.wait_until_finished()  # the write lands before the exit
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

    # the control endpoint: the socket plane in kube mode, KUBEDL_CONTROL_DIR
    # polling on the local executor (same surface)
    ctl = reshard_runtime.control_from_env() if info.live_reshard else None
    reshard_dir = info.reshard_dir
    pending = {"msg": None, "chips": 0}  # this rank's unanswered RESIZE

    def gang_flags():
        """(stop, every rank holds a RESIZE, lowest and highest chip count
        asked): the MAX over the gang of SIGTERM flags and RESIZE states."""
        have = pending["msg"] is not None
        if world == 1:
            return preempted["flag"], have, pending["chips"], pending["chips"]
        big = 1 << 40
        chips = max(-big, min(big, pending["chips"])) if have else None
        v = torch.tensor([int(preempted["flag"]), int(not have),
                          chips if have else -big, -chips if have else -big])
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=flag_group)
        return bool(v[0]), not bool(v[1]), -int(v[3]), int(v[2])

    def say_memory():
        if device.type == "cuda":
            from kubedl_tpu_torch.ops.flash_attention import flash_attention as fa

            say(f"memory: peak allocated {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB "
                f"on {torch.cuda.get_device_name(device)}; flash launches fwd/dq/dkv "
                f"({fa.launches}, {fa.bwd_dq_launches}, {fa.bwd_dkv_launches})", flush=True)

    def exit_retryable():
        if mngr is not None:
            try:
                mngr.wait_until_finished()  # an interval save in flight lands first
            except Exception as e:  # noqa: BLE001 -- the exit is retryable either way
                print(f"checkpoint write failed: {e!r}", file=sys.stderr)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_TPU_PREEMPTED)

    # -- the live resize protocol (train/reshard_runtime.py ladder) --------
    # every rank enters these together, at the step the gang agreed on

    def resize_fallback(msg, at_step, reason):
        """Fallback CLOSED: the old state is intact (nothing is committed
        before every rank succeeded), so bank it as a final checkpoint, tell
        the scheduler, and exit retryable -- the restart comes back through
        checkpoint restore. A corrupted state is never saved or trained on."""
        print(f"live reshard failed ({reason}); falling back to checkpoint restore",
              file=sys.stderr)
        try:
            save(at_step, final=True)
        except Exception as e:  # noqa: BLE001 -- the last published save still holds
            print(f"fallback checkpoint at step {at_step} failed: {e!r}", file=sys.stderr)
        tracer.record("reshard.fallback", step=at_step, reason=str(reason)[:200])
        ctl.reply(msg, outcome="fallback", step=at_step, error=str(reason)[:300])
        exit_retryable()

    def resize_staged(msg, at_step, new_chips):
        """A changed chip count: the gang quiesces, stages the blocks the new
        topology needs and restarts onto it (reassembly at startup). Worker 0
        publishes the manifest once every pod staged a matching plan; any gap
        falls back closed on every rank."""
        t_stage0 = time.perf_counter()
        plan, err = None, None
        try:
            say_digest("staged", at_step)
            if not reshard_dir:
                raise reshard_runtime.ReshardError("no KUBEDL_RESHARD_DIR")
            leaves = reshard_runtime.leaves_from_state(state, plan_specs)
            old_axes = reshard_runtime.mesh_axes(mesh)
            new_axes = reshard_runtime.refit_axes(old_axes, new_chips)
            plan = reshard_runtime.plan_reshard(leaves, old_axes, new_axes, world, new_chips)
            reshard_runtime.stage_shards(
                reshard_dir, plan, reshard_runtime.mesh_pod(mesh),
                reshard_runtime.provider_from_blocks(
                    reshard_runtime.addressable_blocks(state, plan_specs)), at_step)
        except Exception as e:  # noqa: BLE001 -- fallback closed
            err = e
        if gang_any(err is not None):
            resize_fallback(msg, at_step, f"staged lane: {err or 'a peer did not stage'}")
        stage_s = time.perf_counter() - t_stage0
        # the job's own quiesce budget (spec.elastic.quiesceTimeoutS)
        # outranks the scheduler default
        quiesce = float(os.environ.get("KUBEDL_RESHARD_QUIESCE_S",
                                       msg.get("quiesce_timeout_s", 30.0)))
        ok = (reshard_runtime.mesh_pod(mesh) != 0 or reshard_runtime.write_manifest(
            reshard_dir, plan, at_step, world, timeout=quiesce))
        if gang_any(not ok):
            resize_fallback(msg, at_step, "staged lane: manifest aborted")
        tracer.record("reshard.staged", duration_s=time.perf_counter() - t_stage0,
                      step=at_step, chips=new_chips)
        ctl.reply(msg, outcome="staged", step=at_step)
        say(f"live reshard: staged {plan.moved_bytes / 2**20:.1f} MB moved and "
            f"{plan.local_bytes / 2**20:.1f} MB local for {new_chips} chips "
            f"(mesh {plan.new_axes}) in {stage_s:.2f} s, manifest "
            f"{time.perf_counter() - t_stage0 - stage_s:.2f} s", flush=True)
        say(f"staged reshard at step {at_step}: restarting onto the new topology",
            flush=True)
        say_memory()
        exit_retryable()

    def handle_resize(msg, at_step, new_chips):
        t0 = time.perf_counter()
        sync()  # quiesce at the step boundary
        if new_chips <= 0:
            resize_fallback(msg, at_step, f"bad chip count {new_chips}")
        if args.lora_rank > 0:
            resize_fallback(msg, at_step, "lora runs restart via checkpoint")
        if new_chips != world:
            resize_staged(msg, at_step, new_chips)  # does not return
        # the same chip count refits to the same mesh: the plan moves
        # nothing, and the state, the mesh and the step stay as they are
        plan = err = None
        try:
            _, _, plan = reshard_runtime.live_resize(state, mesh, new_chips, plan_specs)
        except reshard_runtime.ReshardError as e:
            err = e
        if gang_any(err is not None):
            resize_fallback(msg, at_step, str(err or "a peer's reshard failed"))
        # reply NOW: downtime = quiesce -> the state resident on the mesh,
        # a step dispatchable
        downtime = time.perf_counter() - t0
        moved_mb = round(plan.moved_bytes / 2**20, 3)
        tracer.record("reshard.live", duration_s=downtime, step=at_step, chips=new_chips,
                      outcome="ok", moved_mb=moved_mb)
        ctl.reply(msg, outcome="ok", step=at_step, downtime_s=round(downtime, 4),
                  chips=new_chips, moved_mb=moved_mb)
        live = {k: v for k, v in reshard_runtime.mesh_axes(mesh).items() if v > 1}
        say(f"live reshard at step {at_step}: mesh -> {live} ({new_chips} devices, "
            f"downtime {downtime:.3f}s); live reshard: resumed at step {at_step + 1}",
            flush=True)

    def poll_control():
        """Hold this rank's next RESIZE; answer any other message "failed"."""
        if ctl is None or pending["msg"] is not None:
            return
        cmsg = ctl.poll()
        if cmsg is None:
            return
        if cmsg.get("type") != "RESIZE":
            ctl.reply(cmsg, outcome="failed",
                      error=f"unknown control message {cmsg.get('type')!r}")
            return
        try:
            chips = int(cmsg.get("chips", 0))
        except (TypeError, ValueError):
            chips = 0
        pending.update(msg=cmsg, chips=chips)

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
            poll_control()
            stop, resize, lo, hi = gang_flags()
            if stop:
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
                exit_retryable()
            if resize:
                msg = pending["msg"]
                pending.update(msg=None, chips=0)
                if lo != hi:
                    sync()
                    resize_fallback(msg, step + 1, f"the gang's ranks asked for "
                                                   f"{lo} to {hi} chips")
                handle_resize(msg, step + 1, lo)
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
    except BaseException:
        if mngr is not None:
            mngr.wait_until_finished()  # an interval save in flight lands or raises
        raise
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
    say_memory()
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
