"""MPMD pipeline stage trainer -- the pod entry point for JAXJob
``spec.pipeline.mpmd`` (the port of kubedl_tpu/train/pipeline_trainer.py).

Each pod runs ONE stage program built from the operator-injected
KUBEDL_PP_* env (train/pipeline_runtime.py `runtime_from_env`): its layer
chunk and optimizer state, the 1F1B loop, and the serialized boundary
channels to its ring neighbors. Deliberately NOT the SPMD trainer: stages
never join one torch.distributed group -- the boundary channel is their
only coupling, so two stage processes can share one card.

The endpoint stages (first and last) drive the data: the same synthetic
next-token stream on both (``default_rng(1234)``), so inputs and targets
line up. Every stage draws the same seeded init as one whole-model init
(`init_stage_params`: the other stages' layers are drawn and dropped), so
the stages agree with `llama.init` and no process holds more than its own
stage's parameters.

Checkpoints are stage-local: each stage saves {params, opt_state, step}
under ``<checkpoint>/stage-<i>/`` through train/checkpoint.py and restores
the latest step EVERY stage has (`_common_restore_step`). On SIGTERM a
stage asks the pipeline to stop; the request rides the boundary, so every
stage finishes the same step, saves it, and exits 113 (retryable).

Usage (as a pod command; it runs on the card unless --device cpu):
    python -m kubedl_tpu_torch.train.pipeline_trainer --model tiny --steps 100

The boundary transport is env-selected: DirChannel over
KUBEDL_PP_BOUNDARY_DIR on the local executor, the authenticated socket
plane (KUBEDL_TRANSPORT=socket + KUBEDL_PP_PREV_ADDR/NEXT_ADDR) in kube
mode -- the same boundary bytes either way. Spans go through obs/trace.py
and obs/steps.py, the profiler window through train/profile_window.py.

Limits: one process a stage (a stage over several devices is refused,
ROADMAP.md), synthetic data only (--data-path is refused rather than
silently ignored).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-pipeline-trainer-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"))
    p.add_argument("--steps", type=int, default=int(os.environ.get("KUBEDL_STEPS", 100)))
    p.add_argument("--batch", type=int, default=int(os.environ.get("KUBEDL_BATCH", 8)))
    p.add_argument("--seq-len", type=int, default=int(os.environ.get("KUBEDL_SEQ_LEN", 512)))
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--data-path", default=os.environ.get("KUBEDL_DATA_PATH", ""))
    p.add_argument("--checkpoint-path", default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""))
    p.add_argument("--checkpoint-interval", type=int,
                   default=int(os.environ.get("KUBEDL_CHECKPOINT_INTERVAL", 0)))
    # the profiler window, the SPMD trainer's contract (train/profile_window.py)
    p.add_argument("--profile-dir", default=os.environ.get("KUBEDL_PROFILE_DIR", ""))
    p.add_argument("--profile-steps", type=int,
                   default=int(os.environ.get("KUBEDL_PROFILE_STEPS", 5)))
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def _common_restore_step(ckpt_path: str, n_stages: int):
    """Latest checkpoint step present in EVERY stage's dir (None = some
    stage has none -- the gang starts fresh together; identical init seeds
    keep that consistent). Step dirs are published by an atomic rename
    (train/checkpoint.py), so a digit-named dir is a whole save."""
    steps = None
    for s in range(n_stages):
        d = os.path.join(ckpt_path, f"stage-{s}")
        try:
            have = {int(x) for x in os.listdir(d) if x.isdigit()}
        except OSError:
            return None
        steps = have if steps is None else steps & have
        if not steps:
            return None
    return max(steps)


def main(argv=None) -> int:
    import time

    started_at = time.time()  # the boundary purge keeps messages newer than this
    t_main0 = time.perf_counter()
    args = parse_args(argv)
    if args.data_path:
        print("pipeline_trainer supports synthetic data only for now "
              "(--data-path would need per-endpoint shard loaders)", file=sys.stderr)
        return 2  # permanent config error (utils/exit_codes.py)

    import numpy as np
    import torch

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.obs.steps import StepStream
    from kubedl_tpu_torch.obs.trace import tracer_from_env
    from kubedl_tpu_torch.ops import _build
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import TrainState
    from kubedl_tpu_torch.train import pipeline_runtime
    from kubedl_tpu_torch.train.checkpoint import CheckpointManager
    from kubedl_tpu_torch.utils.device import process_device
    from kubedl_tpu_torch.utils.exit_codes import EXIT_TPU_PREEMPTED, EXIT_XLA_COMPILE_ERROR

    config = llama.LlamaConfig.config_for(args.model)
    stage = int(os.environ.get("KUBEDL_PP_STAGE", "0"))
    n_stages = int(os.environ.get("KUBEDL_PP_STAGES", "1"))
    device = process_device(args.device)

    # flight recorder: per-stage step spans and the telemetry stream, the
    # stages sharing the job's KUBEDL_TRACE_DIR
    tracer = tracer_from_env()
    step_stream = StepStream.from_env()
    tx = optim.adamw(args.lr, weight_decay=0.01)

    def stage_params(plan, s):
        return pipeline_runtime.init_stage_params(
            config, plan, s, torch.Generator(device=device).manual_seed(0), device=device)

    if config.remat:
        # torch.utils.checkpoint imports torch._dynamo at its first call,
        # seconds in a fresh process. Imported here, the stages import it
        # side by side; left to the first step, the last stage's import and
        # then the first stage's (in its first backward) run one after the
        # other while the neighbor waits.
        import torch._dynamo  # noqa: F401

    try:
        if device.type == "cuda" and config.use_flash:
            _build.build("flash_fwd", "flash_bwd")  # a refused source fails here
        rt = pipeline_runtime.runtime_from_env(config, stage_params, tx,
                                               started_at=started_at)
    except ValueError as e:
        print(f"pipeline config invalid: {e}", file=sys.stderr)
        return 2
    except (torch.OutOfMemoryError, _build.BuildError) as e:
        print(f"compile/alloc failure: {e}", file=sys.stderr)
        return EXIT_XLA_COMPILE_ERROR
    endpoint = stage == 0 or stage == n_stages - 1
    print(f"stage {stage}/{n_stages}: layers {rt.plan.layer_range(stage)} of "
          f"{config.n_layers}, microbatches={rt.plan.n_microbatches}, "
          f"{'endpoint (drives data)' if endpoint else 'middle'}", flush=True)

    state = TrainState(params=rt.params, opt_state=rt.opt_state, step=0)
    mngr = None
    start_step = 0
    if args.checkpoint_path:
        mngr = CheckpointManager(os.path.join(args.checkpoint_path, f"stage-{stage}"),
                                 tracer=tracer)
        # Restore the latest step EVERY stage has, not this stage's own
        # latest: interval saves are per stage and a crash can land between
        # them, so the stages' latest steps may differ -- resuming each at
        # its own would train the gang at mismatched optimizer steps (and
        # leave the tail waiting for steps its peers never run).
        restore = _common_restore_step(args.checkpoint_path, n_stages)
        if restore is not None and os.environ.get("KUBEDL_CHECKPOINT_RESTORE", "1") == "1":
            t_restore0 = time.perf_counter()
            state = mngr.restore(restore, state)
            rt.params, rt.opt_state = state.params, state.opt_state
            start_step = restore
            tracer.record("ckpt.restore", duration_s=time.perf_counter() - t_restore0,
                          step=restore, stage=stage)
            own = mngr.latest_step()
            note = f" (own latest {own})" if own != restore else ""
            print(f"stage {stage}: restored gang-common checkpoint at step {restore}{note}",
                  flush=True)

    ckpt_stall = {"v": 0.0}

    def save(step, final=False):
        if mngr is None:
            return
        t_save0 = time.perf_counter()
        state.params, state.opt_state, state.step = rt.params, rt.opt_state, step
        mngr.save(step, state)  # returns once the state is on the host
        if final:
            mngr.wait_until_finished()  # the write lands before the exit
            print(f"stage {stage}: saved final checkpoint at step {step}", flush=True)
        stall = time.perf_counter() - t_save0
        ckpt_stall["v"] += stall
        tracer.record("ckpt.save", duration_s=stall, step=step, stage=stage, final=final)

    preempted = {"flag": False}
    prev_handler = signal.signal(signal.SIGTERM, lambda *_: preempted.update(flag=True))

    from kubedl_tpu_torch.train.profile_window import window_from_args

    prof = window_from_args(args, start_step)
    tracer.record("trainer.init", duration_s=time.perf_counter() - t_main0,
                  step=start_step, stage=stage, model=args.model)

    rng = np.random.default_rng(1234)  # the same stream on BOTH endpoints
    try:
        for step in range(start_step, args.steps):
            if prof is not None:
                prof.maybe_start(step)
            tokens = None
            if endpoint:
                tokens = rng.integers(0, config.vocab_size, (args.batch, args.seq_len),
                                      dtype=np.int32)
            # the SIGTERM flag rides this step's boundary messages: every
            # stage learns it by the end of the step and stops after it
            rt.request_stop = preempted["flag"]
            out = rt.run_step(tokens)
            if tracer.exporting or step_stream is not None:
                tracer.record(
                    "train.compile" if step == start_step else "pipeline.step",
                    duration_s=out["step_s"], step=step + 1, stage=stage,
                    wait_s=round(out["wait_s"], 6), sent_bytes=out["sent_bytes"],
                    send_s=round(out["send_s"], 6),
                    **({"loss": out["loss"]} if out["loss"] is not None else {}))
                if step_stream is not None:
                    step_stream.record(step + 1, out["step_s"], data_s=out["wait_s"],
                                       loss=out["loss"], compile=step == start_step,
                                       ckpt_s=ckpt_stall["v"])
                    ckpt_stall["v"] = 0.0
            if prof is not None and prof.should_stop(step):
                prof.stop()
            if out["loss"] is not None and (
                    step % args.log_every == 0 or step == args.steps - 1):
                print(f"step {step}: loss={out['loss']:.4f} step_s={out['step_s']:.3f} "
                      f"wait_s={out['wait_s']:.3f}", flush=True)
            if args.checkpoint_interval and (step + 1) % args.checkpoint_interval == 0:
                save(step + 1)
            if out["stop"]:
                if prof is not None:
                    prof.stop()
                save(step + 1, final=True)
                tracer.record("trainer.preempted", step=step + 1, stage=stage)
                print(f"stage {stage}: preempted at step {step + 1}; exiting retryable",
                      flush=True)
                return EXIT_TPU_PREEMPTED
    except BaseException:
        if mngr is not None:
            mngr.wait_until_finished()  # an interval save in flight lands or raises
        raise
    finally:
        # SIGTERM or a raise DURING the traced window still stops the
        # profiler (idempotent: the paths above may have stopped it)
        if prof is not None:
            prof.stop()
        rt.close()
        signal.signal(signal.SIGTERM, prev_handler)
    save(args.steps, final=True)
    if device.type == "cuda":
        from kubedl_tpu_torch.ops.flash_attention import flash_attention as fa

        print(f"stage {stage}: memory: peak allocated "
              f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB; flash launches "
              f"fwd/dq/dkv ({fa.launches}, {fa.bwd_dq_launches}, {fa.bwd_dkv_launches})",
              flush=True)
    tracer.record("trainer.done", step=args.steps, stage=stage)
    if step_stream is not None:
        step_stream.close()
    tracer.close()
    print(f"stage {stage}: done at step {args.steps}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
