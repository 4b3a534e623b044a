"""RL fleet pod entry point -- JAXJob ``spec.rl`` (the port's
kubedl_tpu/train/rl_pod.py).

One command for every fleet pod: the operator-injected ``KUBEDL_RL_ROLE``
dispatches to the actor or the learner main. Fleet pods never join one
process group: the trajectory queue and the weight broadcast are their
only coupling.

    python -m kubedl_tpu_torch.train.rl_pod --model tiny --steps 50

``--steps`` counts LEARNER updates; each actor runs ``ceil(steps /
actors)`` generation iterations (one iteration emits ``promptsPerStep``
trajectory groups, the learner's batch), then waits for the learner's
last broadcast and adopts it, so it ends on the final policy.

Transports: DirChannel edges under ``KUBEDL_RL_QUEUE_DIR`` (the
checkpoint volume's ``.rl`` dir) on the local executor, each side purging
the dirs it receives on at start, so a crashed incarnation's messages are
never read as current data; the authenticated socket plane
(``KUBEDL_TRANSPORT=socket``, transport/plane.py: actors dial
``KUBEDL_RL_LEARNER_ADDR``, the learner dials ``KUBEDL_RL_ACTOR_ADDRS``) in
kube mode. The same record bytes either way. Fleet planes keep the boot-id
latch: a restarted peer is refused loudly and the pod exits retryable, so
the whole gang restarts from the learner's checkpoint.

The actors roll out through models/decode.py `generate` or, with
``KUBEDL_RL_ENGINE=serving``, through the paged serving plane
(serving/rollout.py).

Both roles init the base policy from the same seed, so version 0 is
identical fleet-wide without a broadcast; the learner restores its
TrainState from ``<checkpoint>/learner`` (train/checkpoint.py) on restart
and versions restart from 0 with the gang. SIGTERM makes the learner save
its step and exit 113 (retryable), as does a starved or failed fleet;
an actor whose weights stop arriving exits 113 too. Both run on the card
unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
from typing import Dict, List, Optional, Tuple

def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-rl-pod-torch")
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"))
    p.add_argument("--steps", type=int,
                   default=int(os.environ.get("KUBEDL_STEPS", 50)),
                   help="learner update steps")
    p.add_argument("--lr", type=float,
                   default=float(os.environ.get("KUBEDL_RL_LR", 1e-5)))
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--kl-coef", type=float,
                   default=float(os.environ.get("KUBEDL_RL_KL_COEF", 0.04)))
    p.add_argument("--seed", type=int,
                   default=int(os.environ.get("KUBEDL_SEED", 0)))
    p.add_argument("--log-every", type=int, default=5)
    p.add_argument("--data-path",
                   default=os.environ.get("KUBEDL_DATA_PATH", ""))
    p.add_argument("--checkpoint-path",
                   default=os.environ.get("KUBEDL_CHECKPOINT_PATH", ""))
    p.add_argument("--checkpoint-interval", type=int,
                   default=int(os.environ.get("KUBEDL_CHECKPOINT_INTERVAL",
                                              0)))
    p.add_argument("--device", default="cuda",
                   help="torch device of this pod's model (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _rl_env_config(args):
    """The fleet shape from the operator-injected env, validated with the
    rule set of submit (api/validation.py `validate_rl_shapes`), so a
    hand-run pod cannot drift past apply-time validation."""
    from kubedl_tpu_torch.api.validation import validate_rl_shapes

    cfg = {
        "n_actors": _env_int("KUBEDL_RL_ACTORS", 1),
        "actor_index": _env_int("KUBEDL_RL_ACTOR_INDEX", 0),
        "group_size": _env_int("KUBEDL_RL_GROUP_SIZE", 8),
        "prompts_per_step": _env_int("KUBEDL_RL_PROMPTS_PER_STEP", 4),
        "max_new_tokens": _env_int("KUBEDL_RL_MAX_NEW_TOKENS", 32),
        "temperature": float(os.environ.get("KUBEDL_RL_TEMPERATURE", 1.0)),
        "max_weight_lag": _env_int("KUBEDL_RL_MAX_WEIGHT_LAG", 1),
        "broadcast_interval": _env_int("KUBEDL_RL_BROADCAST_INTERVAL", 1),
        "reward": os.environ.get("KUBEDL_RL_REWARD", "token-match"),
        "reward_token": _env_int("KUBEDL_RL_REWARD_TOKEN", 5),
        "target_len": _env_int("KUBEDL_RL_TARGET_LEN", 16),
        "eos_id": _env_int("KUBEDL_RL_EOS_ID", -1),
        "engine": os.environ.get("KUBEDL_RL_ENGINE", "decode"),
    }
    errs = validate_rl_shapes(
        cfg["n_actors"], 1, cfg["group_size"], cfg["max_weight_lag"],
        prompts_per_step=cfg["prompts_per_step"],
        max_new_tokens=cfg["max_new_tokens"],
        temperature=cfg["temperature"],
        broadcast_interval=cfg["broadcast_interval"],
        reward=cfg["reward"], eos_id=cfg["eos_id"],
        rollout_engine=cfg["engine"],
        path="KUBEDL_RL")
    if errs:
        raise ValueError("; ".join(errs))
    return cfg


def channels_from_env(role: str, actor_ids: List[str], env: Optional[Dict[str, str]] = None):
    """(plane, role-side channels) from the injected transport env.

    Actor: ``(plane, traj_send_channel, weight_recv_channel)``. Learner:
    ``(plane, {actor: traj_recv_channel}, [weight_send_channel per
    actor])``. ``plane`` is None on the dir lane (close it on the socket
    lane when done)."""
    env = os.environ if env is None else env
    from kubedl_tpu_torch.rl.trajectory import TRAJECTORY_CHANNEL
    from kubedl_tpu_torch.rl.weights import WEIGHT_CHANNEL
    from kubedl_tpu_torch.transport.plane import ENV_TRANSPORT, plane_from_env

    if env.get(ENV_TRANSPORT, "") == "socket":
        if role == "actor" and not env.get("KUBEDL_RL_LEARNER_ADDR", ""):
            raise ValueError(
                "KUBEDL_TRANSPORT=socket actor needs KUBEDL_RL_LEARNER_ADDR")
        addrs = [a for a in env.get("KUBEDL_RL_ACTOR_ADDRS", "").split(",") if a]
        if role != "actor" and len(addrs) != len(actor_ids):
            raise ValueError(
                f"KUBEDL_RL_ACTOR_ADDRS has {len(addrs)} entries for "
                f"{len(actor_ids)} actors")
        service = env.get("POD_NAME", "") or f"rl-{role}"
        plane = plane_from_env(service=service, latch=True, env=env)
        if role == "actor":
            me = actor_ids[0]
            return (plane,
                    plane.channel(f"{TRAJECTORY_CHANNEL}.{me}",
                                  peer_addr=env["KUBEDL_RL_LEARNER_ADDR"]),
                    plane.channel(WEIGHT_CHANNEL))
        traj = {a: plane.channel(f"{TRAJECTORY_CHANNEL}.{a}") for a in actor_ids}
        weights = [plane.channel(WEIGHT_CHANNEL, peer_addr=addr) for addr in addrs]
        return plane, traj, weights
    root = env.get("KUBEDL_RL_QUEUE_DIR", "")
    if not root:
        raise ValueError(
            "dir transport needs KUBEDL_RL_QUEUE_DIR (injected from "
            "spec.checkpoint by the JAXJob controller)")
    from kubedl_tpu_torch.parallel.pipeline_mpmd import DirChannel

    def recv_dir(path: str) -> DirChannel:
        # the queue dir rides the PERSISTENT checkpoint volume, so a
        # crashed incarnation's undelivered messages survive the
        # whole-gang restart, and tags restart from 1, so they would be
        # consumed as CURRENT data. Purge every dir this side RECEIVES on
        # at startup; each pod purges before it initializes its model,
        # seconds before any peer's first send.
        ch = DirChannel(path)
        purged = ch.purge()
        if purged:
            print(f"purged {purged} stale message(s) from a previous "
                  f"incarnation in {path}", flush=True)
        return ch

    if role == "actor":
        me = actor_ids[0]
        return (None,
                DirChannel(os.path.join(root, f"traj-{me}")),
                recv_dir(os.path.join(root, f"weights-{me}")))
    traj = {a: recv_dir(os.path.join(root, f"traj-{a}")) for a in actor_ids}
    weights = [DirChannel(os.path.join(root, f"weights-{a}")) for a in actor_ids]
    return None, traj, weights


def _base_model(args, device) -> Tuple:
    import torch

    from kubedl_tpu_torch.models import llama

    config = llama.LlamaConfig.config_for(args.model)
    base = llama.init(config, torch.Generator(device=device).manual_seed(args.seed),
                      device=device)
    return config, base


def _prompts(args, config, cfg) -> List[List[int]]:
    import numpy as np

    max_prompt = config.max_seq_len - cfg["max_new_tokens"]
    if args.data_path:
        from kubedl_tpu_torch.train.grpo import load_prompts

        return load_prompts(args.data_path, max_prompt)
    rng = np.random.default_rng(args.seed)
    n = max(cfg["prompts_per_step"] * 4, 16)
    plen = min(16, max_prompt)
    return [list(rng.integers(1, config.vocab_size, plen)) for _ in range(n)]


def _reward_fn(args, cfg):
    """The grpo.py reward family from the injected spec (one rule set:
    train/grpo.py `make_reward_fn`)."""
    from kubedl_tpu_torch.train.grpo import make_reward_fn

    ns = argparse.Namespace(
        reward_module=cfg["reward"] if ":" in cfg["reward"] else "",
        reward=cfg["reward"] if ":" not in cfg["reward"] else "token-match",
        reward_token=cfg["reward_token"],
        target_len=cfg["target_len"],
        max_new_tokens=cfg["max_new_tokens"],
    )
    return make_reward_fn(ns)


def _job() -> str:
    return os.environ.get("KUBEDL_LABEL_JOB_NAME", os.environ.get("POD_NAME", "rl"))


def actor_main(args, cfg, device) -> int:
    from kubedl_tpu_torch.rl.actor import ActorConfig

    job = _job()
    acfg = ActorConfig(
        actor_index=cfg["actor_index"], n_actors=cfg["n_actors"],
        seed=args.seed, group_size=cfg["group_size"],
        prompts_per_step=cfg["prompts_per_step"],
        max_new_tokens=cfg["max_new_tokens"],
        temperature=cfg["temperature"], eos_id=cfg["eos_id"],
        max_weight_lag=cfg["max_weight_lag"],
        lockstep=(cfg["n_actors"] == 1 and cfg["max_weight_lag"] == 0),
        engine=cfg["engine"], job=job)
    plane, traj_ch, weight_ch = channels_from_env("actor", [acfg.actor_id])
    try:
        return _act(args, cfg, device, acfg, job, traj_ch, weight_ch)
    finally:
        if plane is not None:
            plane.close()


def _act(args, cfg, device, acfg, job, traj_ch, weight_ch) -> int:
    from kubedl_tpu_torch.obs.trace import tracer_from_env
    from kubedl_tpu_torch.rl.actor import ActorRuntime
    from kubedl_tpu_torch.rl.trajectory import TrajectoryProducer
    from kubedl_tpu_torch.rl.weights import WeightReceiver
    from kubedl_tpu_torch.transport.plane import TransportError
    from kubedl_tpu_torch.utils.exit_codes import EXIT_TPU_PREEMPTED

    config, base = _base_model(args, device)
    tracer = tracer_from_env()
    actor = ActorRuntime(
        base, config, acfg, _prompts(args, config, cfg), _reward_fn(args, cfg),
        producer=TrajectoryProducer(traj_ch, acfg.actor_id, job=job),
        receiver=WeightReceiver(weight_ch), tracer=tracer)
    del base
    steps = -(-args.steps // cfg["n_actors"])
    # the learner's last broadcast carries this step
    last_step = args.steps - args.steps % cfg["broadcast_interval"]
    preempted = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *_: preempted.update(flag=True))
    print(f"{acfg.actor_id}: {steps} iterations x "
          f"{cfg['prompts_per_step']} groups (G={cfg['group_size']}, "
          f"K={cfg['max_new_tokens']}, engine={cfg['engine']}, "
          f"lockstep={acfg.lockstep})", flush=True)
    try:
        for it in range(1, steps + 1):
            actor.step(it)
            if preempted["flag"]:
                print(f"{acfg.actor_id}: preempted at iteration {it}; "
                      f"exiting retryable", flush=True)
                return EXIT_TPU_PREEMPTED
        actor.finish(last_step)
    except (TransportError, TimeoutError) as e:
        # a refused incarnation or a starved broadcast: the fleet is torn
        # -- exit retryable so the WHOLE gang restarts from the learner's
        # checkpoint
        print(f"{acfg.actor_id}: transport failure: {e}", file=sys.stderr, flush=True)
        return EXIT_TPU_PREEMPTED
    finally:
        tracer.close()
    print(f"{acfg.actor_id}: done — {actor.tokens_generated} tokens, "
          f"final weight version {actor.weight_version} (step {actor.weight_step}), "
          f"learner_starved={actor.learner_starved_s:.2f}s", flush=True)
    return 0


def learner_main(args, cfg, device) -> int:
    job = _job()
    actor_ids = [f"actor-{i}" for i in range(cfg["n_actors"])]
    plane, traj_channels, weight_channels = channels_from_env("learner", actor_ids)
    try:
        return _learn(args, cfg, device, job, traj_channels, weight_channels)
    finally:
        if plane is not None:
            plane.close()


def _learn(args, cfg, device, job, traj_channels, weight_channels) -> int:
    import time

    from kubedl_tpu_torch.obs.trace import tracer_from_env
    from kubedl_tpu_torch.rl.learner import LearnerConfig, LearnerRuntime
    from kubedl_tpu_torch.rl.trajectory import TrajectoryConsumer
    from kubedl_tpu_torch.rl.weights import WeightBroadcaster
    from kubedl_tpu_torch.train.checkpoint import CheckpointManager
    from kubedl_tpu_torch.transport.plane import TransportError
    from kubedl_tpu_torch.utils.exit_codes import EXIT_TPU_PREEMPTED

    config, base = _base_model(args, device)
    tracer = tracer_from_env()
    lcfg = LearnerConfig(
        prompts_per_step=cfg["prompts_per_step"],
        group_size=cfg["group_size"],
        max_weight_lag=cfg["max_weight_lag"],
        broadcast_interval=cfg["broadcast_interval"],
        lr=args.lr, clip_eps=args.clip_eps, kl_coef=args.kl_coef, job=job)
    learner = LearnerRuntime(
        base, config, lcfg,
        consumer=TrajectoryConsumer(traj_channels, job=job),
        broadcaster=WeightBroadcaster(weight_channels), tracer=tracer)
    del base

    mngr = None
    start_step = 0
    if args.checkpoint_path:
        mngr = CheckpointManager(os.path.join(args.checkpoint_path, "learner"), max_to_keep=2,
                                 tracer=tracer)
        latest = mngr.latest_step()
        if latest is not None and os.environ.get("KUBEDL_CHECKPOINT_RESTORE", "1") == "1":
            t0 = time.perf_counter()
            learner.state = mngr.restore(latest, learner.state)
            start_step = latest
            tracer.record("ckpt.restore", duration_s=time.perf_counter() - t0, step=latest)
            print(f"learner: restored policy checkpoint at step {latest}", flush=True)
    done = {"step": start_step, "saved": start_step}

    def save(step, final=False):
        if mngr is None:
            return
        t0 = time.perf_counter()
        fresh = step != done["saved"]  # else: restored, or saved at this step already
        if fresh:
            mngr.save(step, learner.state)  # returns once the state is on the host
            done["saved"] = step
        if final:
            mngr.wait_until_finished()  # the write lands before the exit
        if fresh:
            tracer.record("ckpt.save", duration_s=time.perf_counter() - t0, step=step,
                          final=final)
            print(f"learner: saved policy checkpoint at step {step}", flush=True)

    preempted = {"flag": False}
    signal.signal(signal.SIGTERM, lambda *_: preempted.update(flag=True))
    print(f"learner: {args.steps} updates over {cfg['n_actors']} actors "
          f"(B={cfg['prompts_per_step']}, G={cfg['group_size']}, "
          f"maxWeightLag={cfg['max_weight_lag']})", flush=True)

    def on_step(step, metrics):
        done["step"] = step
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"reward={learner.stats.last_metrics.get('reward', 0):.3f} "
                  f"kl={metrics['kl']:.4f} "
                  f"lag_max={learner.stats.max_lag_observed} "
                  f"stale_dropped={learner.stats.stale_dropped}",
                  flush=True)
        if args.checkpoint_interval and step % args.checkpoint_interval == 0:
            save(step)
        if preempted["flag"]:
            save(step, final=True)
            print(f"learner: preempted at step {step}; exiting retryable", flush=True)
            raise SystemExit(EXIT_TPU_PREEMPTED)

    try:
        stats = learner.run(args.steps - start_step, start=start_step + 1, on_step=on_step)
    except (TransportError, TimeoutError, RuntimeError) as e:
        print(f"learner: fleet failure: {e}", file=sys.stderr, flush=True)
        save(done["step"], final=True)
        return EXIT_TPU_PREEMPTED
    finally:
        tracer.close()
    save(args.steps, final=True)
    print(f"learner: done — {stats.steps} steps, "
          f"consumed={stats.consumed} stale_dropped={stats.stale_dropped} "
          f"max_weight_lag_observed={stats.max_lag_observed} "
          f"published_version={learner.version} "
          f"actor_starved={stats.actor_starved_s:.2f}s "
          f"loss={stats.last_loss:.4f}", flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    role = os.environ.get("KUBEDL_RL_ROLE", "")
    if role not in ("actor", "learner"):
        print(f"KUBEDL_RL_ROLE must be actor|learner (got {role!r}) — "
              f"this entrypoint runs under JAXJob spec.rl",
              file=sys.stderr)
        return 2  # permanent config error
    try:
        cfg = _rl_env_config(args)
    except ValueError as e:
        print(f"rl config invalid: {e}", file=sys.stderr)
        return 2
    from kubedl_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if role == "actor":
        return actor_main(args, cfg, device)
    return learner_main(args, cfg, device)


if __name__ == "__main__":
    sys.exit(main())
