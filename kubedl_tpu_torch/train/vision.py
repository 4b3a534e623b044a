"""Vision training program: ViT classification, the TFJob-style workload
(the port of kubedl_tpu/train/vision.py).

Synthetic imagenet-shaped batches drawn with numpy as the reference draws
them; the compute path is the real one: patchify -> the encoder through
the flash kernels (non-causal) -> `make_train_step` with AdamW (optax's
default decay, 1e-4).

Usage (as a pod command; it runs on the card unless --device cpu):
    python -m kubedl_tpu_torch.train.vision --model tiny --steps 100

A gang: one process per device, formed as train/trainer.py forms one
(KUBEDL_COORDINATOR_ADDRESS / KUBEDL_NUM_PROCESSES / KUBEDL_PROCESS_ID,
KUBEDL_MESH); the batch shards over data and fsdp, heads and MLP over
tensor. Each process draws the global batch from its process id's seed and
trains on its token block's rows.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=os.environ.get("KUBEDL_MODEL", "tiny"),
                   choices=["tiny", "vit-b16"])
    p.add_argument("--steps", type=int, default=int(os.environ.get("KUBEDL_STEPS", 100)))
    p.add_argument("--batch", type=int, default=int(os.environ.get("KUBEDL_BATCH", 64)))
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from kubedl_tpu_torch.train import coordinator
    from kubedl_tpu_torch.train.trainer import _gang_mesh

    info = coordinator.process_info()
    axes, refused = _gang_mesh(info)
    if refused:
        print(refused, file=sys.stderr)
        return 2

    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import vit
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh_from_env, token_index
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.utils.device import process_device

    device = process_device(args.device)  # current before NCCL binds to it
    coordinator.initialize(info, backend="nccl" if device.type == "cuda" else "gloo")
    config = {"tiny": vit.ViTConfig.tiny(), "vit-b16": vit.ViTConfig.base()}[args.model]

    rules = ShardingRules()
    mesh, world, block, n_blocks = None, 1, 0, 1
    if dist.is_initialized():
        world = dist.get_world_size()
        mesh = build_mesh_from_env(world, device.type)
        block, n_blocks = token_index(mesh, rules)

    params = vit.init(config, torch.Generator(device=device).manual_seed(0), device)

    def loss(params, batch):
        return vit.loss_fn(params, batch, config, mesh=mesh, rules=rules)

    init_state, train_step = make_train_step(
        loss, optim.adamw(args.lr, weight_decay=1e-4), mesh,
        vit.param_specs(config, rules) if mesh is not None else None,
        (rules.spec("batch", None, None, None), rules.spec("batch")), rules)
    state = init_state(params)

    rng = np.random.default_rng(info.process_id)
    images = rng.random((args.batch, config.image_size, config.image_size,
                         config.n_channels), dtype=np.float32)
    labels = rng.integers(0, config.n_classes, (args.batch,), dtype=np.int32)
    rows = args.batch // n_blocks
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a[block * rows:(block + 1) * rows]))
                  .to(device) for a in (images, labels))

    state, metrics = train_step(state, batch)
    float(metrics["loss"])  # the first step, built and warmed, out of the timing
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = train_step(state, batch)
    loss_value = float(metrics["loss"])  # waits for the device
    dt = time.perf_counter() - t0
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"steps={args.steps} batch={args.batch} loss={loss_value:.4f} "
              f"step/sec={args.steps / dt:.2f} img/sec={args.steps * args.batch / dt:.0f} "
              f"params={vit.param_count(state.params)} devices={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
