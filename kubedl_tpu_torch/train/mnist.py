"""MNIST training program, the minimum end-to-end workload (the port of
kubedl_tpu/train/mnist.py; BASELINE.json's anchor metric is its step/sec).

An MLP classifier (784 -> hidden -> 10) whose products run in bf16, the
loss optax's softmax cross entropy with integer labels, the optimizer Adam
(parallel/optim.py `adam`). The data is synthetic MNIST-shaped: k distinct
batches drawn with numpy from the process id's seed, the steps cycling
through them k a call, k clamped to a divisor of --steps.

A multi-process job (the operator's KUBEDL_COORDINATOR_ADDRESS,
KUBEDL_NUM_PROCESSES, KUBEDL_PROCESS_ID; one device a process, as
train/launch.py places them) trains data-parallel, as the reference does
over every device of every process: the parameters are replicated, the
global batch is --batch rounded down to a multiple of the gang's devices,
each process draws the whole (k, batch, 784) array from its process id's
seed and keeps its own rows of it (what the reference's device_put onto
P(None, "data") keeps on a process's device), and the loss and every
gradient are mean-reduced over the gang. The group is nccl on a card and
gloo on the CPU; processes sharing one card need --backend gloo.

Usage (as a pod command; it runs on the card unless --device cpu):
    python -m kubedl_tpu_torch.train.mnist --steps 200 --batch 256

Each process prints `step/sec ... devices=<the gang's devices>` and exits 0.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=int(os.environ.get("MNIST_STEPS", 100)))
    parser.add_argument("--batch", type=int, default=int(os.environ.get("MNIST_BATCH", 256)))
    parser.add_argument("--hidden", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--steps-per-call", type=int,
                        default=int(os.environ.get("MNIST_STEPS_PER_CALL", 25)),
                        help="distinct batches a call, the steps cycling through them")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                        help="the gang's process group (default nccl on a card, gloo on "
                             "the CPU; gloo for processes sharing one card)")
    return parser.parse_args(argv)


def init_params(hidden: int, seed: int = 0, device="cuda") -> Dict:
    """w1 [784, hidden] and w2 [hidden, 10] normal x 0.02, zero biases, f32:
    drawn on the CPU from one seeded torch generator, then moved."""
    import torch

    from kubedl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {"w1": torch.randn((784, hidden), generator=gen) * 0.02,
              "b1": torch.zeros((hidden,)),
              "w2": torch.randn((hidden, 10), generator=gen) * 0.02,
              "b2": torch.zeros((10,))}
    return {k: v.to(dev) for k, v in params.items()}


def loss_fn(params, batch):
    """batch = (x [B, 784] f32, y [B] int): the MLP in bf16, f32 logits,
    the mean softmax cross entropy (logsumexp less the label's logit)."""
    import torch

    x, y = batch
    bf16 = torch.bfloat16
    h = torch.relu(x.to(bf16) @ params["w1"].to(bf16) + params["b1"].to(bf16))
    logits = (h @ params["w2"].to(bf16) + params["b2"].to(bf16)).float()
    label = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - label).mean()


def gang_loss_fn(mesh, world: int):
    """loss_fn over the gang: every parameter enters the data axis (its
    gradient is summed over the gang) and each rank's mean over its rows is
    summed and divided by the gang's size, so the loss is the global
    batch's mean and each gradient the mean over the gang. Without a mesh
    (one process) it is loss_fn."""
    from kubedl_tpu_torch.parallel import collectives

    def loss(params, batch):
        params = {k: collectives.enter(v, mesh, ("data",)) for k, v in params.items()}
        return collectives.psum(loss_fn(params, batch), mesh, ("data",)) / world

    return loss


def steps_per_call(steps: int, k: int) -> int:
    """k clamped to [1, steps], then down to a divisor of steps."""
    k = max(1, min(k, steps))
    while steps % k:
        k -= 1
    return k


def draw_batches(rng, k: int, batch: int):
    """(xs [k, batch, 784] f32, ys [k, batch] int32) as numpy arrays."""
    import numpy as np

    xs = rng.standard_normal((k, batch, 784), dtype=np.float32)
    ys = rng.integers(0, 10, (k, batch), dtype=np.int32)
    return xs, ys


def run(args, process_id: int, device, mesh=None, rank: int = 0, world: int = 1) -> Dict:
    """Train as main does: one call of k steps to warm up, then steps / k
    timed calls, as rank `rank` of a gang of `world` processes on `mesh`
    (None: one process). Returns the numbers main prints and every step's
    loss (the global batch's)."""
    import numpy as np
    import torch

    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    init_state, train_step = make_train_step(gang_loss_fn(mesh, world), optim.adam(args.lr))
    state = init_state(init_params(args.hidden, device=device))
    k = steps_per_call(args.steps, args.steps_per_call)
    batch = max(args.batch // world * world, world)  # the global batch
    xs, ys = draw_batches(np.random.default_rng(process_id), k, batch)
    mine = slice(rank * batch // world, (rank + 1) * batch // world)
    batches = [(torch.from_numpy(np.ascontiguousarray(xs[i, mine])).to(device),
                torch.from_numpy(np.ascontiguousarray(ys[i, mine])).to(device))
               for i in range(k)]
    losses = []

    def call():
        nonlocal state
        for b in batches:
            state, metrics = train_step(state, b)
            losses.append(metrics["loss"])

    call()
    float(losses[-1])  # the first call, warmed, out of the timing
    t0 = time.perf_counter()
    for _ in range(args.steps // k):
        call()
    loss = float(losses[-1])  # waits for the device
    dt = time.perf_counter() - t0
    return dict(losses=torch.stack(losses).tolist(), loss=loss, seconds=dt, steps=args.steps,
                batch=batch, steps_per_call=k)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch.distributed as dist

    from kubedl_tpu_torch.train import coordinator
    from kubedl_tpu_torch.utils.device import process_device

    info = coordinator.process_info()
    device = process_device(args.device)  # current before NCCL binds to it
    coordinator.initialize(info, backend=args.backend or (
        "nccl" if device.type == "cuda" else "gloo"))
    mesh, rank, world = None, 0, 1
    if dist.is_initialized():
        from kubedl_tpu_torch.parallel.mesh import build_mesh

        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = build_mesh({"data": world}, world, device.type)
    r = run(args, info.process_id, device, mesh, rank, world)
    print(f"steps={r['steps']} batch={r['batch']} loss={r['loss']:.4f} "
          f"step/sec={r['steps'] / r['seconds']:.1f} devices={world}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
