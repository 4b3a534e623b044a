"""MNIST training program, the minimum end-to-end workload (the port of
kubedl_tpu/train/mnist.py; BASELINE.json's anchor metric is its step/sec).

An MLP classifier (784 -> hidden -> 10) whose products run in bf16, the
loss optax's softmax cross entropy with integer labels, the optimizer Adam
(parallel/optim.py `adam`). The data is synthetic MNIST-shaped: k distinct
batches drawn with numpy from the process id's seed, the steps cycling
through them k a call, k clamped to a divisor of --steps.

Usage (as a pod command; it runs on the card unless --device cpu):
    python -m kubedl_tpu_torch.train.mnist --steps 200 --batch 256

Prints `step/sec` and exits 0. A multi-process job (KUBEDL_NUM_PROCESSES
> 1) exits 2: the reference puts a different batch from each process onto
one global sharding, which waits for one process per local GPU (ROADMAP.md
Queue 1, item 8).
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


def run(args, process_id: int, device) -> Dict:
    """Train as main does: one call of k steps to warm up, then steps / k
    timed calls. Returns the numbers main prints and every step's loss."""
    import numpy as np
    import torch

    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    init_state, train_step = make_train_step(loss_fn, optim.adam(args.lr))
    state = init_state(init_params(args.hidden, device=device))
    k = steps_per_call(args.steps, args.steps_per_call)
    batch = max(args.batch, 1)  # one device a process
    xs, ys = draw_batches(np.random.default_rng(process_id), k, batch)
    batches = [(torch.from_numpy(xs[i]).to(device), torch.from_numpy(ys[i]).to(device))
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

    from kubedl_tpu_torch.train import coordinator

    info = coordinator.process_info()
    if info.num_processes > 1:
        print(f"KUBEDL_NUM_PROCESSES={info.num_processes}: the multi-process MNIST job "
              f"is not ported to kubedl_tpu_torch yet (ROADMAP.md Queue 1, item 8: "
              f"one process per local GPU)", file=sys.stderr)
        return 2

    from kubedl_tpu_torch.utils.device import process_device

    r = run(args, info.process_id, process_device(args.device))
    print(f"steps={r['steps']} batch={r['batch']} loss={r['loss']:.4f} "
          f"step/sec={r['steps'] / r['seconds']:.1f} devices=1", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
