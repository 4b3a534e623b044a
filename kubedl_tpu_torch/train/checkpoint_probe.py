"""Where a checkpoint write's time goes on the card's host: one state on
the card (a named model's parameters and its AdamW moments) written as
`state.pt` six ways, each followed by an fsync:

* cuda_file: torch.save of the live CUDA tensors into a file object (the
  port's synchronous save before its saves became asynchronous);
* pinned_path / pinned_file: CheckpointManager's snapshot (page-locked
  buffers) saved by path (torch.save's own file writer) or into a file
  object (what the manager's writer does);
* pageable_path: plain `.cpu()` copies saved by path;
* pinned_path_nocrc: as pinned_path without the zip records' CRC32;
* raw: the page-locked buffers' bytes written as they are.

    python -m kubedl_tpu_torch.train.checkpoint_probe [--model bench-1b] [--dir DIR]

Each line gives the save's and the fsync's seconds and GB/s, beside the
card's name and power limit. Nothing here runs on a program's path.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="bench-1b", choices=("tiny", "bench-1b", "llama-7b"))
    p.add_argument("--dir", default=os.path.join("build", "checkpoint-probe"),
                   help="scratch directory (removed at the end)")
    args = p.parse_args(argv)

    import torch
    from torch.utils.serialization import config as ser

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import checkpoint
    from kubedl_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    cfg = {"tiny": llama.LlamaConfig.tiny, "bench-1b": llama.LlamaConfig.bench_1b,
           "llama-7b": llama.LlamaConfig.llama_7b}[args.model]()
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(3e-4, weight_decay=0.01))
    init_state, _ = make_train_step(lambda q, b: llama.loss_fn(q, b, cfg), tx)
    state = init_state(llama.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
    payload = {"params": state.params, "opt_state": state.opt_state, "step": 0}
    gb = sum(t.nbytes for t in checkpoint._tensors(payload)) / 1e9
    shutil.rmtree(args.dir, ignore_errors=True)
    os.makedirs(args.dir)
    print(f"checkpoint probe [{smi}]: {args.model} state {gb:.2f} GB", flush=True)

    def case(name, write):
        path = os.path.join(args.dir, name)
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            write(f, path)
        t1 = time.perf_counter()
        fd = os.open(path, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        t2 = time.perf_counter()
        os.remove(path)
        print(f"{name} [{smi}]: save {t1 - t0:.2f} s ({gb / (t1 - t0):.2f} GB/s), fsync "
              f"{t2 - t1:.2f} s, together {gb / (t2 - t0):.2f} GB/s", flush=True)

    def by_path(obj):
        return lambda f, path: torch.save(obj, path)

    def to_file(obj):
        return lambda f, path: torch.save(obj, f)

    def raw(f, path):
        for v in pinned.views:
            f.write(memoryview(v.reshape(-1).view(torch.uint8).numpy()))

    with torch.no_grad():
        case("cuda_file", to_file(payload))
        mngr = checkpoint.CheckpointManager(args.dir)
        t0 = time.perf_counter()
        snap = mngr._snapshot(payload)  # registers the buffers
        t1 = time.perf_counter()
        snap = mngr._snapshot(payload)
        t2 = time.perf_counter()
        pinned = mngr._pinned
        print(f"snapshot [{smi}]: first (buffers registered) {t1 - t0:.2f} s, again "
              f"{(t2 - t1) * 1e3:.1f} ms", flush=True)
        case("pinned_path", by_path(snap))
        case("pinned_file", to_file(snap))
        t0 = time.perf_counter()
        page = checkpoint._rebuild(payload, lambda t: t.detach().cpu())
        print(f"pageable copy [{smi}]: {time.perf_counter() - t0:.2f} s", flush=True)
        case("pageable_path", by_path(page))
        ser.save.compute_crc32 = False
        try:
            case("pinned_path_nocrc", by_path(snap))
        finally:
            ser.save.compute_crc32 = True
        case("raw", raw)
    shutil.rmtree(args.dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
