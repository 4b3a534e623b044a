"""Sparse-ads training program: the XDLJob workload, SparseCore-style (the
port of kubedl_tpu/train/sparse.py).

A wide-and-deep CTR model (BASELINE.json config 5): the embedding tables
are row-sharded over the mesh's table axis (models/embedding.py) instead of
living on parameter servers, the wide tower is made of dim-1 tables over
the same shards, and the deep tower computes in bf16. The loss is optax's
sigmoid binary cross entropy and the optimizer Adagrad (parallel/optim.py
`adagrad`). The batch is synthetic criteo-shaped multi-hot ids drawn with
numpy in the reference's order, so it equals the reference's bit for bit.

Usage (as a pod command; it runs on the card unless --device cpu):
    python -m kubedl_tpu_torch.train.sparse --steps 100 --batch 4096

A gang (one process per device, as train/trainer.py forms one) honours
KUBEDL_MESH; without it every process sits on the table axis, the
SparseCore partition layout. When the batch axes span every process, each
process draws only its own rows from its process id's seed; otherwise
every process draws the same global batch from seed 0 and trains on its
token block's rows (the reference's rule).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, Optional, Tuple

FEATURE_DEFS = (
    # (name, vocab, dim, multi_hot, combiner)
    ("user_id", 200_000, 32, 1, "sum"),
    ("item_id", 500_000, 32, 1, "sum"),
    ("item_cate", 10_000, 16, 1, "sum"),
    ("behavior_seq", 500_000, 32, 20, "mean"),
)


def features_for(vocab_scale: int = 1, n_shards: int = 1):
    """FEATURE_DEFS as FeatureSpecs, every vocabulary divided by
    `vocab_scale` and at least `n_shards` rows."""
    from kubedl_tpu_torch.models.embedding import FeatureSpec

    return tuple(FeatureSpec(name, max(vocab // vocab_scale, n_shards), dim, mh, comb)
                 for name, vocab, dim, mh, comb in FEATURE_DEFS)


def wide_features(features):
    """The wide tower's features: the same ids on dim-1 tables, summed."""
    from kubedl_tpu_torch.models.embedding import FeatureSpec

    return tuple(FeatureSpec(f.name, f.vocab_size, 1, f.multi_hot, "sum") for f in features)


def init_params(features, hidden: int, n_shards: int = 1, seed: int = 0, device="cuda") -> Dict:
    """{"tables", "wide", "dense"}: drawn on the CPU from one seeded torch
    generator (tables, wide tables, w1, w2 in turn), then moved to
    `device`, so a run on the card and one on the CPU start alike."""
    import torch

    from kubedl_tpu_torch.models.embedding import init_tables
    from kubedl_tpu_torch.models.llama import tree_map
    from kubedl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    emb_dim = sum(f.dim for f in features)
    params = {
        "tables": init_tables(features, n_shards, generator=gen, device="cpu"),
        "wide": {name + "/wide": t for name, t in
                 init_tables(wide_features(features), n_shards, generator=gen,
                             device="cpu").items()},
        "dense": {"w1": torch.randn((emb_dim, hidden), generator=gen) * 0.02,
                  "b1": torch.zeros((hidden,)),
                  "w2": torch.randn((hidden, 1), generator=gen) * 0.02,
                  "b2": torch.zeros((1,))},
    }
    return tree_map(lambda x: x.to(dev), params)


def param_specs(features) -> Dict:
    """Tables and wide tables rows over the table axis; the dense tower
    replicated."""
    from kubedl_tpu_torch.models.embedding import table_spec, table_specs
    from kubedl_tpu_torch.parallel.mesh import P

    return {"tables": table_specs(features),
            "wide": {f.name + "/wide": table_spec() for f in features},
            "dense": {"w1": P(None, None), "b1": P(None), "w2": P(None, None), "b2": P(None)}}


def forward(params, batch_ids, features, mesh=None, rules=None):
    """Logits [B] f32 of this rank's rows: the deep tower in bf16 over the
    pooled embeddings, plus the wide tower's summed dim-1 lookups."""
    import torch

    from kubedl_tpu_torch.models.embedding import lookup_features
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, local_view

    deep = lookup_features(params["tables"], batch_ids, features, mesh)
    wide = {k.replace("/wide", ""): v for k, v in params["wide"].items()}
    wide_logit = lookup_features(wide, batch_ids, wide_features(features), mesh).sum(-1)
    dense = params["dense"]
    if mesh is not None:
        rules = rules or ShardingRules()
        dense = {k: local_view(v, mesh, rules, *([None] * v.dim())) for k, v in dense.items()}
    bf16 = torch.bfloat16
    h = torch.relu(deep.to(bf16) @ dense["w1"].to(bf16) + dense["b1"].to(bf16))
    logit = h @ dense["w2"].to(bf16) + dense["b2"].to(bf16)
    return logit.float().squeeze(-1) + wide_logit


def loss_fn(params, batch, features, mesh=None, rules=None):
    """batch = (ids {feature: [B, L]}, labels [B] f32): the mean sigmoid
    binary cross entropy (optax's), over the global batch on a mesh."""
    import torch.nn.functional as F

    from kubedl_tpu_torch.parallel import collectives
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, token_axes, token_index

    batch_ids, labels = batch
    logits = forward(params, batch_ids, features, mesh, rules)
    labels = labels.to(logits.dtype)
    loss = (-labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)).mean()
    if mesh is None:
        return loss
    rules = rules or ShardingRules()
    _, n_tok = token_index(mesh, rules)
    return collectives.psum(loss / n_tok, mesh, token_axes(rules))


def make_step(features, lr: float, mesh=None, rules=None):
    """(init_state, train_step) of `make_train_step` with Adagrad; a batch
    is (ids, labels) of this rank's rows."""
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.train_step import make_train_step

    def loss(params, batch):
        return loss_fn(params, batch, features, mesh, rules)

    return make_train_step(loss, optim.adagrad(lr), mesh,
                           param_specs(features) if mesh is not None else None)


def draw_batch(rng, features, rows: int) -> Tuple[Dict, "object"]:
    """(ids {feature: [rows, L] int32}, labels [rows] f32) as numpy arrays,
    drawn in the reference's order: per feature the ids, then (multi-hot
    bags) the pad mask, about 30 % of each bag's tail set to -1, its first
    column kept; then the labels."""
    import numpy as np

    batch_ids = {}
    for f in features:
        ids = rng.integers(0, f.vocab_size, (rows, f.multi_hot), dtype=np.int32)
        if f.multi_hot > 1:
            pad = rng.random((rows, f.multi_hot)) < 0.3
            pad[:, 0] = False
            ids[pad] = -1
        batch_ids[f.name] = ids
    labels = rng.integers(0, 2, (rows,)).astype(np.float32)
    return batch_ids, labels


def _positive_int(v):
    iv = int(v)
    if iv < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return iv


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=int(os.environ.get("SPARSE_STEPS", 100)))
    parser.add_argument("--batch", type=int, default=int(os.environ.get("SPARSE_BATCH", 4096)))
    parser.add_argument("--hidden", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument(
        "--vocab-scale", type=_positive_int, default=1,
        help="divide every feature vocab by this (shrinks the synthetic "
        "criteo tables for small runs)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def _mesh_axes(info) -> Tuple[Optional[dict], Optional[str]]:
    """(axis sizes, None) or (None, the reason to exit 2): KUBEDL_MESH /
    KUBEDL_DCN_MESH over the gang, else every process on the table axis."""
    from kubedl_tpu_torch.parallel.mesh import ENV_DCN_MESH, ENV_MESH, resolve_axes
    from kubedl_tpu_torch.train.trainer import _gang_mesh

    if os.environ.get(ENV_MESH) or os.environ.get(ENV_DCN_MESH):
        return _gang_mesh(info)
    if info.num_processes > 1 and info.coordinator_address is None:
        return None, (f"KUBEDL_NUM_PROCESSES={info.num_processes} without "
                      f"KUBEDL_COORDINATOR_ADDRESS: the gang cannot meet")
    return resolve_axes({"tensor": info.num_processes}, info.num_processes), None


def run(args, info, axes, device) -> Dict:
    """Train as main does; returns the numbers main prints and every
    step's loss (the warm-up step's first)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel.mesh import (ENV_DCN_MESH, ENV_MESH, ShardingRules,
                                                build_mesh, build_mesh_from_env, token_index)

    rules = ShardingRules()
    mesh, n, block, n_blocks = None, 1, 0, 1
    if dist.is_initialized():
        n = dist.get_world_size()
        if os.environ.get(ENV_MESH) or os.environ.get(ENV_DCN_MESH):
            mesh = build_mesh_from_env(n, device.type)
        else:
            mesh = build_mesh({"tensor": n}, n, device.type)
        block, n_blocks = token_index(mesh, rules)
    n_shards = axes["tensor"]
    features = features_for(args.vocab_scale, n_shards)
    init_state, train_step = make_step(features, args.lr, mesh, rules)
    state = init_state(init_params(features, args.hidden, n_shards, device=device))

    data_span = axes["data"] * axes["fsdp"]
    split = info.num_processes > 1 and data_span % info.num_processes == 0
    if split:  # each process draws only its own rows
        rng = np.random.default_rng(info.process_id)
        per_proc_span = data_span // info.num_processes
        local_batch = max(max(args.batch, n) // info.num_processes // per_proc_span,
                          1) * per_proc_span
        batch = local_batch * info.num_processes
    else:  # a common seed: every process draws the same global batch
        rng = np.random.default_rng(0)
        batch = local_batch = max(args.batch, n)
    ids, labels = draw_batch(rng, features, local_batch)
    if not split and n_blocks > 1:
        rows = batch // n_blocks
        ids = {k: v[block * rows:(block + 1) * rows] for k, v in ids.items()}
        labels = labels[block * rows:(block + 1) * rows]
    step_batch = ({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in ids.items()},
                  torch.from_numpy(np.ascontiguousarray(labels)).to(device))

    losses = []
    state, metrics = train_step(state, step_batch)
    losses.append(metrics["loss"])
    float(metrics["loss"])  # the first step, built and warmed, out of the timing
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = train_step(state, step_batch)
        losses.append(metrics["loss"])
    loss = float(metrics["loss"])  # waits for the device
    dt = time.perf_counter() - t0
    return dict(losses=torch.stack(losses).tolist(), loss=loss, seconds=dt, steps=args.steps,
                batch=batch, lookups=batch * sum(f.multi_hot for f in features),
                table_shards=n_shards, devices=n)


def main(argv=None) -> int:
    args = parse_args(argv)

    from kubedl_tpu_torch.train import coordinator

    info = coordinator.process_info()
    axes, refused = _mesh_axes(info)
    if refused:
        print(refused, file=sys.stderr)
        return 2

    import torch.distributed as dist

    from kubedl_tpu_torch.utils.device import process_device

    device = process_device(args.device)  # current before NCCL binds to it
    coordinator.initialize(info, backend="nccl" if device.type == "cuda" else "gloo")
    r = run(args, info, axes, device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        dt = r["seconds"]
        print(f"steps={r['steps']} batch={r['batch']} loss={r['loss']:.4f} "
              f"step/sec={r['steps'] / dt:.1f} "
              f"lookups/sec={r['steps'] * r['lookups'] / dt:.3g} "
              f"table_shards={r['table_shards']} devices={r['devices']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
