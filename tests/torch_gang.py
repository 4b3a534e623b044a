"""A gloo gang of the port's sharded train step, decode and serving engine,
for the tests that hold them against the JAX package on the same mesh
(tests/test_torch_sharded_*.py, tests/test_torch_tp_decode.py).

`run_gang(cases, world, tmp)` starts `world` processes of this file, each
one rank of a torch.distributed group formed from the operator's env
(KUBEDL_COORDINATOR_ADDRESS, KUBEDL_NUM_PROCESSES, KUBEDL_PROCESS_ID), and
returns rank 0's results by case name. A case is a dict:

  name, ici (and dcn) mesh axes, config (LlamaConfig fields, dtype a name),
  params (a numpy tree), batches (global [B, T] int32 arrays, one a
  micro-step), accum, lr, clip, and optionally stats (capture the dropless
  route's routing and dispatch integers of layer 0's first forward).

Each rank takes its rows of every global batch (parallel/mesh.py
`token_index`), runs `make_train_step` on its DeviceMesh and reports the
loss and grad norm of each micro-step, the first micro-step's gradients and
the parameters after the last, gathered to their full shapes and laid out
as the case's parameter tree.

A case with kind "decode" (prompt, optional lengths, new_tokens, max_len,
kv_dtype, and temperature/seed for a sampled run beside the greedy one)
runs `decode.generate` on the sharded tree; kind "serving" (prompts,
slots, max_len, new_tokens, kv_dtype) runs a `ServingEngine` on it. Every
rank runs the whole batch, and every rank's tokens come back. This module
imports no JAX.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(cases, world: int, tmp, timeout: float = 240.0, meanwhile=None):
    """Run the cases on a gang of `world` processes; rank 0's results.
    `meanwhile()`, when given, runs in this process while the gang works;
    its value comes back second."""
    job = os.path.join(str(tmp), "gang_job.pkl")
    out = os.path.join(str(tmp), "gang_out.pkl")
    with open(job, "wb") as f:
        pickle.dump(cases, f)
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KUBEDL_NUM_PROCESSES=str(world), KUBEDL_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, out], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    logs = []
    side = None
    try:
        side = meanwhile() if meanwhile is not None else None
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(logs[i][-3000:] for i, _ in bad)
    with open(out, "rb") as f:
        return pickle.load(f), side


def _like(tree, leaves):
    """`leaves` (in tree_leaves order) laid out as `tree`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def _inference_case(case):
    """Greedy (and sampled) tokens of every rank for a decode or serving case."""
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import decode, llama
    from kubedl_tpu_torch.models.serving import ServingEngine
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, shard_tree
    from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

    rules = ShardingRules()
    mesh = build_mesh(case["ici"])
    cfg = config_from_fields(**case["config"])
    params = shard_tree(params_from_numpy(case["params"]), mesh, llama.param_specs(cfg, rules))
    out = {}
    if case["kind"] == "decode":
        prompt = torch.from_numpy(case["prompt"])
        lengths = case.get("lengths")
        lengths = None if lengths is None else torch.from_numpy(lengths)

        def run(**kw):
            return decode.generate(params, prompt, cfg, case["new_tokens"],
                                   max_len=case["max_len"], lengths=lengths,
                                   kv_dtype=case["kv_dtype"], mesh=mesh, rules=rules,
                                   **kw).tolist()
        out["greedy"] = run()
        if case.get("temperature"):
            out["sampled"] = run(temperature=case["temperature"],
                                 generator=torch.Generator().manual_seed(case["seed"]))
    else:
        eng = ServingEngine(params, cfg, slots=case["slots"], max_len=case["max_len"],
                            kv_dtype=case["kv_dtype"], mesh=mesh, rules=rules)
        out["greedy"] = eng.serve_all(case["prompts"], case["new_tokens"])
        stats = eng.stats()
        out["kv_cache_bytes"] = stats["kv_cache_bytes"]
        out["cache_dtype"] = str(eng.cache["k"][0].dtype)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    return {"ranks": ranks, "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}


def _case(case):
    if case.get("kind"):
        return _inference_case(case)
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama, moe
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import (ShardingRules, build_hybrid_mesh,
                                                build_mesh, token_index)
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

    rules = ShardingRules()
    if case.get("dcn"):
        mesh = build_hybrid_mesh(case["ici"], case["dcn"])
    else:
        mesh = build_mesh(case["ici"])
    cfg = config_from_fields(**case["config"])
    tok, n_tok = token_index(mesh, rules)

    def local(batch):
        rows = batch.shape[0] // n_tok
        return torch.from_numpy(np.ascontiguousarray(batch[tok * rows:(tok + 1) * rows]))

    def loss(p, b):
        return llama.loss_fn(p, b, cfg, mesh=mesh, rules=rules)

    tx = optim.adamw(case["lr"], weight_decay=0.01)
    if case.get("clip"):
        tx = optim.chain(optim.clip_by_global_norm(case["clip"]), tx)
    init_state, train_step = make_train_step(
        loss, tx, mesh, llama.param_specs(cfg, rules), rules.spec("batch", None), rules,
        accum_steps=case.get("accum", 1))
    state = init_state(params_from_numpy(case["params"]))

    stats = []
    real = moe._dropless_shard_fn
    if case.get("stats"):
        def capture(*a, **kw):
            kw["stats"] = {}
            out = real(*a, **kw)
            if not stats:
                stats.append({k: v.numpy() for k, v in kw["stats"].items()})
            return out
        moe._dropless_shard_fn = capture
    leaves = list(llama.tree_leaves(state.params))
    first = local(case["batches"][0])
    with torch.enable_grad():
        grads = torch.autograd.grad(loss(state.params, first), leaves)
    moe._dropless_shard_fn = real
    full = [g.full_tensor().numpy() for g in grads]
    losses, norms = [], []
    for b in case["batches"]:
        state, m = train_step(state, local(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = [p.detach().full_tensor().numpy() for p in llama.tree_leaves(state.params)]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (tok, stats[0] if stats else None))
    per_block = {}
    for t, st in gathered:
        if st is not None:
            per_block[t] = st
    return {"loss": losses, "grad_norm": norms, "grads": _like(case["params"], full),
            "params": _like(case["params"], params),
            "stats": per_block, "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "step": state.step}


def main(job_path: str, out_path: str) -> int:
    import torch.distributed as dist

    from kubedl_tpu_torch.train import coordinator

    info = coordinator.initialize()
    with open(job_path, "rb") as f:
        cases = pickle.load(f)
    results = {c["name"]: _case(c) for c in cases}
    if info.process_id == 0:
        tmp = out_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(results, f)
        os.replace(tmp, out_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
