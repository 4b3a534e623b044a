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
  route's routing and dispatch integers of layer 0's first forward) and
  checkpoint (a directory: every rank saves the sharded state after the
  last step through train/checkpoint.py's CheckpointManager, asynchronously,
  takes one more step in place over the live state while the write is in
  flight, waits, and restores the saved step into a fresh state; "restored"
  holds its parameters and step, and "moved" the live state's after the
  extra step; "params" and "step" stay those of the saved state).

Each rank takes its rows of every global batch (parallel/mesh.py
`token_index`), runs `make_train_step` on its DeviceMesh and reports the
loss and grad norm of each micro-step, the first micro-step's gradients and
the parameters after the last, gathered to their full shapes and laid out
as the case's parameter tree.

A case with kind "lora" (params, adapters, batches, lr, clip, rank,
alpha) runs models/lora.py `make_lora_step` on the mesh from the given
adapters and returns every rank's losses, grad norms and adapters after
the last step, whether the adapters stayed replicated and whether the base
tree stayed unchanged.

A case with kind "decode" (prompt, optional lengths, new_tokens, max_len,
kv_dtype, and temperature/seed for a sampled run beside the greedy one)
runs `decode.generate` on the sharded tree; kind "serving" (prompts,
slots, max_len, new_tokens, kv_dtype) runs a `ServingEngine` on it. Every
rank runs the whole batch, and every rank's tokens come back.

A case with kind "vit" (config: ViTConfig fields, params, images, labels,
lr) runs one models/vit.py step of `make_train_step` with AdamW (decay
1e-4) on the mesh, and returns the loss, grad norm, gradients and the
parameters after, gathered to their full shapes. Kind "lookup" (table,
ids, weights, cotangent: global numpy arrays) runs models/embedding.py
`sparse_lookup` on the mesh for the sum, the weighted mean and the
unpooled lookup, and returns each output gathered to the global batch,
each table gradient of sum(output * cotangent) gathered to the table's
shape, and whether a table whose rows do not divide raised.

A case with kind "pipeline" (config, params: the per-layer tree, batch: a
global [B, T] array, microbatches, schedule, interleave, lr, clip) runs
one models/llama.py `loss_fn_pp` step of `make_train_step` on the stacked
parameters of its stage mesh, each rank on its part of the reference's
microbatches, and returns the loss, grad norm, gradients and parameters
after, gathered to their full stacked shapes.

A case with kind "attention" (fn "ring" or "ulysses", causal, q, k, v and
cotangent: global [B, H, T, D] numpy arrays) runs ops/ring_attention.py or
ops/ulysses.py on each rank's rows and sequence block and returns the
output and the q, k, v gradients of sum(output * cotangent), assembled to
the global shapes, or the ValueError's message when the call raises.

A case with kind "reshard" (config, params, ici, batch, lr) runs one
AdamW step on the mesh and returns `leaves_from_state`, every state leaf
gathered to its full shape (by path) and `state_digest`; with "stage"
(dir, chips) every rank then stages its blocks for that chip count
(train/reshard_runtime.py) and rank 0 publishes the manifest; with
"move_to" (mesh axes) the state then moves onto that mesh over the same
ranks with `reshard_state` and is gathered again, and one more step runs
there. Before that, `live_resize` to the gang's own size keeps it in
place (the same mesh, nothing moved) and it is gathered. With "restore" (a staging dir) the case builds the state on its
mesh from `params` and overwrites it from the staging through
`restore_staged` and `state_from_staging` instead, and returns it gathered.

The default case takes each rank's columns of its rows too (parallel/
mesh.py `seq_block`), so a mesh with a context axis trains on its
sequence blocks. This module imports no JAX.
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


def _lora_case(case):
    """make_lora_step on the case's mesh: every rank's numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from kubedl_tpu_torch.models import llama, lora
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, token_index
    from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

    rules = ShardingRules()
    mesh = build_mesh(case["ici"])
    cfg = config_from_fields(**case["config"])
    tok, n_tok = token_index(mesh, rules)
    tx = optim.chain(optim.clip_by_global_norm(case["clip"]),
                     optim.adamw(case["lr"], weight_decay=0.01))
    base = params_from_numpy(case["params"])
    before = [t.clone() for t in llama.tree_leaves(base)]
    _, init_state, step = lora.make_lora_step(base, cfg, tx, mesh, rules=rules,
                                              rank=case["rank"], alpha=case.get("alpha"))
    state = init_state(params_from_numpy(case["adapters"]))
    losses, norms = [], []
    for batch in case["batches"]:
        rows = batch.shape[0] // n_tok
        local = torch.from_numpy(np.ascontiguousarray(batch[tok * rows:(tok + 1) * rows]))
        state, m = step(state, local)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    leaves = list(llama.tree_leaves(state.params))
    out = {"loss": losses, "grad_norm": norms,
           "adapters": [p.detach().to_local().numpy() for p in leaves],
           "adapters_replicated": all(
               isinstance(p, DTensor) and all(isinstance(pl, Replicate) for pl in p.placements)
               for p in leaves),
           "base_unchanged": all(torch.equal(a, b)
                                 for a, b in zip(before, llama.tree_leaves(base)))}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)
    return {"ranks": ranks, "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}


def _local_rows(x, mesh, rules):
    """This rank's token block of a global numpy batch, as a tensor."""
    import numpy as np
    import torch

    from kubedl_tpu_torch.parallel.mesh import token_index

    tok, n_tok = token_index(mesh, rules)
    rows = x.shape[0] // n_tok
    return torch.from_numpy(np.ascontiguousarray(x[tok * rows:(tok + 1) * rows]))


def _gathered_rows(x, mesh, rules):
    """Every token block's rows of x, in block order (numpy)."""
    import numpy as np
    import torch.distributed as dist

    from kubedl_tpu_torch.parallel.mesh import token_index

    blocks = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, (token_index(mesh, rules)[0], x.detach().numpy()))
    return np.concatenate([b for _, b in sorted(dict(blocks).items())])


def _vit_case(case):
    import torch

    from kubedl_tpu_torch.models import llama, vit
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.utils.convert import params_from_numpy, torch_dtype

    rules = ShardingRules()
    mesh = build_mesh(case["ici"])
    cfg = vit.ViTConfig(**dict(case["config"], dtype=torch_dtype(case["config"]["dtype"])))
    batch = (_local_rows(case["images"], mesh, rules), _local_rows(case["labels"], mesh, rules))

    def loss(p, b):
        return vit.loss_fn(p, b, cfg, mesh=mesh, rules=rules)

    init_state, train_step = make_train_step(
        loss, optim.adamw(case["lr"], weight_decay=1e-4), mesh, vit.param_specs(cfg, rules),
        (rules.spec("batch", None, None, None), rules.spec("batch")), rules)
    state = init_state(params_from_numpy(case["params"]))
    leaves = list(llama.tree_leaves(state.params))
    with torch.enable_grad():
        grads = torch.autograd.grad(loss(state.params, batch), leaves)
    full = [g.full_tensor().numpy() for g in grads]
    state, m = train_step(state, batch)
    params = [p.detach().full_tensor().numpy() for p in llama.tree_leaves(state.params)]
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": _like(case["params"], full), "params": _like(case["params"], params),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}


def _lookup_case(case):
    import torch

    from kubedl_tpu_torch.models import embedding
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, shard_tensor

    rules = ShardingRules()
    mesh = build_mesh(case["ici"])
    ids, weights = (_local_rows(case[k], mesh, rules) for k in ("ids", "weights"))
    out = {"out": {}, "grad": {}}
    for name, combiner, w in (("sum", "sum", None), ("mean", "mean", weights),
                              ("unpooled", None, None)):
        table = shard_tensor(torch.from_numpy(case["table"]), mesh,
                             embedding.table_spec()).requires_grad_(True)
        got = embedding.sparse_lookup(table, ids, mesh, weights=w, combiner=combiner)
        cot = _local_rows(case["cotangent"][name], mesh, rules)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad((got * cot).sum(), [table])
        out["out"][name] = _gathered_rows(got, mesh, rules)
        out["grad"][name] = grad.full_tensor().numpy()
    try:
        unpadded = torch.zeros((case["table"].shape[0] - 1, case["table"].shape[1]))
        embedding.sparse_lookup(unpadded, ids, mesh)
        out["unpadded_raises"] = False
    except ValueError as e:
        out["unpadded_raises"] = "not divisible" in str(e)
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return out


def _pipeline_case(case):
    """One models/llama.py `loss_fn_pp` step of `make_train_step` on the
    case's stage mesh, and `forward_pipelined`'s logits before it: the
    rank's rows are its part of each of the reference's microbatches
    (parallel/pipeline.py `local_rows`)."""
    import numpy as np
    import torch

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim, pipeline
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, token_index
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

    rules = ShardingRules()
    mesh = build_mesh(case["ici"])
    cfg = config_from_fields(**case["config"])
    tok, n_tok = token_index(mesh, rules)
    n_micro = case["microbatches"]
    batch = case["batch"]
    rows = pipeline.local_rows(batch.shape[0], n_micro, tok, n_tok)
    local = torch.from_numpy(np.ascontiguousarray(batch[rows]))

    def loss(p, b):
        return llama.loss_fn_pp(p, b, cfg, mesh, rules=rules, n_microbatches=n_micro,
                                schedule=case["schedule"], interleave=case["interleave"])

    tx = optim.chain(optim.clip_by_global_norm(case["clip"]),
                     optim.adamw(case["lr"], weight_decay=0.01))
    init_state, train_step = make_train_step(loss, tx, mesh, llama.param_specs_pp(cfg, rules),
                                             rules.spec("batch", None), rules)
    state = init_state(llama.stack_params(params_from_numpy(case["params"])))
    with torch.no_grad():  # the last stage's logits of this rank's rows, on every stage
        logits = llama.forward_pipelined(state.params, local[:, :-1], cfg, mesh, rules=rules,
                                         n_microbatches=n_micro, schedule=case["schedule"],
                                         interleave=case["interleave"])
    leaves = list(llama.tree_leaves(state.params))
    with torch.enable_grad():
        grads = torch.autograd.grad(loss(state.params, local), leaves)
    full = [g.full_tensor().numpy() for g in grads]
    state, m = train_step(state, local)
    params = [p.detach().full_tensor().numpy() for p in llama.tree_leaves(state.params)]
    return {"loss": [float(m["loss"])], "grad_norm": [float(m["grad_norm"])],
            "grads": _like(state.params, full), "params": _like(state.params, params),
            "logits": logits.numpy(), "rows": rows,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}


def _attention_case(case):
    """Ring or Ulysses attention on this rank's block of the global q, k, v;
    the output and gradients of every block, assembled on every rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.ops.ring_attention import ring_attention
    from kubedl_tpu_torch.ops.ulysses import ulysses_attention
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh, seq_index, token_index

    rules = ShardingRules()
    mesh = build_mesh(case["ici"])
    (r, nr), (c, nc) = token_index(mesh, rules), seq_index(mesh, rules)
    b, t = case["q"].shape[0] // nr, case["q"].shape[2] // nc
    rows, cols = slice(r * b, (r + 1) * b), slice(c * t, (c + 1) * t)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(case[n][rows, :, cols])).requires_grad_(True)
               for n in ("q", "k", "v"))
    fn = ring_attention if case["fn"] == "ring" else ulysses_attention
    try:
        out = fn(q, k, v, mesh=mesh, causal=case["causal"])
    except ValueError as e:
        return {"raised": str(e)}
    cot = torch.from_numpy(np.ascontiguousarray(case["cotangent"][rows, :, cols]))
    with torch.enable_grad():
        grads = torch.autograd.grad((out * cot).sum(), [q, k, v])
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (rows, cols, [x.detach().numpy() for x in (out, *grads)]))
    full = [np.zeros_like(case["q"]) for _ in range(4)]
    for rs, cs, arrays in parts:
        for f, a in zip(full, arrays):
            f[rs, :, cs] = a
    return {"out": full[0], "dq": full[1], "dk": full[2], "dv": full[3],
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}


def _gathered_state(state, specs):
    """path -> the leaf's full array (numpy) or counter (int)."""
    from torch.distributed.tensor import DTensor

    from kubedl_tpu_torch.parallel.reshard import state_leaves

    out = {}
    for leaf in state_leaves(state, specs):
        v = leaf.value
        if isinstance(v, DTensor):
            v = v.full_tensor()
        out[leaf.path] = v if isinstance(v, int) else v.detach().numpy().copy()
    return out


def _reshard_case(case):
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import ShardingRules, build_mesh
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import reshard_runtime as rt
    from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

    rules = ShardingRules()
    mesh = build_mesh(case["ici"])
    cfg = config_from_fields(**case["config"])
    specs = llama.param_specs(cfg, rules)
    tx = optim.adamw(case["lr"], weight_decay=0.01)

    def step_on(m):
        def loss(p, b):
            return llama.loss_fn(p, b, cfg, mesh=m, rules=rules)
        return make_train_step(loss, tx, m, specs, rules.spec("batch", None), rules)

    init_state, train_step = step_on(mesh)
    state = init_state(params_from_numpy(case["params"]))
    out = {"mesh": rt.mesh_axes(mesh)}
    if case.get("restore"):
        staged = rt.restore_staged(case["restore"], rt.mesh_pod(mesh), dist.get_world_size(),
                                   expect_axes=case["ici"])
        assert staged is not None, "the staging did not validate"
        state = rt.state_from_staging(staged[2], state, specs)
        out.update(step=staged[0], state=_gathered_state(state, specs),
                   digest=rt.state_digest(state, specs))
        return out
    local = _local_rows(case["batch"], mesh, rules)
    state, m = train_step(state, local)
    out.update(loss=float(m["loss"]),
               leaves={p: (shape, item, tuple(spec)) for p, (shape, item, spec)
                       in rt.leaves_from_state(state, specs).items()},
               state=_gathered_state(state, specs), digest=rt.state_digest(state, specs))
    if case.get("stage"):
        d, chips = case["stage"]["dir"], case["stage"]["chips"]
        old = rt.mesh_axes(mesh)
        plan = rt.plan_reshard(rt.leaves_from_state(state, specs), old,
                               rt.refit_axes(old, chips), dist.get_world_size(), chips)
        rt.stage_shards(d, plan, rt.mesh_pod(mesh),
                        rt.provider_from_blocks(rt.addressable_blocks(state, specs)),
                        state.step)
        dist.barrier()
        if rt.mesh_pod(mesh) == 0:
            assert rt.write_manifest(d, plan, state.step, dist.get_world_size(), timeout=10)
        dist.barrier()
        out["plan"] = dict(moved=plan.moved_bytes, local=plan.local_bytes,
                           digest=plan.digest())
    # the in-process lane at the gang's own size: the refit mesh is the same
    mesh, state, plan = rt.live_resize(state, mesh, dist.get_world_size(), specs)
    out.update(live_mesh=rt.mesh_axes(mesh), live_moved=plan.moved_bytes,
               live_state=_gathered_state(state, specs))
    if case.get("move_to"):
        new_mesh = build_mesh(case["move_to"])
        state = rt.reshard_state(state, new_mesh, specs)
        out["moved_mesh"] = rt.mesh_axes(new_mesh)
        out["moved_state"] = _gathered_state(state, specs)
        _, train_step = step_on(new_mesh)
        state, m = train_step(state, _local_rows(case["batch"], new_mesh, rules))
        out["moved_loss"] = float(m["loss"])
    return out


def _case(case):
    if case.get("kind") == "reshard":
        return _reshard_case(case)
    if case.get("kind") == "attention":
        return _attention_case(case)
    if case.get("kind") == "pipeline":
        return _pipeline_case(case)
    if case.get("kind") == "lora":
        return _lora_case(case)
    if case.get("kind") == "vit":
        return _vit_case(case)
    if case.get("kind") == "lookup":
        return _lookup_case(case)
    if case.get("kind"):
        return _inference_case(case)
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubedl_tpu_torch.models import llama, moe
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import (ShardingRules, build_hybrid_mesh,
                                                build_mesh, seq_block, token_index)
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
        mine = seq_block(batch[tok * rows:(tok + 1) * rows], mesh, rules)
        return torch.from_numpy(np.ascontiguousarray(mine))

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
    step, restored = state.step, None
    if case.get("checkpoint"):
        from kubedl_tpu_torch.train.checkpoint import CheckpointManager

        mngr = CheckpointManager(case["checkpoint"])
        mngr.save(step, state)  # returns once DCP staged the shards
        state, _ = train_step(state, local(case["batches"][-1]))  # in place, mid-write
        mngr.wait_until_finished()
        fresh = init_state(params_from_numpy(case["params"]))
        fresh = mngr.restore(step, fresh)
        restored = [p.detach().full_tensor().numpy() for p in llama.tree_leaves(fresh.params)]
        moved = [p.detach().full_tensor().numpy() for p in llama.tree_leaves(state.params)]
        restored = {"params": _like(case["params"], restored), "step": fresh.step,
                    "moved": _like(case["params"], moved)}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (tok, stats[0] if stats else None))
    per_block = {}
    for t, st in gathered:
        if st is not None:
            per_block[t] = st
    return {"loss": losses, "grad_norm": norms, "grads": _like(case["params"], full),
            "params": _like(case["params"], params),
            "stats": per_block, "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "step": step, "restored": restored}


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
