"""kubedl_tpu_torch/parallel/mesh.py against kubedl_tpu/parallel/mesh.py:
the KUBEDL_MESH / KUBEDL_DCN_MESH parsers, the -1 fill and the errors, case
by case against the JAX package's build_mesh / build_mesh_from_env on the
8-device CPU platform; and ShardingRules.spec and the DTensor placements
of every leaf of param_specs (dense, MoE, QKV bias, post-block norms)
against the JAX package's PartitionSpecs."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import types

import jax
import numpy as np
import pytest

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel import mesh as jmesh
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel import mesh

# (KUBEDL_MESH, KUBEDL_DCN_MESH or None, devices)
ENV_CASES = {
    "unset": ("", None, 4),
    "data_fsdp": ("data=2,fsdp=4", None, 8),
    "fill": ("data=-1,tensor=2", None, 8),
    "spaces": (" data = 2 , ,fsdp=2", None, 4),
    "all_axes": ("data=1,fsdp=2,stage=1,tensor=2,context=1,expert=2", None, 8),
    "too_many": ("data=2", None, 1),
    "too_few": ("data=2,fsdp=2", None, 8),
    "fill_not_divisible": ("fsdp=-1,tensor=3", None, 8),
    "two_fills": ("data=-1,fsdp=-1", None, 8),
    "unknown_axis": ("bogus=2", None, 8),
    "hybrid": ("fsdp=2,tensor=2", "data=2", 8),
    "hybrid_fill": ("fsdp=-1", "data=2", 8),
    "hybrid_default_fill": ("", "data=2", 8),
    "hybrid_not_divisible": ("fsdp=-1", "data=3", 8),
    "hybrid_mismatch": ("fsdp=2", "data=2", 8),
    "dcn_zero": ("fsdp=2", "data=0", 8),
    "dcn_unknown": ("fsdp=2", "rows=2", 8),
}


def _run(fn):
    try:
        return fn(), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("name", list(ENV_CASES))
def test_mesh_env_matches_the_jax_package(name, monkeypatch):
    value, dcn, n = ENV_CASES[name]
    monkeypatch.setenv("KUBEDL_MESH", value)
    if dcn is None:
        monkeypatch.delenv("KUBEDL_DCN_MESH", raising=False)
    else:
        monkeypatch.setenv("KUBEDL_DCN_MESH", dcn)
    ref, ref_err = _run(lambda: dict(jmesh.build_mesh_from_env(devices=jax.devices()[:n]).shape))
    mine, err = _run(lambda: mesh.mesh_from_env(n))
    assert (err is None) == (ref_err is None), (err, ref_err)
    if err is None:
        assert mine == {a: ref.get(a, 1) for a in mesh.AXIS_ORDER}
    elif "hybrid mesh" not in ref_err:  # that one prints the sizes its own way
        assert err == ref_err
    # the parsers alone
    p, p_err = _run(lambda: mesh.parse_mesh_env(value))
    r, r_err = _run(lambda: jmesh.parse_mesh_env(value))
    assert (p, p_err) == (r, r_err)
    p, p_err = _run(lambda: mesh.parse_dcn_mesh_env(dcn or ""))
    r, r_err = _run(lambda: jmesh.parse_dcn_mesh_env(dcn or ""))
    assert (p, p_err) == (r, r_err)


CONFIGS = {
    "dense": {},
    "moe": {"n_experts": 4},
    "qkv_bias": {"attn_qkv_bias": True},
    "post_block_norms": {"post_block_norms": True, "tie_embeddings": True},
}


def _pairs(a, b, path="specs"):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}[{i}]")
    else:
        yield path, a, b


@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_specs_and_placements_match_the_jax_package(name):
    from torch.distributed.tensor import Replicate, Shard

    jcfg = jllama.LlamaConfig.tiny(**CONFIGS[name])
    cfg = llama.LlamaConfig.tiny(**CONFIGS[name])
    ref = jax.tree_util.tree_map(lambda s: s, jllama.param_specs(jcfg),
                                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    # a stand-in mesh: placements read only the dim names and sizes
    sizes = {"data": 2, "fsdp": 2, "stage": 1, "tensor": 2, "context": 1, "expert": 2}
    fake = types.SimpleNamespace(mesh_dim_names=mesh.AXIS_ORDER,
                                 mesh=np.zeros([sizes[a] for a in mesh.AXIS_ORDER]))
    n = 0
    for path, spec, want in _pairs(llama.param_specs(cfg), ref):
        assert tuple(spec) == tuple(want), path
        got = mesh.placements(fake, spec)
        expect = [Replicate()] * len(mesh.AXIS_ORDER)
        for d, entry in enumerate(want):
            for axis in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                if sizes[axis] > 1:
                    expect[mesh.AXIS_ORDER.index(axis)] = Shard(d)
        assert got == expect, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))


def _fake_mesh(**sizes):
    """A stand-in DeviceMesh for the checks that run before any collective:
    dim names, sizes and this rank's coordinates (all 0)."""
    shape = [sizes.get(a, 1) for a in mesh.AXIS_ORDER]
    return types.SimpleNamespace(mesh_dim_names=mesh.AXIS_ORDER, mesh=np.zeros(shape),
                                 get_local_rank=lambda axis: 0)


# a context axis was refused here until context parallelism was ported:
# `_Par` now builds on tensor x context (tests/test_torch_context.py holds
# the context mesh against JAX)
@pytest.mark.parametrize("sizes,error,match", [
    ({"tensor": 4}, ValueError, "n_kv_heads"),       # tiny: 2 kv heads over 4 ranks
])
def test_a_mesh_the_model_cannot_take_is_refused(sizes, error, match):
    import torch

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((2, 9), dtype=torch.int32)
    with pytest.raises(error, match=match):
        llama.loss_fn(params, tokens, cfg, mesh=_fake_mesh(**sizes))


def test_par_builds_on_a_tensor_and_context_mesh():
    import torch

    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    par = llama._Par(_fake_mesh(tensor=2, context=2), mesh.ShardingRules(), cfg)
    assert (par.tp, par.n_tp, par.seq, par.n_ctx, par.ctx_index) == (
        ("tensor",), 2, ("context",), 2, 0)
    assert par.partial_axes == ("context",)  # gradients are parts over context


@pytest.mark.parametrize("ctx", [1, 2, 4])
def test_seq_block_keeps_the_next_token(ctx):
    import torch

    tokens = torch.arange(2 * 9).reshape(2, 9)
    blocks = []
    for i in range(ctx):
        fake = _fake_mesh(context=ctx)
        fake.get_local_rank = lambda axis, i=i: i if axis == "context" else 0
        assert mesh.seq_index(fake, mesh.ShardingRules()) == (i if ctx > 1 else 0, ctx)
        blocks.append(mesh.seq_block(tokens, fake, mesh.ShardingRules()))
    # each block's own shift gives its inputs and targets; together the global ones
    assert torch.equal(torch.cat([b[:, :-1] for b in blocks], 1), tokens[:, :-1])
    assert torch.equal(torch.cat([b[:, 1:] for b in blocks], 1), tokens[:, 1:])
    if ctx > 1:
        with pytest.raises(ValueError, match="seq_len - 1 must divide"):
            mesh.seq_block(tokens[:, :8], _fake_mesh(context=ctx), mesh.ShardingRules())
