"""Tensor-parallel decode and serving of the port on a gloo gang
(tests/torch_gang.py, one process a device) against the JAX package on the
same mesh of the 8-device CPU platform: the dry run's tp-decode (tensor2·
data4, batch 4, prompt 9, 4 new tokens, int8 KV cache) and tp-serving
(tensor2·data4, 2 slots, max_len 64, prompts of 5, 11 and 8 tokens, 4 new
tokens, here with the int8 KV cache too), plus a ragged decode in bf16 on
tensor2·fsdp4 with a bf16 cache (the fsdp shards gathered once). The same
LlamaConfig.tiny parameters, carried across with utils/convert.py; the JAX
side jits `generate` and runs its `ServingEngine` on the sharded tree. Every
rank's greedy tokens must equal JAX's, and a sampled decode must give the
same tokens on every rank. The refusals of MoE layers and int8 weight trees
under a mesh are checked on a stand-in mesh, before any collective."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from kubedl_tpu.models import decode as jdecode
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models.serving import ServingEngine as JaxEngine
from kubedl_tpu.parallel.mesh import ShardingRules, build_mesh
from kubedl_tpu_torch.models import decode as tdecode
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.models import quant
from kubedl_tpu_torch.models.serving import ServingEngine
from kubedl_tpu_torch.parallel import mesh as tmesh
from torch_gang import run_gang

CASES = {
    "tp_decode_tensor2_data4_int8kv": dict(
        kind="decode", ici={"tensor": 2, "data": 4}, dtype="float32", kv_dtype="int8",
        batch=4, prompt_len=9, new_tokens=4, temperature=0.8, seed=7),
    "tp_decode_tensor2_fsdp4_bf16": dict(
        kind="decode", ici={"tensor": 2, "fsdp": 4}, dtype="bfloat16", kv_dtype=None,
        batch=3, prompt_len=9, new_tokens=4, lengths=[9, 4, 7]),
    "tp_serving_tensor2_data4_int8kv": dict(
        kind="serving", ici={"tensor": 2, "data": 4}, dtype="float32", kv_dtype="int8",
        slots=2, max_len=64, prompt_lens=(5, 11, 8), new_tokens=4),
}


def make_case(name, spec):
    """(the gang's case dict, the JAX side's thunk giving its tokens)."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.dtype(spec["dtype"]), use_flash=False)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(0))
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype=spec["dtype"], use_flash=True)  # the port's flash wrapper (plain on CPU)
    case = dict(name=name, kind=spec["kind"], ici=spec["ici"], config=fields,
                params=jax.device_get(jparams), kv_dtype=spec["kv_dtype"],
                new_tokens=spec["new_tokens"], temperature=spec.get("temperature"),
                seed=spec.get("seed"))
    rng = np.random.default_rng(1)
    if spec["kind"] == "decode":
        case["prompt"] = rng.integers(0, jcfg.vocab_size,
                                      (spec["batch"], spec["prompt_len"])).astype(np.int32)
        lengths = spec.get("lengths")
        case["lengths"] = None if lengths is None else np.asarray(lengths, np.int32)
        case["max_len"] = spec["prompt_len"] + spec["new_tokens"]
    else:
        case["prompts"] = [rng.integers(1, jcfg.vocab_size, size=n).astype(np.int32)
                           for n in spec["prompt_lens"]]
        case.update(slots=spec["slots"], max_len=spec["max_len"])

    def jax_tokens():
        mesh = build_mesh(spec["ici"], devices=jax.devices()[:8])
        specs = jllama.param_specs(jcfg, ShardingRules())
        sharded = jax.tree_util.tree_map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), jparams, specs,
            is_leaf=lambda x: isinstance(x, JP))
        if spec["kind"] == "decode":
            n = None if case["lengths"] is None else jnp.asarray(case["lengths"])
            gen = jax.jit(lambda p, pr, n: jdecode.generate(
                p, pr, jcfg, max_new_tokens=case["new_tokens"], max_len=case["max_len"],
                lengths=n, kv_dtype=case["kv_dtype"]))
            return np.asarray(jax.device_get(gen(sharded, jnp.asarray(case["prompt"]), n))
                              ).tolist()
        eng = JaxEngine(sharded, jcfg, slots=case["slots"], max_len=case["max_len"],
                        kv_dtype=case["kv_dtype"])
        return [list(map(int, x)) for x in eng.serve_all(case["prompts"], case["new_tokens"])]
    return case, jax_tokens


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    built = {name: make_case(name, spec) for name, spec in CASES.items()}
    port, ref = run_gang([c for c, _ in built.values()], 8, tmp_path_factory.mktemp("tp"),
                         meanwhile=lambda: {n: f() for n, (_, f) in built.items()})
    return port, ref


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_gives_the_jax_tokens(name, runs):
    port, ref = runs
    got = port[name]
    assert got["mesh"] == {**{a: 1 for a in got["mesh"]}, **CASES[name]["ici"]}
    assert len(got["ranks"]) == 8
    for rank, out in enumerate(got["ranks"]):
        assert out["greedy"] == ref[name], (rank, out["greedy"], ref[name])


def test_sampled_tokens_agree_across_ranks(runs):
    """Drawn from the gathered logits with a generator seeded alike."""
    ranks = runs[0]["tp_decode_tensor2_data4_int8kv"]["ranks"]
    sampled = [r["sampled"] for r in ranks]
    assert all(s == sampled[0] for s in sampled)
    assert np.asarray(sampled[0]).shape == (4, 4)


def test_tp_engine_holds_the_local_int8_cache(runs):
    """Each rank's cache holds its 1 of 2 KV heads, in int8 with scales."""
    cfg = tllama.LlamaConfig.tiny()
    slots, heads, max_len = 2, 1, 64
    codes, scales = slots * heads * max_len * cfg.head_dim, slots * heads * max_len * 2
    for r in runs[0]["tp_serving_tensor2_data4_int8kv"]["ranks"]:
        assert r["cache_dtype"] == "torch.int8"
        assert r["kv_cache_bytes"] == cfg.n_layers * 2 * (codes + scales)  # K and V


def _stand_in_mesh(**sizes):
    shape = [sizes.get(a, 1) for a in tmesh.AXIS_ORDER]
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER, mesh=np.zeros(shape),
                                 get_local_rank=lambda axis: 0)


def _refused_tree(which):
    if which == "moe":
        cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, n_experts=2)
        return cfg, tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    return cfg, quant.quantize_params(
        tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu"))


@pytest.mark.parametrize("entry", ["generate", "engine"])
@pytest.mark.parametrize("which,match", [("moe", "MoE layers under a mesh"),
                                         ("int8", "int8 weight trees")])
def test_unported_trees_under_a_mesh_are_refused(entry, which, match):
    cfg, params = _refused_tree(which)
    mesh = _stand_in_mesh(tensor=2)
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md"):
        if entry == "generate":
            tdecode.generate(params, torch.ones((1, 4), dtype=torch.int32), cfg, 2, mesh=mesh)
        else:
            ServingEngine(params, cfg, slots=1, max_len=16, mesh=mesh)
