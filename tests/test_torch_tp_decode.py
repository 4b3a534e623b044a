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
same tokens on every rank.

MoE layers and int8 weight trees (ROADMAP.md 12b): a tiny MoE (4 experts,
top 2) in int8 and f32 on expert2·tensor2·data2 with ragged rows, in bf16 on
the same mesh (dropless) and on tensor2·data4 with `moe_dropless=False` (the
capacity route), and a dense int8 tree through the engine with the int8 KV
cache. The port quantizes the whole tree and then shards it; JAX runs
`quant.quantize_params` jitted on its sharded tree. Each rank's local `q`/`s`
views equal the slices of JAX's quantized leaves bit for bit, and each
routing's per-expert counts equal JAX's on one device (jitted `generate`,
counted through `jax.debug.callback`) and are equal on every rank. On a
one-device stand-in mesh, the MoE and int8 trees give the one-device call's
and engine's tokens."""
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
from kubedl_tpu.models import moe as jmoe
from kubedl_tpu.models import quant as jquant
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
    "tp_decode_moe_int8_expert2_tensor2_data2": dict(
        kind="decode", ici={"expert": 2, "tensor": 2, "data": 2}, dtype="float32",
        kv_dtype=None, batch=4, prompt_len=9, new_tokens=4, lengths=[9, 5, 7, 3],
        moe=dict(n_experts=4, expert_top_k=2), int8=True),
    "tp_decode_moe_expert2_tensor2_data2_bf16": dict(
        kind="decode", ici={"expert": 2, "tensor": 2, "data": 2}, dtype="bfloat16",
        kv_dtype=None, batch=4, prompt_len=9, new_tokens=4,
        moe=dict(n_experts=4, expert_top_k=2)),
    "tp_decode_moe_tensor2_data4_bf16": dict(
        kind="decode", ici={"tensor": 2, "data": 4}, dtype="bfloat16", kv_dtype=None,
        batch=4, prompt_len=9, new_tokens=4,
        moe=dict(n_experts=4, expert_top_k=2, moe_dropless=False)),
    "tp_serving_int8_tensor2_data4": dict(
        kind="serving", ici={"tensor": 2, "data": 4}, dtype="float32", kv_dtype="int8",
        slots=2, max_len=64, prompt_lens=(5, 11, 8), new_tokens=4, int8=True),
}
MOE_CASES = [n for n, spec in CASES.items() if "moe" in spec]
# bf16 MoE cases sum their experts' and columns' parts in another order than
# XLA does: a greedy chain may part at a near-tie there, and a parted token
# is judged on JAX's teacher-forced logits along the rank's own path (its
# logit within LOGIT_TOL of the maximum, relative to the largest |logit|:
# the bound that chip_smoke.py holds two bf16 7B paths to)
NEAR_TIE_CASES = [n for n in MOE_CASES if CASES[n]["dtype"] == "bfloat16"]
LOGIT_TOL = 0.05
INT8_CASES = [n for n, spec in CASES.items() if spec.get("int8")]


def make_case(name, spec):
    """(the gang's case dict, the JAX side's thunk giving its tokens)."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.dtype(spec["dtype"]), use_flash=False,
                                   **spec.get("moe", {}))
    jparams = jllama.init(jcfg, jax.random.PRNGKey(0))
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype=spec["dtype"], use_flash=True)  # the port's flash wrapper (plain on CPU)
    case = dict(name=name, kind=spec["kind"], ici=spec["ici"], config=fields,
                params=jax.device_get(jparams), kv_dtype=spec["kv_dtype"],
                new_tokens=spec["new_tokens"], temperature=spec.get("temperature"),
                seed=spec.get("seed"), int8=spec.get("int8", False))
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

    def jax_side():
        """(JAX's tokens on the mesh, its quantized leaves, its one-device
        routing counts)."""
        mesh = build_mesh(spec["ici"], devices=jax.devices()[:8])
        specs = jllama.param_specs(jcfg, ShardingRules())
        sharded = jax.tree_util.tree_map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), jparams, specs,
            is_leaf=lambda x: isinstance(x, JP))
        qleaves = None
        if spec.get("int8"):
            sharded = jax.jit(jquant.quantize_params)(sharded)
            qleaves = jax.device_get(sharded)
        if spec["kind"] == "decode":
            n = None if case["lengths"] is None else jnp.asarray(case["lengths"])

            def gen_on(p):
                return jax.jit(lambda p, pr, n: jdecode.generate(
                    p, pr, jcfg, max_new_tokens=case["new_tokens"], max_len=case["max_len"],
                    lengths=n, kv_dtype=case["kv_dtype"]))(p, jnp.asarray(case["prompt"]), n)
            toks = np.asarray(jax.device_get(gen_on(sharded))).tolist()
            routing = None
            if "moe" in spec:
                one = jquant.quantize_params(jparams) if spec.get("int8") else jparams
                routing = _jax_routing(lambda: jax.block_until_ready(gen_on(one)))
            return toks, qleaves, routing
        eng = JaxEngine(sharded, jcfg, slots=case["slots"], max_len=case["max_len"],
                        kv_dtype=case["kv_dtype"])
        toks = [list(map(int, x)) for x in eng.serve_all(case["prompts"], case["new_tokens"])]
        return toks, qleaves, None
    def teacher_forced(tokens):
        """JAX's one-device logits [b, n, V] at each of `tokens`' [b, n]
        steps, the prompt and tokens[:, :i] fed in."""
        toks = jnp.asarray(tokens, jnp.int32)
        n = None if case["lengths"] is None else jnp.asarray(case["lengths"])

        def run(p, pr, toks, n):
            cache = jdecode.init_kv_cache(jcfg, pr.shape[0], case["max_len"], uniform=n is None)
            logits, cache = jdecode.prefill(p, pr, cache, jcfg, lengths=n)
            out = [logits]
            for i in range(toks.shape[1] - 1):
                logits, cache = jdecode.decode_step(p, toks[:, i], cache, jcfg)
                out.append(logits)
            return jnp.stack(out, axis=1)
        return np.asarray(jax.jit(run)(jparams, jnp.asarray(case["prompt"]), toks, n),
                          np.float32)
    return case, jax_side, teacher_forced


def _jax_routing(run):
    """The per-expert counts of every routing `run` makes (JAX's
    `_top_k_gating`, counted in order through an ordered debug callback)."""
    got, real = [], jmoe._top_k_gating

    def counted(gate_logits, top_k, *a, **kw):
        out = real(gate_logits, top_k, *a, **kw)
        e = gate_logits.shape[-1]
        jax.debug.callback(
            lambda ex: got.append(np.bincount(np.asarray(ex).reshape(-1), minlength=e).tolist()),
            out[0], ordered=True)
        return out

    jmoe._top_k_gating = counted
    try:
        run()
    finally:
        jmoe._top_k_gating = real
    return got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    built = {name: make_case(name, spec) for name, spec in CASES.items()}
    port, ref = run_gang([c for c, _, _ in built.values()], 8, tmp_path_factory.mktemp("tp"),
                         meanwhile=lambda: {n: f() for n, (_, f, _) in built.items()})
    return port, ref, {n: t for n, (_, _, t) in built.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_gives_the_jax_tokens(name, runs):
    port, ref, teacher = runs
    got = port[name]
    assert got["mesh"] == {**{a: 1 for a in got["mesh"]}, **CASES[name]["ici"]}
    assert len(got["ranks"]) == 8
    for rank, out in enumerate(got["ranks"]):
        if name not in NEAR_TIE_CASES:
            assert out["greedy"] == ref[name][0], (rank, out["greedy"], ref[name][0])
        assert out["greedy"] == got["ranks"][0]["greedy"], rank
    if name in NEAR_TIE_CASES and got["ranks"][0]["greedy"] != ref[name][0]:
        toks = np.asarray(got["ranks"][0]["greedy"])
        assert toks[:, 0].tolist() == [r[0] for r in ref[name][0]]  # the prefill's
        logits = teacher[name](toks)
        chosen = np.take_along_axis(logits, toks[..., None], axis=-1)[..., 0]
        gap = (logits.max(-1) - chosen) / np.abs(logits).max(-1)
        assert gap.max() <= LOGIT_TOL, (toks.tolist(), ref[name][0], gap.tolist())


# each viewed leaf's logical dims (llama.py _LAYER_VIEW, _MOE_VIEW); a scale
# drops the contracted dim
_VIEW_DIMS = {"wq": (None, "tensor"), "wk": (None, "tensor"), "wv": (None, "tensor"),
              "wo": ("tensor", None), "w1": (None, "tensor"), "w3": (None, "tensor"),
              "w2": ("tensor", None), "lm_head": (None, "tensor"),
              "moe.w1": ("expert", None, "tensor"), "moe.w3": ("expert", None, "tensor"),
              "moe.w2": ("expert", "tensor", None), "moe.router": (None, None)}


def _shard_of(full, dims, coords, sizes):
    index = []
    for d, axis in enumerate(dims):
        n = sizes.get(axis, 1) if axis else 1
        w = full.shape[d] // n
        i = coords[axis] if axis else 0
        index.append(slice(i * w, (i + 1) * w))
    return full[tuple(index)]


@pytest.mark.parametrize("name", INT8_CASES)
def test_local_int8_views_are_slices_of_the_jax_quantized_tree(name, runs):
    """Quantized whole, then sharded: every rank's q and s are its slices of
    JAX's quantize_params output, bit for bit."""
    port, ref, _ = runs
    jq = ref[name][1]
    sizes = CASES[name]["ici"]
    for rank, out in enumerate(port[name]["ranks"]):
        assert set(out["views"]) >= {"wq", "wo", "lm_head"}
        for leaf, view in out["views"].items():
            want = jq if leaf == "lm_head" else jq["layers"][0]
            for part in leaf.split("."):
                want = want[part]
            dims = _VIEW_DIMS[leaf]
            if not isinstance(view, dict):  # the router stays f32, whole
                np.testing.assert_array_equal(view, _shard_of(np.asarray(want), dims,
                                                               out["coords"], sizes))
                continue
            for part, d in (("q", dims), ("s", dims[:-2] + dims[-1:])):
                w = np.asarray(want[part])
                got = np.asarray(view[part])
                assert got.dtype == w.dtype, (rank, leaf, part, got.dtype, w.dtype)
                np.testing.assert_array_equal(
                    got.view(np.uint8), _shard_of(w, d, out["coords"], sizes).view(np.uint8),
                    err_msg=f"rank {rank} {leaf}.{part}")


@pytest.mark.parametrize("name", MOE_CASES)
def test_routing_counts_equal_jax_one_device_on_every_rank(name, runs):
    """Every rank routes the whole batch with the whole router: each
    routing's per-expert counts are JAX's one-device counts (JAX's generate
    runs one decode step more than it emits), the same on every rank, whose
    gate logits (the router's input came out of a sum over the ranks) are
    the same bits."""
    port, ref, _ = runs
    want = ref[name][2]
    ranks = port[name]["ranks"]
    layers = jllama.LlamaConfig.tiny().n_layers
    assert len(ranks[0]["routing"]) == layers * CASES[name]["new_tokens"]
    assert len(ranks[0]["gates_sha256"]) == len(ranks[0]["routing"])
    for rank, out in enumerate(ranks):
        assert out["routing"] == ranks[0]["routing"], rank
        assert out["gates_sha256"] == ranks[0]["gates_sha256"], rank
    assert ranks[0]["routing"] == want[:len(ranks[0]["routing"])]


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


def _tree(which):
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
    """Once refused, MoE layers and int8 weight trees now run under a mesh
    (ROADMAP.md 12b): on a one-device stand-in mesh, `generate` and the
    engine give the one-device tokens; a tree left unsharded on a mesh that
    splits the tensor axis is refused before any collective."""
    cfg, params = _tree(which)
    prompt = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    if entry == "generate":
        got = tdecode.generate(params, prompt, cfg, 4, mesh=_stand_in_mesh())
        assert torch.equal(got, tdecode.generate(params, prompt, cfg, 4)), match
    else:
        rows = [r.numpy() for r in prompt]
        got = ServingEngine(params, cfg, slots=2, max_len=16, mesh=_stand_in_mesh())
        want = ServingEngine(params, cfg, slots=2, max_len=16)
        assert got.serve_all(rows, 4) == want.serve_all(rows, 4), match
    with pytest.raises(ValueError, match="shard the tree first"):
        tdecode.generate(params, prompt, cfg, 2, mesh=_stand_in_mesh(tensor=2))
