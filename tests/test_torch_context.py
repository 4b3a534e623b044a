"""Context parallelism in the port against the JAX package, on one gloo gang
of 8 (tests/torch_gang.py) beside the 8-device CPU mesh, f32, the same
inputs from a numpy seed:

* ops/ring_attention.py `ring_attention` against the JAX package's on
  {"context": 8} and data2·context4, causal and not, and ops/ulysses.py
  `ulysses_attention` on data2·context4: the output and the q, k, v
  gradients of sum(out * cotangent) within 2e-5 of max|JAX| (JAX's own
  tests hold the two to plain attention at 2e-3 and 5e-3);
* Ulysses' ValueError for 4 heads over 8 context shards, word for word;
* llama `loss_fn` on data2·context4 with LlamaConfig.tiny (GQA 4/2):
  ring, Ulysses and a 4-expert MoE on the ring; the loss (1e-5 relative)
  and every gradient leaf (1e-4 of max|JAX leaf|) of the first step, and
  three AdamW steps through `make_train_step` (losses, grad norms and the
  parameters after, tests/test_torch_sharded_step.py's bounds) against
  the JAX step on the same mesh;
* a window and an attention softcap under a context axis raise
  NotImplementedError with the JAX package's messages."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.ops.ring_attention import ring_attention as jring
from kubedl_tpu.ops.ulysses import ulysses_attention as julysses
from kubedl_tpu.parallel.mesh import build_mesh
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel import mesh as tmesh
from test_torch_sharded_step import CLIP, GRAD_TOL, LR, compare, jax_side
from torch_gang import run_gang

ATTN_TOL = 2e-5  # of max|JAX|: both sides f32, the ring's merge order differs
B, H, T, D = 2, 4, 64, 16
MESHES = {"context8": {"context": 8}, "data2_context4": {"data": 2, "context": 4}}
ATTN_CASES = {f"{fn}_{m}_{'causal' if c else 'full'}": (fn, m, c)
              for fn, ms in (("ring", MESHES), ("ulysses", ("data2_context4",)))
              for m in ms for c in (True, False)}
# (LlamaConfig fields) of the model cases, all on data2·context4
MODEL_CASES = {
    "ring": {},
    "ulysses": {"context_parallel": "ulysses"},
    "moe_ring": {"n_experts": 4},
}
ROWS, SEQ, STEPS = 4, 33, 3  # 32 positions: 8 a context rank


def _attention_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((B, H, T, D)).astype(np.float32)
            for n in ("q", "k", "v", "cotangent")}


def _jax_attention(fn, mesh_name, causal, x):
    ici = MESHES[mesh_name]
    jmesh = build_mesh(ici, devices=jax.devices()[:int(np.prod(list(ici.values())))])
    attend = jring if fn == "ring" else julysses

    @jax.jit
    def f(q, k, v, cot):
        out, vjp = jax.vjp(lambda *a: attend(*a, mesh=jmesh, causal=causal), q, k, v)
        return out, vjp(cot)

    out, grads = f(*(jnp.asarray(x[n]) for n in ("q", "k", "v", "cotangent")))
    return {"out": np.asarray(out), **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


def _model_case(name, cfg, seed=0):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, **cfg)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    batches = [rng.integers(0, jcfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype="float32", use_flash=True)  # the port's flash wrapper (plain on CPU)
    ici = MESHES["data2_context4"]
    case = dict(name=name, ici=ici, config=fields, params=jax.device_get(jparams),
                batches=batches, accum=1, lr=LR, clip=CLIP)
    return case, (jcfg, jparams, build_mesh(ici, devices=jax.devices()[:8]))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every case on one gang of 8; the JAX side computed meanwhile."""
    x = _attention_inputs()
    cases = [dict(name=n, kind="attention", fn=fn, causal=c, ici=MESHES[m], **x)
             for n, (fn, m, c) in ATTN_CASES.items()]
    rng = np.random.default_rng(7)
    cases.append(dict(name="ulysses_4_heads_over_8", kind="attention", fn="ulysses",
                      causal=True, ici=MESHES["context8"],
                      **{n: rng.standard_normal((1, 4, 64, 16)).astype(np.float32)
                         for n in ("q", "k", "v", "cotangent")}))
    built = {n: _model_case(n, cfg) for n, cfg in MODEL_CASES.items()}
    cases += [c for c, _ in built.values()]

    def jax_results():
        out = {n: _jax_attention(fn, m, c, x) for n, (fn, m, c) in ATTN_CASES.items()}
        out.update({n: jax_side(c, j) for n, (c, j) in built.items()})
        return out

    port, ref = run_gang(cases, 8, tmp_path_factory.mktemp("context"), timeout=400,
                         meanwhile=jax_results)
    return port, ref


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_matches_jax(name, gang):
    port, ref = gang
    fn, mesh_name, _ = ATTN_CASES[name]
    assert port[name]["mesh"] == {**dict.fromkeys(tmesh.AXIS_ORDER, 1), **MESHES[mesh_name]}
    for key in ("out", "dq", "dk", "dv"):
        got, want = port[name][key], ref[name][key]
        err = np.abs(got - want).max()
        assert err <= ATTN_TOL * np.abs(want).max(), (key, err, np.abs(want).max())


def test_ulysses_rejects_indivisible_heads_as_jax_does(gang):
    port, _ = gang
    q = jnp.zeros((1, 4, 64, 16))  # 4 heads over 8 context shards
    with pytest.raises(ValueError) as want:
        julysses(q, q, q, mesh=build_mesh({"context": 8}, devices=jax.devices()[:8]))
    assert port["ulysses_4_heads_over_8"] == {"raised": str(want.value)}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_loss_and_gradients_match_jax(name, gang):
    port, ref = gang
    got, want = port[name], ref[name]
    assert got["mesh"]["context"] == 4 and got["mesh"]["data"] == 2
    # the first step's loss is loss_fn's at the initial parameters
    assert abs(got["loss"][0] - want["loss"][0]) <= 1e-5 * abs(want["loss"][0])
    grads = jax.tree_util.tree_leaves(got["grads"])
    assert len(grads) == len(want["grads"])
    for i, (a, b) in enumerate(zip(grads, want["grads"])):
        assert a.shape == b.shape, i
        err = np.abs(a - b).max()
        assert err <= GRAD_TOL * np.abs(b).max(), (i, err, np.abs(b).max())


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_three_adamw_steps_match_jax(name, gang):
    port, ref = gang
    assert port[name]["step"] == STEPS and len(port[name]["loss"]) == STEPS
    compare(port[name], ref[name])


def _fake_mesh(**sizes):
    """A stand-in DeviceMesh for checks that run before any collective."""
    shape = [sizes.get(a, 1) for a in tmesh.AXIS_ORDER]
    return types.SimpleNamespace(mesh_dim_names=tmesh.AXIS_ORDER, mesh=np.zeros(shape),
                                 get_local_rank=lambda axis: 0)


@pytest.mark.parametrize("option", [{"sliding_window": 4}, {"attn_logit_softcap": 50.0}],
                         ids=["window", "softcap"])
def test_window_and_softcap_refused_under_context_as_jax(option):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, **option)
    tokens = np.zeros((2, 9), np.int32)
    with pytest.raises(NotImplementedError) as want:
        jllama.loss_fn(jllama.init(jcfg, jax.random.PRNGKey(0)), jnp.asarray(tokens), jcfg,
                       mesh=build_mesh({"context": 2}, devices=jax.devices()[:2]))
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32, **option)
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError) as got:
        llama.loss_fn(params, torch.from_numpy(tokens[:, :5]), cfg,
                      mesh=_fake_mesh(context=2))
    assert str(got.value) == str(want.value)
