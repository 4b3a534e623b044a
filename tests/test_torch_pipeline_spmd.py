"""The port's pipelined train step (models/llama.py `loss_fn_pp` over the
schedules of parallel/pipeline.py) on a gloo gang of 8 (tests/torch_gang.py,
kind "pipeline") against the JAX step with the reference's `loss_fn_pp` on
the same mesh of the 8-device CPU platform, for the dry run's three
pipelined meshes (__graft_entry__.py `run_pp`): stage4·data2 with GPipe,
stage4·data2 with the interleaved 1F1B schedule (interleave 2) and
stage2·data4 with MoE layers. LlamaConfig.tiny at d 64 in f32, the
smallest depth each schedule takes (one layer a stage for GPipe, S x v = 8
for the interleaved one, 4 with MoE), the same parameters and global batch.
Compared as tests/test_torch_sharded_step.py compares: the loss and grad
norm (1e-5 relative), every stacked gradient leaf (1e-4 of max|JAX leaf|)
and the parameters after the clipped AdamW update (UPDATE_TOL); and
`forward_pipelined`'s logits of rank 0's rows (stage 0's copy of the last
stage's) against JAX's, within 1e-4 of max|logit|."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel.mesh import ShardingRules, build_mesh
from kubedl_tpu.parallel.train_step import make_train_step as jax_make_train_step
from test_torch_sharded_step import CLIP, GRAD_TOL, LR, compare
from torch_gang import run_gang

CASES = {
    "stage4_data2_gpipe": dict(ici={"stage": 4, "data": 2}, layers=4, rows=8, micro=4,
                               schedule="gpipe", interleave=1),
    "stage4_data2_1f1b_v2": dict(ici={"stage": 4, "data": 2}, layers=8, rows=8, micro=4,
                                 schedule="1f1b", interleave=2),
    "stage2_data4_moe": dict(ici={"stage": 2, "data": 4}, layers=4, rows=32, micro=4,
                             schedule="1f1b", interleave=1,
                             cfg=dict(n_experts=4, expert_top_k=2)),
}


def make_case(name, spec, seq=17, seed=0):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, d_model=64,
                                   n_layers=spec["layers"], **spec.get("cfg", {}))
    jparams = jllama.init(jcfg, jax.random.PRNGKey(seed))
    batch = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab_size, (spec["rows"], seq)).astype(np.int32)
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype="float32", use_flash=True)  # the port's flash wrapper (plain on CPU)
    case = dict(name=name, kind="pipeline", ici=spec["ici"], config=fields,
                params=jax.device_get(jparams), batch=batch, microbatches=spec["micro"],
                schedule=spec["schedule"], interleave=spec["interleave"], lr=LR, clip=CLIP)
    mesh = build_mesh(spec["ici"], devices=jax.devices()[:8])
    return case, (jcfg, jparams, mesh)


def jax_side(case, parts):
    """The reference's pipelined step on the same mesh."""
    jcfg, jparams, mesh = parts
    rules = ShardingRules()

    def loss(p, b):
        return jllama.loss_fn_pp(p, b, jcfg, mesh, rules=rules,
                                 n_microbatches=case["microbatches"],
                                 schedule=case["schedule"], interleave=case["interleave"])

    stacked = jllama.stack_params(jparams)
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=0.01))
    jinit, jstep = jax_make_train_step(loss, tx, mesh, jllama.param_specs_pp(jcfg, rules),
                                       rules.spec("batch", None), rules)
    tokens = jnp.asarray(case["batch"])
    logits = jax.jit(lambda p, t: jllama.forward_pipelined(
        p, t, jcfg, mesh, rules=rules, n_microbatches=case["microbatches"],
        schedule=case["schedule"], interleave=case["interleave"]))(stacked, tokens[:, :-1])
    grads = jax.jit(jax.grad(loss))(stacked, tokens)
    state, m = jstep(jinit(stacked), tokens)
    leaves = jax.tree_util.tree_leaves
    return {"loss": [float(m["loss"])], "grad_norm": [float(m["grad_norm"])],
            "logits": np.asarray(jax.device_get(logits)),
            "grads": [np.asarray(g) for g in leaves(jax.device_get(grads))],
            "params": [np.asarray(p) for p in leaves(jax.device_get(state.params))]}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    built = {name: make_case(name, spec) for name, spec in CASES.items()}
    port, ref = run_gang([c for c, _ in built.values()], 8, tmp_path_factory.mktemp("pp"),
                         meanwhile=lambda: {n: jax_side(c, j) for n, (c, j) in built.items()})
    return port, ref


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_step_matches_jax(name, gang):
    port, ref = gang
    assert port[name]["mesh"] == {**{a: 1 for a in port[name]["mesh"]}, **CASES[name]["ici"]}
    assert port[name]["grads"]["layers"]["wq"].shape[0] == CASES[name]["layers"]
    compare(port[name], ref[name])
    # rank 0 is stage 0: its logits are the last stage's, broadcast
    want = ref[name]["logits"][port[name]["rows"]]
    err = np.abs(port[name]["logits"] - want).max()
    assert err <= GRAD_TOL * np.abs(want).max(), (err, np.abs(want).max())
