"""The port's sharded train step on a gloo gang (tests/torch_gang.py, one
process a device) against the JAX step on the same mesh of the 8-device
CPU platform, for the dense meshes of the JAX package's dry run:
data2·fsdp2·tensor2, the hybrid ICI fsdp2·tensor2 x DCN data2, and data4
with accum_steps=2. LlamaConfig.tiny in f32, the same parameters (carried
across with utils/convert.py) and the same global batches; the JAX step is
kubedl_tpu.parallel.train_step.make_train_step with the optax chain the
trainer builds. Compared: each micro-step's loss and grad norm (1e-5
relative), every gradient leaf gathered to its full shape (1e-4 of
max|JAX leaf|) and the parameters after the update (UPDATE_TOL)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel.mesh import ShardingRules, build_hybrid_mesh, build_mesh
from kubedl_tpu.parallel.train_step import make_train_step as jax_make_train_step
from torch_gang import run_gang

LR, CLIP = 1e-3, 1.0
GRAD_TOL = 1e-4
# test_torch_train_step.py::test_three_updates_match_the_jax_step's
# tolerance, 0.05 x lr x its 3 updates: Adam's first update g / (|g| + eps)
# turns f32 rounding of gradients near eps into a few % of lr an element
UPDATE_TOL = 0.05 * LR * 3

CASES = {
    "data2_fsdp2_tensor2": dict(ici={"data": 2, "fsdp": 2, "tensor": 2}, rows=8),
    "hybrid_fsdp2_tensor2_dcn_data2": dict(ici={"fsdp": 2, "tensor": 2}, dcn={"data": 2},
                                           rows=8),
}
ACCUM_CASE = {"data4_accum2": dict(ici={"data": 4}, rows=8, accum=2)}


def make_case(name, spec, seq=33, seed=0):
    """(the gang's case dict, the JAX side's (config, params, mesh));
    spec: ici (and dcn) axes, global rows, accum, cfg (LlamaConfig fields)."""
    cfg = spec.get("cfg", {})
    seq = spec.get("seq", seq)
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, **cfg)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    accum = spec.get("accum", 1)
    batches = [rng.integers(0, jcfg.vocab_size, (spec["rows"], seq)).astype(np.int32)
               for _ in range(accum)]
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype="float32", use_flash=True)  # the port's flash wrapper (plain on CPU)
    case = dict(name=name, ici=spec["ici"], dcn=spec.get("dcn"), config=fields,
                params=jax.device_get(jparams), batches=batches, accum=accum, lr=LR,
                clip=CLIP, stats=cfg.get("moe_dropless", False))
    n = int(np.prod(list(spec["ici"].values()) + list((spec.get("dcn") or {}).values())))
    devices = jax.devices()[:n]
    if spec.get("dcn"):
        mesh = build_hybrid_mesh(spec["ici"], spec["dcn"], devices=devices)
    else:
        mesh = build_mesh(spec["ici"], devices=devices)
    return case, (jcfg, jparams, mesh)


def jax_side(case, jax_parts):
    """The JAX step on the same mesh: losses, grad norms, the first
    micro-step's gradients and the parameters after, as numpy leaves."""
    jcfg, jparams, mesh = jax_parts
    rules = ShardingRules()

    def loss(p, b):
        return jllama.loss_fn(p, b, jcfg, mesh=mesh, rules=rules)

    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=0.01))
    jinit, jstep = jax_make_train_step(loss, tx, mesh, jllama.param_specs(jcfg, rules),
                                       rules.spec("batch", None), rules,
                                       accum_steps=case["accum"])
    grads = jax.jit(jax.grad(loss))(jparams, jnp.asarray(case["batches"][0]))
    grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(jax.device_get(grads))]
    state = jinit(jparams)
    losses, norms = [], []
    for b in case["batches"]:
        state, m = jstep(state, jnp.asarray(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    params = [np.asarray(p) for p in jax.tree_util.tree_leaves(jax.device_get(state.params))]
    return {"loss": losses, "grad_norm": norms, "grads": grads, "params": params}


def compare(got, want):
    got = dict(got, grads=jax.tree_util.tree_leaves(got["grads"]),
               params=jax.tree_util.tree_leaves(got["params"]))
    for key in ("loss", "grad_norm"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            assert abs(a - b) <= 1e-5 * abs(b), (key, a, b)
    assert len(got["grads"]) == len(want["grads"])
    for i, (a, b) in enumerate(zip(got["grads"], want["grads"])):
        assert a.shape == b.shape, i
        err = np.abs(a - b).max()
        assert err <= GRAD_TOL * np.abs(b).max(), (i, err, np.abs(b).max())
    for i, (a, b) in enumerate(zip(got["params"], want["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=UPDATE_TOL, err_msg=str(i))


def run_cases(specs, world, tmp_path):
    """Rank 0's results, the JAX results and the cases, by name."""
    built = {name: make_case(name, spec) for name, spec in specs.items()}
    port, jax_results = run_gang(
        [c for c, _ in built.values()], world, tmp_path,
        meanwhile=lambda: {n: jax_side(c, j) for n, (c, j) in built.items()})
    return port, jax_results, built


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return run_cases(CASES, 8, tmp_path_factory.mktemp("dense"))


@pytest.fixture(scope="module")
def accum(tmp_path_factory):
    return run_cases(ACCUM_CASE, 4, tmp_path_factory.mktemp("accum"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(name, dense):
    port, ref, _ = dense
    assert port[name]["mesh"] == {**{a: 1 for a in port[name]["mesh"]},
                                  **{"data": 2, "fsdp": 2, "tensor": 2}}
    compare(port[name], ref[name])


def test_accumulated_step_on_data4_matches_jax(accum):
    port, ref, _ = accum
    got = port["data4_accum2"]
    assert got["step"] == 2 and len(got["loss"]) == 2
    compare(got, ref["data4_accum2"])
