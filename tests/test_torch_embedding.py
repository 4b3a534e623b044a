"""The port's sharded embedding lookups (kubedl_tpu_torch/models/
embedding.py) against the JAX package's, on the same tables and ids.

One shard: the sum, the weighted mean and the unpooled lookup, their table
gradients and `lookup_features`, against JAX's single-shard path (1e-6
relative; the gradients' scatter-adds touch only the looked-up rows). On a
gloo gang of 4 (tests/torch_gang.py), against JAX on a CPU mesh of the same
axes: the "lookup" cases on tensor4 and data2·tensor2 (outputs gathered to
the global batch, table gradients to the table, an unpadded table raises),
and one models/vit.py training step on data2·tensor2 (loss and grad norm
within 1e-5 relative, every gradient within 1e-5 of max|JAX leaf|, the
parameters after AdamW's update within 1e-5 but for at most 0.1 % of a
leaf, each of those within lr)."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from kubedl_tpu.models import embedding as jemb
from kubedl_tpu.models import vit as jvit
from kubedl_tpu.parallel.mesh import ShardingRules as JRules, build_mesh
from kubedl_tpu.parallel.train_step import make_train_step as jax_make_train_step
from kubedl_tpu_torch.models import embedding
from torch_gang import run_gang

VOCAB, DIM, BATCH, BAG = 36, 8, 8, 5
COMBINERS = {"sum": ("sum", False), "mean": ("mean", True), "unpooled": (None, False)}
LR = 1e-3


def _inputs(seed=0, vocab=VOCAB):
    """(table [round_up(vocab, 4), DIM] f32, ids [BATCH, BAG] with ~30 % of
    each bag's tail -1, weights, a cotangent for each combiner)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((embedding.round_up(vocab, 4), DIM)).astype(np.float32)
    ids = rng.integers(0, vocab, (BATCH, BAG), dtype=np.int32)
    pad = rng.random((BATCH, BAG)) < 0.3
    pad[:, 0] = False
    ids[pad] = -1
    weights = rng.random((BATCH, BAG)).astype(np.float32)
    cot = {"sum": rng.standard_normal((BATCH, DIM)).astype(np.float32),
           "mean": rng.standard_normal((BATCH, DIM)).astype(np.float32),
           "unpooled": rng.standard_normal((BATCH, BAG, DIM)).astype(np.float32)}
    return table, ids, weights, cot


def _jax_lookup(table, ids, weights, cot, combiner, use_weights, mesh):
    """JAX's output and the table gradient of sum(output * cot)."""
    def f(tab):
        out = jemb.sparse_lookup(tab, ids, mesh, weights=weights if use_weights else None,
                                 combiner=combiner)
        return jnp.sum(out * cot), out

    (_, out), grad = jax.value_and_grad(f, has_aux=True)(table)
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("name", list(COMBINERS))
def test_one_shard_lookup_and_gradient_match_jax(name):
    combiner, use_weights = COMBINERS[name]
    table, ids, weights, cot = _inputs(seed=1)
    mesh = build_mesh({"tensor": 1}, devices=jax.devices()[:1])
    want, want_grad = _jax_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(weights),
                                  jnp.asarray(cot[name]), combiner, use_weights, mesh)
    tab = torch.from_numpy(table).requires_grad_(True)
    got = embedding.sparse_lookup(tab, torch.from_numpy(ids),
                                  weights=torch.from_numpy(weights) if use_weights else None,
                                  combiner=combiner)
    (grad,) = torch.autograd.grad((got * torch.from_numpy(cot[name])).sum(), [tab])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=1e-6, atol=1e-6)
    untouched = sorted(set(range(table.shape[0])) - set(ids[ids >= 0].ravel().tolist()))
    assert untouched and not grad[untouched].any()


def test_lookup_features_and_table_init_match_jax():
    feats = ((("a", 20, 4, 1, "sum"), ("b", 30, 8, 3, "mean")))
    jfeats = tuple(jemb.FeatureSpec(*f) for f in feats)
    tfeats = tuple(embedding.FeatureSpec(*f) for f in feats)
    assert [dataclasses.astuple(f) for f in jfeats] == [dataclasses.astuple(f) for f in tfeats]
    jtables = jemb.init_tables(jax.random.PRNGKey(0), jfeats, n_shards=4)
    ttables = embedding.init_tables(tfeats, n_shards=4, device="cpu")
    for f in feats:  # rows padded alike; the draws are each package's own
        assert tuple(ttables[f[0]].shape) == jtables[f[0]].shape == (embedding.round_up(f[1], 4),
                                                                    f[2])
        assert ttables[f[0]].abs().max() <= 2.0 / np.sqrt(f[2])
    assert {k: tuple(v) for k, v in embedding.table_specs(tfeats).items()} == \
        {k: tuple(v) for k, v in jemb.table_specs(jfeats).items()}
    rng = np.random.default_rng(0)
    ids = {"a": rng.integers(0, 20, (8, 1), dtype=np.int32),
           "b": rng.integers(-1, 30, (8, 3), dtype=np.int32)}
    mesh = build_mesh({"tensor": 1}, devices=jax.devices()[:1])
    want = jemb.lookup_features(jtables, {k: jnp.asarray(v) for k, v in ids.items()}, jfeats,
                                mesh)
    got = embedding.lookup_features(
        {k: torch.tensor(np.asarray(v)) for k, v in jax.device_get(jtables).items()},
        {k: torch.from_numpy(v) for k, v in ids.items()}, tfeats)
    assert tuple(got.shape) == (8, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the gang: sharded lookups and a sharded ViT step against JAX's mesh
# ---------------------------------------------------------------------------

LOOKUP_MESHES = {"lookup_tensor4": {"tensor": 4}, "lookup_data2_tensor2": {"data": 2, "tensor": 2}}
VIT_MESH = {"data": 2, "tensor": 2}


def _lookup_side(ici):
    """(the gang's case, its reference: JAX's lookups on the same mesh)."""
    table, ids, weights, cot = _inputs(seed=2)
    case = dict(kind="lookup", ici=ici, table=table, ids=ids, weights=weights, cotangent=cot)

    def reference():
        mesh = build_mesh(ici, devices=jax.devices()[:4])
        batch = NamedSharding(mesh, JP(("data", "fsdp")))
        tab = jax.device_put(jnp.asarray(table), NamedSharding(mesh, jemb.table_spec()))
        ids_s, w_s = (jax.device_put(jnp.asarray(x), batch) for x in (ids, weights))
        return {name: _jax_lookup(tab, ids_s, w_s, jnp.asarray(cot[name]), combiner,
                                  use_weights, mesh)
                for name, (combiner, use_weights) in COMBINERS.items()}
    return case, reference


def _vit_side():
    jcfg = jvit.ViTConfig.tiny(dtype=jnp.float32, use_flash=False)
    jparams = jvit.init(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    jparams["pos_embed"] = jnp.asarray(
        rng.standard_normal(jparams["pos_embed"].shape).astype(np.float32) * 0.1)
    images = rng.random((8, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, (8,), dtype=np.int32)
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype="float32", use_flash=True)  # the port's flash wrapper (plain on CPU)
    case = dict(kind="vit", ici=VIT_MESH, config=fields, params=jax.device_get(jparams),
                images=images, labels=labels, lr=LR)

    def reference():
        mesh = build_mesh(VIT_MESH, devices=jax.devices()[:4])
        rules = JRules()

        def loss(p, b):
            return jvit.loss_fn(p, b, jcfg, mesh=mesh, rules=rules)

        batch = (jnp.asarray(images), jnp.asarray(labels))
        grads = jax.jit(jax.grad(loss))(jparams, batch)
        jinit, jstep = jax_make_train_step(
            loss, optax.adamw(LR), mesh, jvit.param_specs(jcfg, rules),
            (rules.spec("batch", None, None, None), rules.spec("batch")), rules)
        state, m = jstep(jinit(jparams), batch)
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "grads": jax.device_get(grads), "params": jax.device_get(state.params)}
    return case, reference


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    cases, references = [], {}
    for name, ici in LOOKUP_MESHES.items():
        case, references[name] = _lookup_side(ici)
        cases.append(dict(case, name=name))
    case, references["vit_data2_tensor2"] = _vit_side()
    cases.append(dict(case, name="vit_data2_tensor2"))
    return run_gang(cases, 4, tmp_path_factory.mktemp("embedding_gang"),
                    meanwhile=lambda: {k: ref() for k, ref in references.items()})


@pytest.mark.parametrize("name", list(LOOKUP_MESHES))
def test_sharded_lookup_on_a_gang_matches_jax_mesh(name, gang):
    port, refs = gang
    got = port[name]
    assert got["mesh"] == {**{a: 1 for a in got["mesh"]}, **LOOKUP_MESHES[name]}
    assert got["unpadded_raises"]
    for comb, (want, want_grad) in refs[name].items():
        np.testing.assert_allclose(got["out"][comb], want, rtol=1e-6, atol=1e-6, err_msg=comb)
        np.testing.assert_allclose(got["grad"][comb], want_grad, rtol=1e-6, atol=1e-6,
                                   err_msg=comb)


def test_sharded_vit_step_on_a_gang_matches_jax_mesh(gang):
    port, refs = gang
    got, want = port["vit_data2_tensor2"], refs["vit_data2_tensor2"]
    assert got["mesh"] == {**{a: 1 for a in got["mesh"]}, **VIT_MESH}
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key
    far = []
    for kind in ("grads", "params"):
        a_leaves = jax.tree_util.tree_leaves(got[kind])
        b_leaves = jax.tree_util.tree_leaves(want[kind])
        assert len(a_leaves) == len(b_leaves) == 22
        for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
            b = np.asarray(b)
            assert a.shape == b.shape, (kind, i)
            err = np.abs(a - b)
            if kind == "grads":
                assert err.max() <= 1e-5 * np.abs(b).max(), (kind, i, err.max())
            else:
                # Adam's first update g / (|g| + 1e-8) turns f32 rounding
                # of a gradient near 1e-8 into a share of lr; every other
                # element holds to 1e-5
                assert err.max() <= LR, (kind, i, err.max())
                far.append((err > 1e-5).sum() / err.size)
    assert max(far) <= 1e-3, far
