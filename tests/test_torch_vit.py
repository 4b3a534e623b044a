"""The port's ViT (kubedl_tpu_torch/models/vit.py) and its training step
against the JAX package's, on the same parameters (carried across with
utils/convert.py) and the same numpy images.

ViTConfig.tiny in f32: `patchify` equal bit for bit; logits, loss and every
gradient within 1e-5 relative of JAX's, the JAX side through its Pallas
flash kernel in interpret mode, the port through its flash wrapper's plain
version; three `make_train_step` + AdamW(1e-3, decay 1e-4) updates against
the JAX step with ``optax.adamw(1e-3)`` (whose default decay is 1e-4):
losses and grad norms within 1e-5 relative, all but 0.1 % of the
parameters within 1e-5 and every one within 0.05 x lr x updates; the bf16
forward within 2e-2 of max|logit|."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubedl_tpu.models import vit as jvit
from kubedl_tpu.parallel.mesh import ShardingRules as JRules, build_mesh
from kubedl_tpu.parallel.train_step import make_train_step as jax_make_train_step
from kubedl_tpu_torch.models import llama, vit
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.parallel.mesh import ShardingRules
from kubedl_tpu_torch.parallel.train_step import make_train_step
from kubedl_tpu_torch.utils.convert import params_from_numpy, torch_dtype

LR = 1e-3


def _pair(dtype=jnp.float32, use_flash=True, seed=0):
    """(JAX config, JAX params, the port's config): the JAX init, with the
    zero-initialized position table and CLS token drawn so their gradients
    and the attention scores are not degenerate."""
    jcfg = jvit.ViTConfig.tiny(dtype=dtype, use_flash=use_flash)
    jparams = jvit.init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 10)
    for name in ("pos_embed", "cls"):
        jparams[name] = jnp.asarray(
            rng.standard_normal(jparams[name].shape).astype(np.float32) * 0.1)
    fields = dataclasses.asdict(jcfg)
    fields["dtype"] = torch_dtype(jcfg.dtype)
    return jcfg, jparams, vit.ViTConfig(**fields)


def _batch(n=4, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.random((n, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, (n,), dtype=np.int32)
    return images, labels


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):  # a PartitionSpec, a tuple, is a leaf
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_patchify_is_the_reference_layout_bit_for_bit():
    imgs = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    want = np.asarray(jvit.patchify(jnp.asarray(imgs), 8))
    got = vit.patchify(torch.from_numpy(imgs), 8).numpy()
    assert got.shape == want.shape == (2, 16, 192)
    np.testing.assert_array_equal(got, want)


def test_init_and_specs_match_the_reference_tree():
    jcfg, jparams, tcfg = _pair()
    tparams = vit.init(tcfg, device="cpu")
    jleaves, tleaves = dict(_named(jax.device_get(jparams))), dict(_named(tparams))
    assert set(jleaves) == set(tleaves)
    for name, a in jleaves.items():
        assert tuple(tleaves[name].shape) == a.shape, name
        assert tleaves[name].dtype == torch_dtype(a.dtype), name
    assert vit.param_count(tparams) == jvit.param_count(jparams)
    jspecs = dict(_named(jvit.param_specs(jcfg, JRules()), ""))
    tspecs = dict(_named(vit.param_specs(tcfg, ShardingRules()), ""))
    assert {k: tuple(v) for k, v in jspecs.items()} == {k: tuple(v) for k, v in tspecs.items()}


@pytest.fixture(scope="module")
def f32_reference():
    """JAX's logits, loss and gradients through its flash kernel (interpret
    mode on the CPU)."""
    jcfg, jparams, tcfg = _pair()
    images, labels = _batch()
    jbatch = (jnp.asarray(images), jnp.asarray(labels))
    logits = np.asarray(jvit.forward(jparams, jbatch[0], jcfg))
    loss, grads = jax.value_and_grad(lambda p: jvit.loss_fn(p, jbatch, jcfg))(jparams)
    return dict(params=jax.device_get(jparams), tcfg=tcfg, images=images, labels=labels,
                logits=logits, loss=float(loss), grads=dict(_named(jax.device_get(grads))))


def test_logits_loss_and_gradients_match_jax_f32(f32_reference):
    ref = f32_reference
    params = llama.tree_map(lambda x: x.requires_grad_(True), params_from_numpy(ref["params"]))
    batch = (torch.from_numpy(ref["images"]), torch.from_numpy(ref["labels"]))
    logits = vit.forward(params, batch[0], ref["tcfg"])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), ref["logits"], rtol=0,
                               atol=1e-5 * np.abs(ref["logits"]).max())
    loss = vit.loss_fn(params, batch, ref["tcfg"])
    assert abs(loss.item() - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    named = dict(_named(params))
    grads = torch.autograd.grad(loss, list(named.values()))
    assert len(grads) == len(ref["grads"]) == 22
    for (name, _), g in zip(named.items(), grads):
        want = np.asarray(ref["grads"][name])
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err, np.abs(want).max())


def test_three_adamw_updates_match_the_jax_step():
    jcfg, jparams, tcfg = _pair(use_flash=False)
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    rules = JRules()
    jinit, jstep = jax_make_train_step(
        lambda p, b: jvit.loss_fn(p, b, jcfg, mesh=mesh, rules=rules), optax.adamw(LR), mesh,
        jvit.param_specs(jcfg, rules),
        (rules.spec("batch", None, None, None), rules.spec("batch")), rules)
    tinit, tstep = make_train_step(lambda p, b: vit.loss_fn(p, b, tcfg),
                                   optim.adamw(LR, weight_decay=1e-4))
    jstate = jinit(jparams)
    tstate = tinit(params_from_numpy(jax.device_get(jparams)))
    for i in range(3):
        images, labels = _batch(seed=20 + i)
        jstate, jm = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)))
        tstate, tm = tstep(tstate, (torch.from_numpy(images), torch.from_numpy(labels)))
        for key in ("loss", "grad_norm"):
            assert abs(tm[key].item() - float(jm[key])) <= 1e-5 * abs(float(jm[key])), (i, key)
    want = dict(_named(jax.device_get(jstate.params)))
    got = dict(_named(tstate.params))
    diffs = []
    for name, a in want.items():
        diff = np.abs(got[name].detach().numpy() - np.asarray(a))
        # Adam's first update g / (|g| + 1e-8) turns f32 rounding of a
        # gradient near 1e-8 into a few % of lr (UPDATE_TOL of
        # test_torch_sharded_step.py); every other element holds to 1e-5
        assert diff.max() <= 0.05 * LR * 3, (name, diff.max())
        diffs.append(diff.ravel())
    diffs = np.concatenate(diffs)
    assert (diffs > 1e-5).sum() <= 1e-3 * diffs.size, (diffs > 1e-5).sum()


def test_bf16_forward_matches_jax():
    jcfg, jparams, tcfg = _pair(jnp.bfloat16, use_flash=False)
    images, _ = _batch()
    want = np.asarray(jvit.forward(jparams, jnp.asarray(images), jcfg))
    params = params_from_numpy(jax.device_get(jparams))
    assert params["layers"][0]["wqkv"].dtype == torch.bfloat16
    assert params["head"].dtype == torch.float32
    got = vit.forward(params, torch.from_numpy(images), dataclasses.replace(tcfg, use_flash=True))
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_attention_goes_through_the_flash_wrapper_non_causal(monkeypatch):
    """use_flash routes every layer's attention through ops/flash_attention
    `flash_attention` with causal=False; use_flash=False never calls it."""
    from kubedl_tpu_torch.ops import flash_attention as fa

    calls = []
    real = vit.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(vit, "flash_attention", spy)
    _, jparams, tcfg = _pair()
    params = params_from_numpy(jax.device_get(jparams))
    images = torch.from_numpy(_batch(2)[0])
    flash = vit.forward(params, images, tcfg)
    assert calls == [((2, 4, 17, 16), {"causal": False})] * 2
    plain = vit.forward(params, images, dataclasses.replace(tcfg, use_flash=False))
    assert len(calls) == 2
    torch.testing.assert_close(flash, plain, rtol=0, atol=1e-6)
    assert fa.flash_attention.launches == 0  # CPU tensors never launch a kernel


def test_qkv_reach_the_kernels_as_strided_views_at_vit_b16_width(monkeypatch):
    """At ViT-B/16's width (d 768, 12 heads of 64) q, k and v are views of
    the qkv product that the kernels read in place: `_aligned` copies none."""
    from kubedl_tpu_torch.ops import flash_attention as fa

    seen = []

    def spy(q, k, v, **kw):
        seen.append(all(fa._aligned(x).data_ptr() == x.data_ptr() and not x.is_contiguous()
                        for x in (q, k, v)))
        return fa.attention_reference(q, k, v, **kw)

    monkeypatch.setattr(vit, "flash_attention", spy)
    cfg = vit.ViTConfig.base(image_size=32, n_layers=1)  # 4 patches + CLS, full width
    params = vit.init(cfg, device="cpu")
    logits = vit.forward(params, torch.rand((2, 32, 32, 3)), cfg)
    assert tuple(logits.shape) == (2, 1000) and seen == [True]
