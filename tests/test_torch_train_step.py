"""Training on kubedl_tpu_torch against the JAX package, on LlamaConfig.tiny
in f32 with the same parameters (carried across with utils/convert.py)
and the same numpy tokens: `loss_fn` and every gradient leaf (JAX on its
Pallas flash kernels in interpret mode), with the family knobs, chunked CE
and each remat mode; three updates of `make_train_step` against the JAX
step on a one-device CPU mesh with the optax chain the trainer builds;
and the optimizer's schedules against optax."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel.mesh import ShardingRules, build_mesh
from kubedl_tpu.parallel.train_step import make_train_step as jax_make_train_step
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.ops import flash_attention as tfa
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.parallel.train_step import make_train_step
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

VARIANTS = {
    "base_gqa": dict(),  # tiny: 4 q heads over 2 kv heads
    "gemma2": dict(attn_logit_softcap=20.0, final_logit_softcap=15.0,
                   post_block_norms=True, norm_offset=1.0, embed_scale=11.3,
                   query_pre_attn_scalar=24.0, act="gelu_tanh",
                   head_dim_override=24, tie_embeddings=True),
    "qwen2_bias": dict(attn_qkv_bias=True),
    "layer_windows": dict(layer_windows=(None, 5)),
    "ce_chunks_4": dict(ce_chunks=4),
}
GRAD_TOL = 1e-4  # max|port - JAX| / max|JAX| a leaf, f32


def _pair(variant, dtype=jnp.float32, seed=0):
    jcfg = jllama.LlamaConfig.tiny(dtype=dtype, use_flash=True, **VARIANTS[variant])
    jparams = jllama.init(jcfg, jax.random.PRNGKey(seed))
    if jcfg.attn_qkv_bias:  # init zeroes the biases; make them matter
        rng = np.random.default_rng(seed)
        for layer in jparams["layers"]:
            for name in ("bq", "bk", "bv"):
                layer[name] = jnp.asarray(
                    rng.standard_normal(layer[name].shape, np.float32) * 0.5)
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    return jcfg, jparams, tcfg


def _tokens(b, t, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


_JAX = {}


def _jax_loss_and_grads(variant, dtype=jnp.float32):
    """(loss, grads as a numpy tree) of the JAX loss_fn; cached a variant."""
    key = (variant, str(dtype))
    if key not in _JAX:
        jcfg, jparams, _ = _pair(variant, dtype)
        toks = jnp.asarray(_tokens(2, 17, jcfg.vocab_size))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jllama.loss_fn(p, toks, jcfg)))(jparams)
        _JAX[key] = (float(loss), jax.device_get(grads))
    return _JAX[key]


def _torch_loss_and_grads(variant, dtype=jnp.float32, **cfg):
    jcfg, jparams, tcfg = _pair(variant, dtype)
    tcfg = dataclasses.replace(tcfg, **cfg)
    params = params_from_numpy(jax.device_get(jparams))
    leaves = list(tllama.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(params, torch.from_numpy(_tokens(2, 17, jcfg.vocab_size)), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss, params, dict(zip(map(id, leaves), grads))


def _compare_tree(jtree, params, grads, tol, path="params"):
    """Every leaf's gradient: same dtype as the parameter, max|diff| <=
    tol x max|JAX|."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(params), path
        for k in jtree:
            _compare_tree(jtree[k], params[k], grads, tol, f"{path}.{k}")
        return
    if isinstance(jtree, list):
        for i, (a, b) in enumerate(zip(jtree, params)):
            _compare_tree(a, b, grads, tol, f"{path}[{i}]")
        return
    g = grads[id(params)]
    assert g.dtype == params.dtype, path
    want = np.asarray(jtree).astype(np.float32)
    err = np.abs(g.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (path, err, np.abs(want).max())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_jax_f32(variant):
    jloss, jgrads = _jax_loss_and_grads(variant)
    loss, params, grads = _torch_loss_and_grads(variant)
    assert loss.dtype == torch.float32
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    _compare_tree(jgrads, params, grads, GRAD_TOL)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_modes_match_jax_and_recompute_what_they_say(remat, monkeypatch):
    """Every remat mode gives the JAX gradients. Full remat and "dots" run
    the attention forward twice a layer (forward, then recompute); none
    once. The backward runs 2 matmuls a weight (7 a layer, and the LM
    head); full remat also recomputes 6 a layer (q, k, v, o, w1, w3: w2's
    output feeds only the residual add, and the recompute stops once every
    tensor the backward needs is back); "dots" saved them, and recomputes
    none."""
    cfg = dict(remat=remat != "none", remat_policy="dots" if remat == "dots" else None)
    fwd_calls = []
    real = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: fwd_calls.append(1) or real(*a, **kw))
    jcfg, jparams, tcfg = _pair("base_gqa")
    tcfg = dataclasses.replace(tcfg, **cfg)
    params = params_from_numpy(jax.device_get(jparams))
    leaves = list(tllama.tree_leaves(params))
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(params, torch.from_numpy(_tokens(2, 17, jcfg.vocab_size)), tcfg)
    with _CountMM() as counter:
        grads = torch.autograd.grad(loss, leaves)
    n = tcfg.n_layers
    assert len(fwd_calls) == (n if remat == "none" else 2 * n)
    assert counter.mm == 2 * (7 * n + 1) + (6 * n if remat == "full" else 0)
    jloss, jgrads = _jax_loss_and_grads("base_gqa")
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    _compare_tree(jgrads, params, dict(zip(map(id, leaves), grads)), GRAD_TOL)


def test_bf16_grads_keep_the_parameter_dtypes():
    """bf16 model: matrices' gradients bf16, norms' f32, as
    jax.value_and_grad gives them; values within 5e-2 of max|JAX| a leaf
    (bf16 rounds at other places in the two frameworks)."""
    jloss, jgrads = _jax_loss_and_grads("qwen2_bias", jnp.bfloat16)
    loss, params, grads = _torch_loss_and_grads("qwen2_bias", jnp.bfloat16)
    assert params["layers"][0]["wq"].dtype == torch.bfloat16
    assert params["layers"][0]["attn_norm"].dtype == torch.float32
    assert abs(loss.item() - jloss) <= 1e-2 * abs(jloss)
    _compare_tree(jgrads, params, grads, 5e-2)


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------

LR = 1e-3
STEP_CASES = {
    # name: (accum_steps, grad_clip, schedule)
    "adamw_clip_constant": (1, 1.0, "constant"),
    "accum2_clip_cosine": (2, 0.5, "cosine"),
    "linear_warmup": (1, 0.0, "linear"),
}


def _txs(clip, schedule, steps):
    if schedule == "cosine":
        jlr = optax.warmup_cosine_decay_schedule(0.0, LR, 2, steps, LR * 0.1)
        tlr = optim.warmup_cosine_decay_schedule(0.0, LR, 2, steps, LR * 0.1)
    elif schedule == "linear":
        jlr, tlr = optax.linear_schedule(0.0, LR, 2), optim.linear_schedule(0.0, LR, 2)
    else:
        jlr = tlr = LR
    jtx, ttx = optax.adamw(jlr, weight_decay=0.01), optim.adamw(tlr, weight_decay=0.01)
    if clip > 0:
        jtx = optax.chain(optax.clip_by_global_norm(clip), jtx)
        ttx = optim.chain(optim.clip_by_global_norm(clip), ttx)
    return jtx, ttx


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_three_updates_match_the_jax_step(name):
    """3 applied updates (accum_steps micro-steps each): every micro-step's
    loss and grad_norm within 1e-5 relative, and the parameters after
    within 0.05 x lr x updates. Adam's first update g / (|g| + eps) turns
    f32 rounding of gradients near eps into up to ~1 % of lr a step."""
    accum, clip, schedule = STEP_CASES[name]
    updates = 3
    jcfg, jparams, tcfg = _pair("base_gqa")
    jtx, ttx = _txs(clip, schedule, steps=6)
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    rules = ShardingRules()
    jinit, jstep = jax_make_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg, mesh=mesh, rules=rules), jtx, mesh,
        jllama.param_specs(jcfg, rules), rules.spec("batch", None), rules,
        accum_steps=accum)
    tinit, tstep = make_train_step(lambda p, b: tllama.loss_fn(p, b, tcfg), ttx,
                                   accum_steps=accum)
    tstate = tinit(params_from_numpy(jax.device_get(jparams)))
    jstate = jinit(jparams)
    rng = np.random.default_rng(7)
    for _ in range(updates * accum):
        toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        for key in ("loss", "grad_norm"):
            assert abs(tm[key].item() - float(jm[key])) <= 1e-5 * abs(float(jm[key])), key
    assert tstate.step == updates * accum == int(jstate.step)
    jp = jax.tree_util.tree_leaves(jax.device_get(jstate.params))
    tp = jax.tree_util.tree_leaves(
        tllama.tree_map(lambda x: x.detach().numpy(), tstate.params))
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=0.05 * LR * updates)


def test_bf16_update_keeps_moments_in_the_parameter_dtype():
    """optax keeps Adam's moments in the parameter's dtype: bf16 matrices
    get bf16 mu and nu, f32 norms f32 ones; one update moves every matrix."""
    _, jparams, tcfg = _pair("base_gqa", jnp.bfloat16)
    params = params_from_numpy(jax.device_get(jparams))
    before = tllama.tree_map(lambda x: x.clone(), params)
    tinit, tstep = make_train_step(lambda p, b: tllama.loss_fn(p, b, tcfg),
                                   optim.adamw(LR, weight_decay=0.01))
    state = tinit(params)
    state, m = tstep(state, torch.from_numpy(_tokens(2, 17, tcfg.vocab_size)))
    leaves = list(tllama.tree_leaves(state.params))
    for p, mu, nu in zip(leaves, state.opt_state["mu"], state.opt_state["nu"]):
        assert mu.dtype == nu.dtype == p.dtype
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    for a, b in zip(tllama.tree_leaves(before), leaves):
        if a.dtype == torch.bfloat16:
            assert not torch.equal(a, b.detach())


@pytest.mark.parametrize("name", ["linear", "linear_decay", "linear_zero_steps",
                                  "cosine", "warmup_cosine"])
def test_schedules_match_optax(name):
    pairs = {
        "linear": (optax.linear_schedule(0.0, 3e-4, 5), optim.linear_schedule(0.0, 3e-4, 5)),
        "linear_decay": (optax.linear_schedule(1e-3, 1e-4, 7),
                         optim.linear_schedule(1e-3, 1e-4, 7)),
        "linear_zero_steps": (optax.linear_schedule(2e-4, 0.0, 0),
                              optim.linear_schedule(2e-4, 0.0, 0)),
        "cosine": (optax.cosine_decay_schedule(1e-3, 15, 0.1),
                   optim.cosine_decay_schedule(1e-3, 15, 0.1)),
        "warmup_cosine": (optax.warmup_cosine_decay_schedule(0.0, 1e-3, 4, 17, 1e-4),
                          optim.warmup_cosine_decay_schedule(0.0, 1e-3, 4, 17, 1e-4)),
    }
    jfn, tfn = pairs[name]
    for step in range(21):
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6, atol=1e-12)


def test_global_norm_and_clip_match_optax():
    rng = np.random.default_rng(3)
    tree = [rng.standard_normal(s, np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want_norm = float(optax.global_norm([jnp.asarray(x) for x in tree]))
    leaves = [torch.from_numpy(x.copy()) for x in tree]
    assert abs(optim.global_norm(leaves).item() - want_norm) <= 1e-6 * want_norm
    for max_norm in (0.5 * want_norm, 2.0 * want_norm):
        clip = optim.clip_by_global_norm(max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(x) for x in tree], optax.EmptyState())
        ctx = clip.begin(leaves, {})
        for i, (g, w) in enumerate(zip(leaves, want)):
            np.testing.assert_allclose(clip.leaf(i, g, g, {}, ctx).numpy(), np.asarray(w),
                                       rtol=1e-6)
    # bf16 leaves: clipped in bf16 like optax's (t / norm.astype(bf16)) * max_norm
    bf = [x.astype(ml_dtypes.bfloat16) for x in tree]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(x) for x in bf],
                                                    optax.EmptyState())
    tb = [torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) for x in bf]
    clip = optim.clip_by_global_norm(1.0)
    ctx = clip.begin(tb, {})
    for i, (g, w) in enumerate(zip(tb, want)):
        out = clip.leaf(i, g, g, {}, ctx)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), np.asarray(w).astype(np.float32),
                                   rtol=1e-2)
