"""kubedl_tpu_torch/train/preference.py against the JAX package's
(tests/test_preference.py) on LlamaConfig.tiny in f32, JAX's parameters
carried across with utils/convert.py: `sequence_logprobs` (masking,
chunked against full with an uneven split, Gemma-2's final softcap, per
token), `dpo_loss` at the reference (zero margin, log 2), three
`make_dpo_step` updates (clip + AdamW, as the dpo workload builds them)
and MoE's aux term, each within 1e-5 relative of JAX's."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel.mesh import ShardingRules, build_mesh
from kubedl_tpu.train import preference as jpref
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.train import preference
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

TOL = 1e-5  # relative, f32
LR, CLIP, BETA = 5e-4, 1.0, 0.5


def _pair(jcfg, seed):
    jp = jllama.init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, config_from_fields(**dataclasses.asdict(jcfg)), \
        params_from_numpy(jax.device_get(jp))


@pytest.fixture(scope="module")
def model():
    return _pair(jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False), 0)


def make_batch(vocab, b=4, t=24, seed=0):
    """tokens [b, 2, t] with a shared prompt per pair and zeroed pad tails,
    prompt_lens [b], seq_lens [b, 2] (tests/test_preference.py's)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(b, 2, t)).astype(np.int32)
    prompt_lens = rng.integers(3, 8, size=(b,)).astype(np.int32)
    seq_lens = rng.integers(12, t + 1, size=(b, 2)).astype(np.int32)
    for i in range(b):
        tokens[i, 1, :prompt_lens[i]] = tokens[i, 0, :prompt_lens[i]]
        for j in (0, 1):
            tokens[i, j, seq_lens[i, j]:] = 0
    return tokens, prompt_lens, seq_lens


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-30), (got, want)


@pytest.mark.parametrize("variant", ["full", "chunked", "softcap", "softcap_chunked"])
def test_sequence_logprobs_match_jax(model, variant):
    """[n] sums (and per-token values with their mask) against JAX's; a pad
    token changes nothing; chunks of an uneven split (5 over vocab 256)
    equal the full log-softmax."""
    jcfg, jp, tcfg, tp = model
    kw = {}
    if "softcap" in variant:
        kw["final_logit_softcap"] = 3.0  # small enough to bend these logits
    if "chunked" in variant:
        kw["ce_chunks"] = 5
    jcfg, tcfg = dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw)
    tokens, pl, sl = make_batch(tcfg.vocab_size, seed=9)
    flat, sl0 = tokens[:, 0], sl[:, 0]
    want = np.asarray(jax.jit(lambda p, *a: jpref.sequence_logprobs(p, *a, jcfg))(
        jp, *_j(flat, pl, sl0)))
    got = preference.sequence_logprobs(tp, *_t(flat, pl, sl0), tcfg)
    assert got.shape == (4,) and bool((got < 0).all())
    _close(got.numpy(), want)
    jtok, jmask = jax.jit(lambda p, *a: jpref.sequence_logprobs(p, *a, jcfg, per_token=True))(
        jp, *_j(flat, pl, sl0))
    ttok, tmask = preference.sequence_logprobs(tp, *_t(flat, pl, sl0), tcfg, per_token=True)
    _close(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    padded, row = flat.copy(), int(np.argmin(sl0))
    assert sl0[row] < flat.shape[1]
    padded[row, -1] = 7  # the last position is this row's pad
    after = preference.sequence_logprobs(tp, *_t(padded, pl, sl0), tcfg)
    torch.testing.assert_close(after, got, rtol=1e-6, atol=0)
    if variant != "full":  # each variant differs from the plain full path
        plain = preference.sequence_logprobs(tp, *_t(flat, pl, sl0), model[2])
        if "softcap" in variant:
            assert (plain - got).abs().max() > 1e-3
        else:
            torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)


def test_dpo_zero_margin_at_the_reference(model):
    """Policy == reference: margin 0 and loss log 2, the DPO fixed point,
    with JAX's metrics."""
    jcfg, jp, tcfg, tp = model
    tokens, pl, sl = make_batch(tcfg.vocab_size)
    jref, _ = jax.jit(lambda p, *a: jpref._pair_logprobs(p, *a, jcfg))(jp, *_j(tokens, pl, sl))
    tref, _ = preference._pair_logprobs(tp, *_t(tokens, pl, sl), tcfg)
    _close(tref.numpy(), np.asarray(jref))
    loss, metrics = preference.dpo_loss(tp, tref, *_t(tokens, pl, sl), tcfg, beta=0.1)
    assert abs(float(loss) - np.log(2.0)) <= TOL * np.log(2.0)
    assert abs(float(metrics["reward_margin"])) <= 1e-6
    _, jm = jax.jit(lambda p, r, *a: jpref.dpo_loss(p, r, *a, jcfg, beta=0.1))(
        jp, jref, *_j(tokens, pl, sl))
    for key in ("chosen_logprob", "rejected_logprob"):
        _close(float(metrics[key]), float(jm[key]))


def test_three_dpo_steps_match_jax(model):
    """make_dpo_step: three clip + AdamW updates on the same batches as the
    JAX step on a one-device mesh: loss, grad norm, margin and accuracy a
    step, and the policy after (relative Frobenius error within TOL, every
    element within 0.05 x lr a step: Adam turns f32 sum-order noise near
    eps into a visible share of lr, tests/test_torch_lora.py). The
    reference is a copy: the tree init_state trains moves, the reference's
    logprobs do not."""
    jcfg, jp, tcfg, tp = model
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    jtx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=0.0))
    jinit, jref_fn, jstep = jpref.make_dpo_step(jp, jcfg, jtx, mesh, rules=ShardingRules(),
                                                beta=BETA)
    jstate = jinit(jax.tree.map(jnp.copy, jp))
    ttx = optim.chain(optim.clip_by_global_norm(CLIP), optim.adamw(LR, weight_decay=0.0))
    policy = llama.tree_map(lambda t: t.clone(), tp)
    tinit, tref_fn, tstep = preference.make_dpo_step(policy, tcfg, ttx, beta=BETA)
    tstate = tinit(policy)
    tokens, pl, sl = make_batch(tcfg.vocab_size, seed=3)
    jref = jref_fn(_j(tokens, pl, sl))
    tref = tref_fn(_t(tokens, pl, sl))
    _close(tref.numpy(), np.asarray(jref))
    assert not tref.requires_grad
    for i in range(3):
        jstate, jm = jstep(jstate, (*_j(tokens, pl, sl), jref))
        tstate, tm = tstep(tstate, (*_t(tokens, pl, sl), tref))
        for key in ("loss", "grad_norm", "reward_margin", "preference_accuracy"):
            want = float(jm[key])
            assert abs(float(tm[key]) - want) <= TOL * max(abs(want), 1e-3), (i, key)
    assert float(tm["reward_margin"]) > 0  # the preference signal trains
    for got, want in zip(llama.tree_leaves(tstate.params),
                         jax.tree_util.tree_leaves(jax.device_get(jstate.params))):
        got, want = got.detach().numpy().astype(np.float64), np.asarray(want, np.float64)
        assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want)
        assert np.abs(got - want).max() <= 0.05 * LR * 3
    torch.testing.assert_close(tref_fn(_t(tokens, pl, sl)), tref, rtol=0, atol=0)


def test_dpo_moe_keeps_router_aux():
    """MoE (4 experts, top 2): at the fixed point the loss is log 2 plus
    moe_aux_coef x aux, equal to JAX's, and the router gets a gradient."""
    jcfg, jp, tcfg, tp = _pair(jllama.LlamaConfig.tiny(
        dtype=jnp.float32, use_flash=False, n_experts=4, expert_top_k=2), 1)
    tokens, pl, sl = make_batch(tcfg.vocab_size, seed=4)
    jref, _ = jax.jit(lambda p, *a: jpref._pair_logprobs(p, *a, jcfg))(jp, *_j(tokens, pl, sl))
    jloss, _ = jax.jit(lambda p, r, *a: jpref.dpo_loss(p, r, *a, jcfg))(
        jp, jref, *_j(tokens, pl, sl))
    tref, _ = preference._pair_logprobs(tp, *_t(tokens, pl, sl), tcfg)
    for leaf in llama.tree_leaves(tp):
        leaf.requires_grad_(True)
    loss, _ = preference.dpo_loss(tp, tref.detach(), *_t(tokens, pl, sl), tcfg)
    assert float(loss.detach()) > np.log(2.0) + 1e-6
    _close(float(loss.detach()), float(jloss))
    routers = [layer["moe"]["router"] for layer in tp["layers"]]
    grads = torch.autograd.grad(loss, routers)
    assert sum(float(g.abs().sum()) for g in grads) > 0.0
