"""DPO, GRPO, their sequence log-probs, the RL learner and generate's
log-probs under a mesh (kubedl_tpu_torch/train/preference.py, train/rl.py,
rl/learner.py, models/decode.py), all on one gloo gang of 4 launched once
(tests/torch_gang.py), on fsdp2·tensor2: fsdp shards the rows and the
ZeRO-3 gather, the tensor axis the heads and the vocabulary. While the gang
runs, this process computes JAX's `make_dpo_step`, `make_grpo_step` and
`sequence_logprobs` on the same mesh over 4 of its CPU devices (tiny, f32,
plain attention), and the port on one device for the learner and decode:

- DPO: three clip + AdamW steps; every rank's loss, grad norm and four
  metrics, and the parameters after, at tests/test_torch_preference.py's
  bounds (the reward margin, a difference of log-prob sums ~20x its size,
  relative to those sums: against its own size the bound sits below f32's
  resolution of its operands, which the mesh's other sum order moves it by,
  ~3.6e-5 relative);
- GRPO with and without old log-probs: three steps whose two token blocks
  hold completions of different lengths, so the token count is the global
  batch's; every rank's metrics at tests/test_torch_grpo.py's bounds (1e-5
  relative, 1e-6 absolute), the parameters after within 1e-5 relative
  (Frobenius) and every element within 0.05 x lr a step, the Adam bound of
  tests/test_torch_preference.py (Adam amplifies the rounding of a near-zero
  gradient, which the mesh sums in another order: one element in 16,384
  lands 1.02e-5 from JAX's, past tests/test_torch_grpo.py's 1e-5 absolute);
- `sequence_logprobs` summed and per token at ce_chunks 1 and 4 (the
  tensor axis takes the full-logits path), and at ce_chunks 4 on
  data2·fsdp2, where the chunked path runs on the gathered head;
- one `LearnerRuntime.train_step` against the learner on one device (the
  parameters at the same Adam bound), and the broadcast's gathered leaves;
- `decode.generate(with_logprobs=True)`, greedy and sampled, against one
  device: tokens equal, log-probs within 1e-4."""
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
from kubedl_tpu.train import rl as jrl
from kubedl_tpu_torch.models import decode, llama
from kubedl_tpu_torch.rl.learner import LearnerConfig, LearnerRuntime
from kubedl_tpu_torch.rl.trajectory import Trajectory
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy
from torch_gang import run_gang

TOL = 1e-5  # relative, f32
MESH = {"fsdp": 2, "tensor": 2}
DPO_LR, CLIP, BETA = 5e-4, 1.0, 0.5
GRPO_LR, KL = 1e-4, 0.04
LEARNER_LR = 1e-3
LOGPROB_TOL = 1e-4  # tests/test_torch_chunked_prefill.py's


def _dpo_batch(vocab, b=4, t=24, seed=0):
    """tests/test_torch_preference.py's pairs."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(b, 2, t)).astype(np.int32)
    prompt_lens = rng.integers(3, 8, size=(b,)).astype(np.int32)
    seq_lens = rng.integers(12, t + 1, size=(b, 2)).astype(np.int32)
    for i in range(b):
        tokens[i, 1, :prompt_lens[i]] = tokens[i, 0, :prompt_lens[i]]
        for j in (0, 1):
            tokens[i, j, seq_lens[i, j]:] = 0
    return tokens, prompt_lens, seq_lens


def _grpo_batch(vocab, seed, n=8, t=24):
    """Rows 0-3 (token block 0) end at 10-13, rows 4-7 (block 1) at
    19-24: the two blocks count different numbers of completion tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(n, t)).astype(np.int32)
    prompt_lens = rng.integers(3, 8, size=(n,)).astype(np.int32)
    seq_lens = np.concatenate([rng.integers(10, 14, n // 2),
                               rng.integers(19, t + 1, n // 2)]).astype(np.int32)
    for i in range(n):
        tokens[i, seq_lens[i]:] = 0
    return tokens, prompt_lens, seq_lens


def _old_logprobs(jcfg, jp, batch, seed):
    """One-device JAX log-probs of `jp`, moved by up to 0.3."""
    (lp, _), _ = jax.jit(lambda p, *a: jpref.sequence_logprobs(
        p, *a, jcfg, with_aux=True, per_token=True))(jp, *map(jnp.asarray, batch))
    rng = np.random.default_rng(seed)
    return (np.asarray(lp) + rng.uniform(-0.3, 0.3, size=lp.shape)).astype(np.float32)


def _groups(vocab, g=4, t=20):
    """Two trajectory groups of tests/test_torch_rl_fleet.py's shape: each
    group one prompt, completions of different lengths, a behavior grid."""
    out = []
    for k in range(2):
        rng = np.random.default_rng(40 + k)
        pl = 4 + k
        tokens = rng.integers(1, vocab, size=(g, t)).astype(np.int32)
        tokens[:, :pl] = tokens[0, :pl]
        seq_lens = rng.integers(pl + 3, t + 1, size=(g,)).astype(np.int32)
        grid = np.zeros((g, t - 1), np.float32)
        for i in range(g):
            tokens[i, seq_lens[i]:] = 0
            grid[i, pl - 1:seq_lens[i] - 1] = rng.uniform(-6.0, -4.0, seq_lens[i] - pl)
        out.append(dict(tokens=tokens, prompt_len=pl, seq_lens=seq_lens,
                        rewards=rng.normal(size=(g,)).astype(np.float32),
                        behavior_logprobs=grid, actor=f"a{k}", seq=k))
    return out


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype="float32", use_flash=True)
    params = jax.device_get(jp)
    vocab = jcfg.vocab_size
    base = dict(config=fields, params=params, ici=MESH)

    dpo_batches = [_dpo_batch(vocab, seed=3 + i) for i in range(3)]
    grpo_batches = {}
    for use_old in (True, False):
        rows = []
        for i in range(3):
            b = _grpo_batch(vocab, seed=10 + i)
            adv = np.random.default_rng(i).normal(size=(8,)).astype(np.float32)
            rows.append((*b, adv, None))
        grpo_batches[use_old] = rows
    seqlp = _grpo_batch(vocab, seed=20)
    seqlp_cases = {"ce1": (MESH, 0), "ce4": (MESH, 4),
                   "ce4_data2_fsdp2": ({"data": 2, "fsdp": 2}, 4)}
    groups = _groups(vocab)
    prompt = np.random.default_rng(5).integers(1, vocab, size=(4, 9)).astype(np.int32)

    # old log-probs: the starting policy's, moved by up to 0.3 so that the
    # ratio clipping bites (one-device JAX; any values test the same sums)
    olds = [_old_logprobs(jcfg, jp, b[:3], i) for i, b in enumerate(grpo_batches[True])]
    grpo_batches[True] = [(*b[:4], o) for b, o in zip(grpo_batches[True], olds)]
    jmesh = build_mesh(MESH, devices=jax.devices()[:4])
    rules = ShardingRules()

    def jtx(lr):
        return optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(lr, weight_decay=0.0))

    cases = [
        dict(base, name="dpo", kind="dpo", batches=dpo_batches, lr=DPO_LR, clip=CLIP,
             beta=BETA),
        *[dict(base, name=f"grpo_old{int(u)}", kind="grpo", batches=grpo_batches[u],
               lr=GRPO_LR, clip=CLIP, kl=KL, use_old=u) for u in (True, False)],
        *[dict(base, name=f"seqlp_{k}", kind="seqlp", ici=ici,
               config=dict(fields, ce_chunks=ce), tokens=seqlp[0], prompt_lens=seqlp[1],
               seq_lens=seqlp[2]) for k, (ici, ce) in seqlp_cases.items()],
        dict(base, name="learner", kind="learner", groups=groups, lr=LEARNER_LR, clip=CLIP,
             kl=KL),
        dict(base, name="decode", kind="decode", logprobs=True, prompt=prompt, new_tokens=6,
             max_len=16, kv_dtype=None, temperature=1.0, seed=3),
    ]

    def jax_side():
        out = {}
        init, ref_fn, step = jpref.make_dpo_step(jp, jcfg, jtx(DPO_LR), jmesh, rules=rules,
                                                 beta=BETA)
        state = init(jax.tree.map(jnp.copy, jp))
        steps = []
        for b in dpo_batches:
            jb = tuple(map(jnp.asarray, b))
            state, m = step(state, (*jb, ref_fn(jb)))
            steps.append({k: float(v) for k, v in m.items()})
        out["dpo"] = (steps, jax.device_get(state.params))

        for use_old in (True, False):
            init, _, ref_fn, step = jrl.make_grpo_step(
                jp, jcfg, jtx(GRPO_LR), jmesh, rules=rules, kl_coef=KL,
                use_old_logprobs=use_old)
            state = init(jax.tree.map(jnp.copy, jp))
            steps = []
            for tokens, pl, sl, adv, old in grpo_batches[use_old]:
                jb = tuple(map(jnp.asarray, (tokens, pl, sl)))
                extra = (jnp.asarray(old),) if use_old else ()
                state, m = step(state, (*jb, jnp.asarray(adv), *extra, ref_fn(jb)))
                steps.append({k: float(v) for k, v in m.items()})
            out[f"grpo_old{int(use_old)}"] = (steps, jax.device_get(state.params))

        for k, (ici, ce) in seqlp_cases.items():
            cfg = dataclasses.replace(jcfg, ce_chunks=ce)
            m = build_mesh(ici, devices=jax.devices()[:4])
            fn = jax.jit(lambda p, *a, cfg=cfg, m=m: (
                jpref.sequence_logprobs(p, *a, cfg, mesh=m, rules=rules),
                jpref.sequence_logprobs(p, *a, cfg, mesh=m, rules=rules, per_token=True)))
            (sums, (lp, mask)) = fn(jp, *map(jnp.asarray, seqlp))
            out[f"seqlp_{k}"] = (np.asarray(sums), np.asarray(lp), np.asarray(mask))

        # the port on one device: the learner's step and decode
        tcfg = config_from_fields(**fields)
        lcfg = LearnerConfig(prompts_per_step=2, group_size=4, lr=LEARNER_LR, grad_clip=CLIP,
                             kl_coef=KL)
        learner = LearnerRuntime(params_from_numpy(params), tcfg, lcfg, consumer=None)
        metrics = learner.train_step([Trajectory(**g) for g in groups])
        out["learner"] = (metrics, jax.tree_util.tree_leaves(
            llama.tree_map(lambda t: t.detach().numpy(), learner.state.params)))
        tp = params_from_numpy(params)
        t = torch.from_numpy(prompt)
        greedy = decode.generate(tp, t, tcfg, 6, max_len=16, with_logprobs=True)
        sampled = decode.generate(tp, t, tcfg, 6, max_len=16, with_logprobs=True,
                                  temperature=1.0, generator=torch.Generator().manual_seed(3))
        out["decode"] = {"greedy": greedy, "sampled": sampled}
        return out

    return run_gang(cases, 4, tmp_path_factory.mktemp("post_training_gang"),
                    meanwhile=jax_side)


def _rel(a, b, floor=1e-3):
    return abs(a - b) <= TOL * max(abs(b), floor)


def _adam_close(got_tree, want_leaves, lr, steps):
    """tests/test_torch_preference.py's parameter bound: relative Frobenius
    error within TOL a leaf, every element within 0.05 x lr a step."""
    for g, w in zip(jax.tree_util.tree_leaves(got_tree), want_leaves):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w)
        assert np.abs(g - w).max() <= 0.05 * lr * steps


def test_dpo_steps_on_fsdp2_tensor2_match_jax_on_every_rank(gang):
    port, ref = gang
    got, (want_steps, want_params) = port["dpo"], ref["dpo"]
    assert got["mesh"] == {"data": 1, "fsdp": 2, "stage": 1, "tensor": 2, "context": 1,
                           "expert": 1}
    assert len(got["ranks"]) == 4
    for rank, r in enumerate(got["ranks"]):
        for i, (tm, jm) in enumerate(zip(r["steps"], want_steps)):
            for key in ("loss", "grad_norm", "preference_accuracy", "chosen_logprob",
                        "rejected_logprob"):
                assert _rel(tm[key], jm[key]), (rank, i, key, tm[key], jm[key])
            sums = BETA * max(abs(jm["chosen_logprob"]), abs(jm["rejected_logprob"]))
            assert _rel(tm["reward_margin"], jm["reward_margin"], floor=sums), (rank, i)
    assert want_steps[-1]["reward_margin"] > 0  # the preference signal trains
    _adam_close(got["ranks"][0]["params"], jax.tree_util.tree_leaves(want_params), DPO_LR, 3)


@pytest.mark.parametrize("use_old", [True, False])
def test_grpo_steps_with_uneven_blocks_match_jax_on_every_rank(gang, use_old):
    port, ref = gang
    name = f"grpo_old{int(use_old)}"
    got, (want_steps, want_params) = port[name], ref[name]
    for rank, r in enumerate(got["ranks"]):
        assert set(r["steps"][0]) == set(want_steps[0])
        for i, (tm, jm) in enumerate(zip(r["steps"], want_steps)):
            for k in jm:
                np.testing.assert_allclose(tm[k], jm[k], rtol=TOL, atol=1e-6,
                                           err_msg=f"rank {rank} step {i + 1} {k}")
    if use_old:
        assert max(s["clip_frac"] for s in want_steps) > 0  # the clipping bites
    _adam_close(got["ranks"][0]["params"], jax.tree_util.tree_leaves(want_params), GRPO_LR, 3)


@pytest.mark.parametrize("case", ["ce1", "ce4", "ce4_data2_fsdp2"])
def test_sequence_logprobs_on_a_mesh_match_jax(gang, case):
    port, ref = gang
    got, (sums, lp, mask) = port[f"seqlp_{case}"], ref[f"seqlp_{case}"]
    for r in got["ranks"]:
        np.testing.assert_array_equal(r["mask"], mask)
        np.testing.assert_allclose(r["sums"], sums, rtol=TOL, atol=0)
        np.testing.assert_allclose(r["lp"], lp, rtol=0, atol=TOL * np.abs(lp).max())


def test_learner_step_on_a_mesh_equals_one_device(gang):
    port, ref = gang
    want_metrics, want_params = ref["learner"]
    for rank, r in enumerate(port["learner"]["ranks"]):
        for k, v in want_metrics.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=TOL, atol=1e-6,
                                       err_msg=f"rank {rank} {k}")
    got = port["learner"]["ranks"][0]
    _adam_close(got["params"], want_params, LEARNER_LR, 1)
    # the broadcast publishes whole tensors: the gathered parameters
    from kubedl_tpu_torch.rl.weights import sorted_leaves

    tree = jax.tree_util.tree_map(torch.from_numpy, got["params"])
    for p, w in zip(got["published"], sorted_leaves(tree)):
        np.testing.assert_array_equal(p, w.numpy())


def test_generate_with_logprobs_on_a_tensor_mesh_equals_one_device(gang):
    port, ref = gang
    for r in port["decode"]["ranks"]:
        for mode in ("greedy", "sampled"):
            toks, lps = r[mode]
            want_toks, want_lps = ref["decode"][mode]
            assert toks == want_toks.tolist(), mode
            np.testing.assert_allclose(lps, want_lps.numpy(), atol=LOGPROB_TOL)
