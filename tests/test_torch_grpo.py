"""kubedl_tpu_torch/train/rl.py and train/grpo.py against the JAX package's
(tests/test_grpo.py) on LlamaConfig.tiny in f32, JAX's parameters carried
across with utils/convert.py: `group_advantages`, `grpo_loss` and every
metric on the same completions (on-policy, off-policy with clipping that
bites, kl_coef 0) and its gradients, three `make_grpo_step` updates against
JAX's on a data4·tensor2 CPU mesh, the reward rising under the port's own
loop; then the workload: prompts from id-list and text JSONL, a run cut at
step 2 and resumed equal bit for bit to one straight through, its
checkpoint read by generate, the rewards, the argument errors and guards."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel.mesh import build_mesh
from kubedl_tpu.train import grpo as jgrpo
from kubedl_tpu.train import preference as jpref
from kubedl_tpu.train import rl as jrl
from kubedl_tpu_torch.models import decode, llama
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.rl.weights import sorted_leaves
from kubedl_tpu_torch.train import checkpoint, generate, grpo, rl
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy

TOL = 1e-5  # relative, f32


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, config_from_fields(**dataclasses.asdict(jcfg))


def _tp(jp):
    return params_from_numpy(jax.device_get(jp))


def make_batch(vocab, n=8, t=24, seed=0):
    """tests/test_grpo.py's: tokens [n, t] zeroed past seq_lens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, size=(n, t)).astype(np.int32)
    prompt_lens = rng.integers(3, 8, size=(n,)).astype(np.int32)
    seq_lens = rng.integers(12, t + 1, size=(n,)).astype(np.int32)
    for i in range(n):
        tokens[i, seq_lens[i]:] = 0
    return tokens, prompt_lens, seq_lens


def _mesh_message():
    """The reference's error for KUBEDL_MESH over one device."""
    from kubedl_tpu.parallel.mesh import build_mesh_from_env

    with pytest.raises(ValueError) as e:
        build_mesh_from_env(devices=jax.devices()[:1])
    return str(e.value)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), (got, want)


def test_group_advantages_match_jax():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(3, 8)).astype(np.float32)
    r[2, :] = 7.0  # a saturated group
    want = np.asarray(jrl.group_advantages(jnp.asarray(r)))
    got = rl.group_advantages(r)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(got[2], torch.zeros(8))


def _jax_lp(jp, jcfg, batch):
    (lp, _), _ = jax.jit(lambda p, *b: jpref.sequence_logprobs(
        p, *b, jcfg, with_aux=True, per_token=True))(jp, *map(jnp.asarray, batch))
    return np.asarray(lp)


@pytest.mark.parametrize("case", ["on_policy", "off_policy", "kl_zero"])
def test_grpo_loss_metrics_and_gradients_match_jax(model, case):
    """The loss, each metric and every gradient leaf against JAX's on the
    same completions: on-policy (old=None), off-policy with old logprobs
    moved by up to +-0.6 so the clip bites on some tokens, and kl_coef 0."""
    jcfg, jp, tcfg = model
    batch = make_batch(tcfg.vocab_size, seed=2)
    lp = _jax_lp(jp, jcfg, batch)
    rng = np.random.default_rng(5)
    adv = rng.normal(size=(batch[0].shape[0],)).astype(np.float32)
    ref = (lp - np.abs(rng.normal(scale=0.3, size=lp.shape))).astype(np.float32)
    old = None
    if case == "off_policy":
        old = (lp + rng.uniform(-0.6, 0.6, size=lp.shape)).astype(np.float32)
    kl = 0.0 if case == "kl_zero" else 0.5

    def jloss(p):
        return jrl.grpo_loss(p, *map(jnp.asarray, batch), jnp.asarray(adv),
                             None if old is None else jnp.asarray(old), jnp.asarray(ref),
                             jcfg, clip_eps=0.2, kl_coef=kl)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = _tp(jp)
    leaves = sorted_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = rl.grpo_loss(tp, *map(torch.from_numpy, batch), torch.from_numpy(adv),
                          None if old is None else torch.from_numpy(old),
                          torch.from_numpy(ref), tcfg, clip_eps=0.2, kl_coef=kl)
    tg = torch.autograd.grad(tl, leaves)
    _close(float(tl.detach()), float(jl))
    assert set(tm) == set(jm)
    for k in tm:
        _close(float(tm[k]), float(jm[k]))
    if case == "off_policy":
        assert 0.0 < float(tm["clip_frac"]) < 1.0
    else:
        assert float(tm["ratio_mean"]) == 1.0 and float(tm["clip_frac"]) == 0.0
    if case == "kl_zero":
        assert float(tm["kl"]) == 0.0 and float(tl.detach()) == float(tm["pg_loss"])
    for got, want in zip(tg, jax.tree_util.tree_leaves(jg)):
        _close(got.numpy(), np.asarray(want))


def test_grpo_clipping_caps_the_surrogate(model):
    """tests/test_grpo.py's: old logprobs 2 below -> every ratio e^2, a
    positive advantage takes the clipped branch: pg = -(1 + eps)."""
    jcfg, jp, tcfg = model
    batch = make_batch(tcfg.vocab_size, seed=2)
    tp = _tp(jp)
    lp, _ = rl.make_grpo_step(tp, tcfg, optim.adamw(1e-3, 0.0))[1](
        tp, tuple(map(torch.from_numpy, batch)))
    loss, m = rl.grpo_loss(tp, *map(torch.from_numpy, batch), torch.ones(8), lp - 2.0, lp,
                           tcfg, clip_eps=0.2, kl_coef=0.0)
    assert float(m["clip_frac"]) == pytest.approx(1.0)
    assert float(m["pg_loss"]) == pytest.approx(-1.2, rel=1e-5)
    assert float(loss) == pytest.approx(-1.2, rel=1e-5)


@pytest.mark.parametrize("use_old", [True, False])
def test_three_grpo_updates_match_jax_on_a_mesh(model, use_old):
    """make_grpo_step with clip + AdamW, three batches: the port on one
    device against JAX's step on data4·tensor2; every metric each step
    (1e-5 relative, 1e-6 absolute) and the parameters after the third
    within 1e-5. Adam turns rounding differences of a gradient near zero
    into update differences of up to lr in that element, so the rate is
    tests/test_rl.py's 1e-4."""
    jcfg, jp, tcfg = model
    lr, kl = 1e-4, 0.04
    mesh = build_mesh({"data": 4, "tensor": 2})
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=0.0))
    jinit, _, jref_fn, jstep = jrl.make_grpo_step(jp, jcfg, jtx, mesh, kl_coef=kl,
                                                  use_old_logprobs=use_old)
    jstate = jinit(jax.tree.map(jnp.copy, jp))
    ttx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(lr, weight_decay=0.0))
    tinit, _, tref_fn, tstep = rl.make_grpo_step(_tp(jp), tcfg, ttx, kl_coef=kl,
                                                 use_old_logprobs=use_old)
    tstate = tinit(_tp(jp))
    for i in range(3):
        batch = make_batch(tcfg.vocab_size, seed=10 + i)
        rng = np.random.default_rng(i)
        adv = rng.normal(size=(8,)).astype(np.float32)
        jb = tuple(map(jnp.asarray, batch))
        tb = tuple(map(torch.from_numpy, batch))
        jref, tref = jref_fn(jb), tref_fn(tb)
        _close(tref.numpy(), np.asarray(jref))
        extra_j, extra_t = (), ()
        if use_old:
            old = (_jax_lp(jstate.params, jcfg, batch)
                   + rng.uniform(-0.3, 0.3, size=(8, 23))).astype(np.float32)
            extra_j, extra_t = (jnp.asarray(old),), (torch.from_numpy(old),)
        jstate, jm = jstep(jstate, (*jb, jnp.asarray(adv), *extra_j, jref))
        tstate, tm = tstep(tstate, (*tb, torch.from_numpy(adv), *extra_t, tref))
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, atol=1e-6,
                                       err_msg=f"step {i + 1} {k}")
    for got, want in zip(sorted_leaves(tstate.params),
                         jax.tree_util.tree_leaves(jax.device_get(jstate.params))):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)


def test_kl_zero_keeps_no_reference(model):
    jcfg, jp, tcfg = model
    _, _, ref_fn, _ = rl.make_grpo_step(_tp(jp), tcfg, optim.adamw(1e-3, 0.0), kl_coef=0.0)
    batch = tuple(map(torch.from_numpy, make_batch(tcfg.vocab_size, seed=7)))
    ref = ref_fn(batch)
    assert ref.shape == (8, 23) and not ref.any()
    cells = [c.cell_contents for c in ref_fn.__closure__ if c.cell_contents is None]
    assert cells == [None]  # the closed-over reference tree is None


def test_grpo_raises_reward(model):
    """tests/test_grpo.py's end-to-end check on the port: reward = share of
    completion tokens equal to 5, fresh rollouts each iteration, 12
    on-policy steps; the late mean reward beats the early one."""
    jcfg, jp, tcfg = model
    B, G, P, K, target = 2, 8, 8, 8, 5
    init_state, _, ref_fn, step = rl.make_grpo_step(
        _tp(jp), tcfg, optim.adamw(3e-3, weight_decay=0.0), kl_coef=0.01,
        use_old_logprobs=False)
    state = init_state(_tp(jp))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(np.repeat(
        rng.integers(1, tcfg.vocab_size, (B, P)).astype(np.int32), G, axis=0))
    plens = torch.full((B * G,), P, dtype=torch.int32)
    slens = torch.full((B * G,), P + K, dtype=torch.int32)
    hist = []
    for it in range(12):
        with torch.no_grad():
            comp = decode.generate(state.params, prompts, tcfg, K, temperature=1.0,
                                   generator=grpo.sampling_generator("cpu", 0, it))
        rewards = (comp == target).float().mean(dim=1)
        hist.append(float(rewards.mean()))
        adv = rl.group_advantages(rewards.reshape(B, G)).reshape(-1)
        batch = (torch.cat([prompts, comp], 1), plens, slens)
        state, m = step(state, (*batch, adv, ref_fn(batch)))
        assert np.isfinite(float(m["loss"])) and float(m["kl"]) >= 0.0
    assert np.mean(hist[-4:]) > np.mean(hist[:4]) + 0.02, hist


# ---------------------------------------------------------------------------
# the workload
# ---------------------------------------------------------------------------


def _write(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _id_prompts(tmp_path):
    rng = np.random.default_rng(0)
    rows = [{"prompt": rng.integers(1, 250, size=n).tolist()} for n in (4, 6, 5)]
    rows.append({"prompt": list(range(1, 300))})  # too long: skipped
    return _write(tmp_path / "prompts.jsonl", rows)


def test_load_prompts_equal_jax(tmp_path, capsys):
    data = _id_prompts(tmp_path)
    want = jgrpo.load_prompts(data, 250)
    jout = capsys.readouterr().out
    assert grpo.load_prompts(data, 250) == want
    assert capsys.readouterr().out == jout
    empty = _write(tmp_path / "e.jsonl", [{"prompt": []}])
    for mod in (jgrpo, grpo):
        with pytest.raises(ValueError, match="no usable prompts"):
            mod.load_prompts(empty, 16)


def test_text_prompts_through_the_tokenizer(tmp_path, capsys):
    """Text JSONL through a word-level tokenizer equals JAX's prompts; text
    without a tokenizer raises JAX's error; grpo --hf-model on a tiny
    Gemma-2 directory trains on them."""
    pytest.importorskip("transformers")
    from hf_dirs import GEMMA2, save_hf, save_word_tokenizer

    from kubedl_tpu.train import generate as jgenerate

    hf = str(tmp_path / "gemma2")
    save_hf(hf, *GEMMA2, seed=1)
    save_word_tokenizer(hf, GEMMA2[1]["vocab_size"])
    data = _write(tmp_path / "text.jsonl", [{"prompt": "w25 w26 w27"},
                                            {"prompt": "user w11"}, {"prompt": [2, 20, 21]}])
    want = jgrpo.load_prompts(data, 16, tokenizer=jgenerate.load_tokenizer(hf))
    assert grpo.load_prompts(data, 16, tokenizer=generate.load_tokenizer(hf)) == want
    assert want[0][0] == 2  # the prompt gets <bos>
    with pytest.raises(ValueError) as je:
        jgrpo.load_prompts(data, 16)
    with pytest.raises(ValueError) as te:
        grpo.load_prompts(data, 16)
    assert str(te.value) == str(je.value)
    assert grpo.main(["--device", "cpu", "--hf-model", hf, "--data-path", data, "--steps", "2",
                      "--prompts-per-step", "2", "--group-size", "2", "--max-new-tokens", "4",
                      "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "data: 3 prompts from" in out and "done: 2 steps" in out


def _state(path, step):
    return torch.load(f"{path}/{step}/{checkpoint.STATE_FILE}", weights_only=True)


@pytest.mark.parametrize("inner", [1, 2])
def test_resume_equals_a_straight_run(tmp_path, capsys, inner):
    """Ragged id-list prompts; 3 steps straight, and 2 steps then a rerun
    to 3 that restores step 2: the step-3 checkpoints are equal bit for
    bit (the sampling noise of a step derives from the step), on-policy
    and with two inner epochs on the rollout's behavior logprobs. The
    policy is read back by generate and served by its CLI."""
    data = _id_prompts(tmp_path)
    base = ["--device", "cpu", "--model", "tiny", "--data-path", data, "--prompts-per-step",
            "2", "--group-size", "4", "--max-new-tokens", "6", "--lr", "1e-3", "--log-every",
            "1", "--inner-epochs", str(inner)]
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    assert grpo.main(base + ["--steps", "3", "--checkpoint-path", straight]) == 0
    out = capsys.readouterr().out
    assert "data: skipped 1 prompts over 250 tokens" in out
    assert "saved policy checkpoint at step 3" in out
    assert grpo.main(base + ["--steps", "2", "--checkpoint-path", cut]) == 0
    assert grpo.main(base + ["--steps", "3", "--checkpoint-path", cut]) == 0
    out = capsys.readouterr().out
    assert "restored policy checkpoint at step 2" in out and "done: 1 steps" in out
    a, b = _state(straight, 3), _state(cut, 3)
    assert a["step"] == b["step"] == 3 * inner
    for x, y in zip(llama.tree_leaves(a), llama.tree_leaves(b)):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    restored = generate.restore_params(straight, device="cpu")
    for x, y in zip(llama.tree_leaves(restored), llama.tree_leaves(a["params"])):
        assert torch.equal(x, y)
    fresh = llama.init(llama.LlamaConfig.tiny(), torch.Generator().manual_seed(0), device="cpu")
    assert any(not torch.equal(x, y) for x, y in zip(llama.tree_leaves(restored),
                                                     llama.tree_leaves(fresh)))
    if inner == 1:
        assert generate.main(["--device", "cpu", "--model", "tiny", "--checkpoint-path",
                              straight, "--batch", "2", "--prompt-len", "6",
                              "--max-new-tokens", "3"]) == 0


def test_reward_functions_equal_jax(tmp_path, monkeypatch):
    mod = tmp_path / "myreward.py"
    mod.write_text("def reward(prompt, completion):\n"
                   "    return float(len(completion) - len(prompt))\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    cases = [["--reward", "length", "--eos-id", "0", "--target-len", "4",
              "--max-new-tokens", "8"], ["--reward-token", "3"],
             ["--reward-module", "myreward:reward"]]
    rng = np.random.default_rng(0)
    for argv in cases:
        jf = jgrpo.make_reward_fn(jgrpo.parse_args(argv))
        tf = grpo.make_reward_fn(grpo.parse_args(argv))
        for _ in range(8):
            p, c = rng.integers(0, 6, 3).tolist(), rng.integers(0, 6, rng.integers(0, 9)).tolist()
            assert tf(p, c) == jf(p, c)


@pytest.mark.parametrize("argv", [["--reward", "length"], ["--temperature", "0"],
                                  ["--group-size", "1"],
                                  ["--inner-epochs", "2", "--accum-steps", "2"]])
def test_parse_args_errors_equal_jax(argv, capsys):
    with pytest.raises(SystemExit):
        jgrpo.parse_args(argv)
    jerr = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as e:
        grpo.parse_args(argv)
    terr = capsys.readouterr().err.strip().splitlines()[-1]
    assert e.value.code == 2
    assert terr.split("error: ", 1)[1] == jerr.split("error: ", 1)[1]


def test_workload_guards(tmp_path, monkeypatch, capsys):
    """No base checkpoint without --allow-fresh-init: exit 1; a mesh whose
    size is not the gang's (data=2 on one process): exit 2 with the
    reference's message; the card asked for where there is none raises."""
    tiny = ["--device", "cpu", "--model", "tiny", "--steps", "1"]
    assert grpo.main(tiny + ["--ref-checkpoint-path", str(tmp_path / "nope")]) == 1
    assert "error: no checkpoint under" in capsys.readouterr().err
    monkeypatch.setenv("KUBEDL_MESH", "data=2")
    assert grpo.main(tiny) == 2
    assert _mesh_message() in capsys.readouterr().err
    monkeypatch.delenv("KUBEDL_MESH")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        grpo.main(["--model", "tiny", "--steps", "1"])


def test_sampling_generator_is_the_step_schedule():
    a = grpo.sampling_generator("cpu", 0, 3)
    b = grpo.sampling_generator("cpu", 0, 3)
    c = grpo.sampling_generator("cpu", 0, 1003, 3)
    draws = [torch.rand(4, generator=g) for g in (a, b, c)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
