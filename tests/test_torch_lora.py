"""kubedl_tpu_torch/models/lora.py against the JAX package's
(tests/test_lora.py): LlamaConfig.tiny in f32, JAX's parameters and adapters
carried across with utils/convert.py. `merge` and the loss on the merged
tree within 1e-5 relative; three `make_lora_step` AdamW steps (losses, grad
norms, adapters) against JAX's on a one-device mesh, and on a gloo gang of
8 (tests/torch_gang.py) against JAX's on the reference test's data4·tensor2
mesh, every rank; the base unchanged bit for bit and the optimizer state
adapter-sized. Then the trainer's --lora-rank on the CPU: adapter-only
checkpoints, resume, a gloo gang of 4 on fsdp=2,tensor=2 against the
one-device LoRA step, and generate / serve consuming the checkpoints."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.models import lora as jlora
from kubedl_tpu.parallel.mesh import ShardingRules, build_mesh
from kubedl_tpu_torch.models import decode, llama, lora
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.train import checkpoint, generate, serve, trainer
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy
from torch_gang import run_gang

TOL = 1e-5  # relative, f32
LR, CLIP = 1e-3, 1.0


def _port_cfg(jcfg):
    return dataclasses.replace(config_from_fields(**dataclasses.asdict(jcfg)), use_flash=True)


def _noisy(tree, seed, scale=0.05):
    """`tree` with every leaf replaced by seeded normal noise (so B is not
    zero and the adapter moves the model)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape) * scale,
                                              jnp.float32), tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False)
    jp = jllama.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, _port_cfg(jcfg), params_from_numpy(jax.device_get(jp))


def _tokens(b, t, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)


def _leaves(tree):
    return list(llama.tree_leaves(tree))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _close_after_adam(got, want):
    """Adapters after AdamW steps: within TOL of the leaf's norm (relative
    Frobenius error), and every element within 0.05 x lr a step. Adam's
    update g / (sqrt(v) + eps) turns f32 sum-order noise in a gradient
    element near eps into a visible share of lr for that element alone
    (tests/test_torch_sharded_step.py UPDATE_TOL), so a max-element relative
    bound would measure that noise, not the port."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 0.05 * LR * 3


def test_zero_b_init_is_identity(model):
    _, _, tcfg, tp = model
    adapters = lora.lora_init(torch.Generator().manual_seed(1), tp, rank=4)
    assert all(float(e[n]["b"].abs().max()) == 0.0
               for e in adapters["layers"] for n in e)
    merged = lora.merge(tp, adapters)
    tokens = torch.arange(12)[None] % tcfg.vocab_size
    torch.testing.assert_close(llama.forward(merged, tokens, tcfg),
                               llama.forward(tp, tokens, tcfg), rtol=0, atol=1e-6)


def test_adapter_size_and_rank_check(model):
    jcfg, jp, _, tp = model
    adapters = lora.lora_init(torch.Generator().manual_seed(1), tp, rank=4)
    want = jlora.adapter_count(jlora.lora_init(jax.random.PRNGKey(1), jp, rank=4))
    assert lora.adapter_count(adapters) == want < 0.1 * llama.param_count(tp)
    a = adapters["layers"][0]["wq"]["a"]
    assert a.shape == (128, 4) and a.dtype == torch.float32
    assert 0.5 < float(a.std() * 128 ** 0.5) < 1.5  # fan-in noise
    with pytest.raises(ValueError, match="rank must be >= 1, got 0"):
        lora.lora_init(torch.Generator(), tp, rank=0)


@pytest.mark.parametrize("alpha", [None, 8.0])
def test_merge_and_loss_match_jax(model, alpha):
    """merge and loss_fn on the merged tree against JAX's, on JAX's
    adapters with noisy B; the base tree is unchanged bit for bit."""
    jcfg, jp, tcfg, tp = model
    jad = _noisy(jlora.lora_init(jax.random.PRNGKey(3), jp, rank=4), 5)
    tad = params_from_numpy(jax.device_get(jad))
    before = [t.clone() for t in _leaves(tp)]
    jm = jax.device_get(jlora.merge(jp, jad, alpha=alpha))
    tm = lora.merge(tp, tad, alpha=alpha)
    for got, want in zip(_leaves(tm), jax.tree_util.tree_leaves(jm)):
        assert _rel(got.numpy(), want) <= TOL
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(tp)))
    toks = _tokens(2, 17, 0)
    jl = float(jllama.loss_fn(jlora.merge(jp, jad, alpha=alpha), jnp.asarray(toks), jcfg))
    tl = float(llama.loss_fn(tm, torch.from_numpy(toks), tcfg))
    assert abs(tl - jl) <= TOL * abs(jl)
    base_loss = float(llama.loss_fn(tp, torch.from_numpy(toks), tcfg))
    assert abs(tl - base_loss) > 1e-3  # the adapter moved the model


def test_lora_step_matches_jax(model):
    """Three make_lora_step updates (clip 1.0 + AdamW, as the trainer
    builds them) from JAX's adapters0 against the JAX step on a one-device
    mesh: losses and grad norms within 1e-5 relative, the adapters within
    1e-5 relative (`_close_after_adam`); the base never changes and the
    optimizer state is adapter-sized."""
    jcfg, jp, tcfg, tp = model
    mesh = build_mesh({"data": 1}, devices=jax.devices()[:1])
    jtx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=0.01))
    jad0, jinit, jstep = jlora.make_lora_step(jp, jcfg, jtx, mesh, rules=ShardingRules(),
                                              rank=4)
    jstate = jinit(jad0)
    ttx = optim.chain(optim.clip_by_global_norm(CLIP), optim.adamw(LR, weight_decay=0.01))
    _, tinit, tstep = lora.make_lora_step(tp, tcfg, ttx, rank=4)
    tstate = tinit(params_from_numpy(jax.device_get(jad0)))
    before = [t.clone() for t in _leaves(tp)]
    for i in range(3):
        toks = _tokens(4, 17, 10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(toks))
        tstate, tm = tstep(tstate, torch.from_numpy(toks))
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= TOL * abs(float(jm[key])), (i, key)
    for got, want in zip(_leaves(tstate.params),
                         jax.tree_util.tree_leaves(jax.device_get(jstate.params))):
        _close_after_adam(got.detach().numpy(), want)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(tp)))
    assert not any(t.requires_grad for t in _leaves(tp))
    opt_elems = sum(t.numel() for t in llama.tree_leaves(tstate.opt_state)
                    if torch.is_tensor(t))
    assert 0 < opt_elems <= 2 * lora.adapter_count(tstate.params) < \
        0.3 * llama.param_count(tp)
    b_norm = sum(float(e[n]["b"].detach().abs().sum()) for e in tstate.params["layers"] for n in e)
    assert b_norm > 0  # B started at zero and moved


def test_moe_layers_skipped():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, n_experts=2,
                                   expert_top_k=1)
    tcfg = _port_cfg(jcfg)
    tp = params_from_numpy(jax.device_get(jllama.init(jcfg, jax.random.PRNGKey(4))))
    adapters = lora.lora_init(torch.Generator().manual_seed(5), tp, rank=2)
    assert set(adapters["layers"][0]) == {"wq", "wk", "wv", "wo"}
    tokens = torch.arange(10)[None]
    torch.testing.assert_close(llama.forward(lora.merge(tp, adapters), tokens, tcfg),
                               llama.forward(tp, tokens, tcfg), rtol=0, atol=1e-6)


def test_mismatch_and_bad_targets_rejected(model):
    """The reference's errors, word for word."""
    _, jp, _, tp = model

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    assert message(lambda: lora.lora_init(torch.Generator(), tp, targets=("q_proj",))) == \
        message(lambda: jlora.lora_init(jax.random.PRNGKey(0), jp, targets=("q_proj",)))
    tad = lora.lora_init(torch.Generator(), tp, rank=2)
    jad = jlora.lora_init(jax.random.PRNGKey(0), jp, rank=2)
    got = message(lambda: lora.merge(tp, {"layers": tad["layers"][:1]}))
    assert "layer-count mismatch" in got
    assert got == message(lambda: jlora.merge(jp, {"layers": jad["layers"][:1]}))
    with pytest.raises(ValueError, match="no adapter checkpoint"):
        lora.restore_and_merge(tp, "/nonexistent/adapters")


def test_lora_under_decode_mesh_is_refused(model):
    _, _, tcfg, tp = model
    cache = decode.init_kv_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        decode.prefill(tp, torch.ones((1, 4), dtype=torch.int32), cache, tcfg,
                       mesh=object(), lora={"layers": []},
                       adapter_ids=torch.zeros(1, dtype=torch.int32))


# --------------------------------------------------------------------------
# the step on a gang: data4 x tensor2, the reference test's mesh
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gang(tmp_path_factory, model):
    jcfg, jp, _, _ = model
    jad0 = jlora.lora_init(jax.random.PRNGKey(7), jp, rank=4)
    batches = [_tokens(4, 33, 20 + i) for i in range(3)]
    fields = dataclasses.asdict(jcfg)
    fields.update(dtype="float32", use_flash=True)
    case = dict(name="lora_data4_tensor2", kind="lora", ici={"data": 4, "tensor": 2},
                config=fields, params=jax.device_get(jp), adapters=jax.device_get(jad0),
                batches=batches, lr=LR, clip=CLIP, rank=4, alpha=8.0)

    def jax_side():
        mesh = build_mesh({"data": 4, "tensor": 2}, devices=jax.devices()[:8])
        tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR, weight_decay=0.01))
        _, init, step = jlora.make_lora_step(jp, jcfg, tx, mesh, rules=ShardingRules(),
                                             rank=4, alpha=8.0)
        state = init(jad0)
        losses, norms = [], []
        for b in batches:
            state, m = step(state, jnp.asarray(b))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return {"loss": losses, "grad_norm": norms,
                "adapters": jax.tree_util.tree_leaves(jax.device_get(state.params))}

    port, ref = run_gang([case], 8, tmp_path_factory.mktemp("lora_gang"), meanwhile=jax_side)
    return port["lora_data4_tensor2"], ref


def test_lora_step_on_data4_tensor2_matches_jax_on_every_rank(gang):
    port, ref = gang
    assert port["mesh"] == {"data": 4, "fsdp": 1, "stage": 1, "tensor": 2, "context": 1,
                            "expert": 1}
    assert len(port["ranks"]) == 8
    for rank, got in enumerate(port["ranks"]):
        for key in ("loss", "grad_norm"):
            for a, b in zip(got[key], ref[key]):
                assert abs(a - b) <= TOL * abs(b), (rank, key, a, b)
        assert len(got["adapters"]) == len(ref["adapters"])
        for a, b in zip(got["adapters"], ref["adapters"]):
            _close_after_adam(a, b)
        assert got["adapters_replicated"] and got["base_unchanged"], rank


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------

TINY = ["--device", "cpu", "--model", "tiny", "--batch", "2", "--seq-len", "17"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A --lora-rank 2 trainer run's checkpoint directory (3 steps, a save
    at step 2 and the final one)."""
    path = str(tmp_path_factory.mktemp("lora_ckpt"))
    assert trainer.main(TINY + ["--steps", "3", "--lora-rank", "2", "--log-every", "100",
                                "--checkpoint-path", path, "--checkpoint-interval", "2"]) == 0
    return path


def test_trainer_checkpoints_hold_the_adapters_only(trained, capsys):
    assert checkpoint.all_steps(trained) == [2, 3]
    saved = torch.load(f"{trained}/3/state.pt", weights_only=True)
    assert set(saved["params"]) == {"layers"}
    assert set(saved["params"]["layers"][0]) == set(lora.DEFAULT_TARGETS)
    assert saved["params"]["layers"][0]["wq"]["a"].shape == (128, 2)
    n_ad = lora.adapter_count(saved["params"])
    opt = sum(t.numel() for t in llama.tree_leaves(saved["opt_state"]) if torch.is_tensor(t))
    assert 0 < opt <= 2 * n_ad + 8
    # resume: a longer run picks up at the last step
    assert trainer.main(TINY + ["--steps", "4", "--lora-rank", "2", "--log-every", "100",
                                "--checkpoint-path", trained]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 3" in out and "saved final checkpoint at step 4" in out
    assert "lora: rank 2, 8192 adapter params (2.27% of base)" in out


def test_trainer_lora_gang_trains_as_one_device(tmp_path):
    """trainer --lora-rank 2 as a gloo gang of 4 on fsdp=2,tensor=2 (the
    base sharded over both, the adapters replicated), in f32: rank 0's
    losses equal a one-device make_lora_step's on the same global batches
    (1e-5 relative), and the sharded adapter checkpoint restore_params
    reads back holds those steps' adapters."""
    from test_torch_trainer_gang import _finish, _losses, _shard, _start

    from kubedl_tpu_torch.native import loader as tloader

    data = _shard(tmp_path)
    ckpt, trace = tmp_path / "ckpt", tmp_path / "trace"
    rcs, outs = _finish(_start(4, TINY + ["--steps", "3", "--log-every", "100",
                                          "--lora-rank", "2", "--data-path", data,
                                          "--checkpoint-path", str(ckpt)],
                               "fsdp=2,tensor=2", trace))
    assert rcs == [0] * 4, outs
    assert "lora: rank 2, 8192 adapter params" in outs[0]
    assert checkpoint.all_steps(str(ckpt)) == [3]
    config = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init(config, torch.Generator().manual_seed(0), device="cpu")
    _, init_state, step = lora.make_lora_step(params, config,
                                              optim.adamw(3e-4, weight_decay=0.01), rank=2)
    state = init_state(lora.lora_init(None, params, rank=2))
    loader = tloader.PyTokenLoader([str(tmp_path / "shard-0.bin")], batch=2, seq_len=17, seed=0)
    want = []
    for s in range(3):  # rank (fsdp f, tensor t) reads batch id step * 2 + f
        batch = np.concatenate([loader.batch_at(s * 2 + f) for f in (0, 1)])
        state, m = step(state, torch.from_numpy(np.ascontiguousarray(batch)))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(_losses(trace), want, rtol=TOL)
    saved = generate.restore_params(str(ckpt), device="cpu")
    for got, ref in zip(saved["layers"], state.params["layers"]):
        assert set(got) == set(ref) == set(lora.DEFAULT_TARGETS)
        for name in ref:
            for part in ("a", "b"):
                _close_after_adam(got[name][part].numpy(), ref[name][part].detach().numpy())


def test_generate_and_serve_consume_the_adapter_checkpoint(trained, capsys):
    """generate --lora-checkpoint-path decodes the merged tree; serve
    --lora-checkpoint-path answers with the same tokens."""
    import json
    import threading
    import urllib.request

    base = llama.init(llama.LlamaConfig.tiny(), torch.Generator().manual_seed(0), device="cpu")
    ad = generate.restore_params(trained, device="cpu")
    merged = lora.merge(base, ad)
    cfg = llama.LlamaConfig.tiny()
    prompt = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    want = decode.generate(merged, prompt, cfg, 4)[0].tolist()
    assert generate.main(["--device", "cpu", "--lora-checkpoint-path", trained, "--batch", "1",
                          "--prompt-len", "8", "--max-new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert f"sample[0,:8]={want}" in out and "restored lora adapters params" in out
    args = serve.parse_args(["--device", "cpu", "--port", "0", "--bind", "127.0.0.1",
                             "--max-len", "32", "--lora-checkpoint-path", trained])
    httpd, svc = serve.build_server(args)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            data=json.dumps({"tokens": prompt[0].tolist(), "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["tokens"] == want
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        httpd.server_close()
        svc.stop()
