"""The port's pipeline plumbing against the JAX package: the schedule
helpers and the shared shape rules (parallel/pipeline.py,
api/validation.py), the stage plan and parameter split and the boundary
wire (parallel/pipeline_mpmd.py), and the in-process MPMD pipeline
(train/pipeline_runtime.py `MPMDPipeline`: 2 stages, M 4, dense and MoE)
against JAX's on the same parameters carried across with
utils/convert.py. LlamaConfig.tiny in f32 at 4 layers; the tolerances
are tests/test_pipeline_1f1b.py's (loss 1e-5, gradients atol 2e-4 rtol
2e-3), the parameters after three AdamW steps within 1e-5 but where
JAX's gradient fell below 1e-6 at some step: there Adam's update turns
rounding of a gradient near its eps into a share of lr, held to
0.05 x lr x 3."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from kubedl_tpu.api import validation as jval
from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel import pipeline as jpipe
from kubedl_tpu.parallel import pipeline_mpmd as jmpmd
from kubedl_tpu.train import pipeline_runtime as jrt
from kubedl_tpu_torch.api import validation as tval
from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel import optim, pipeline, pipeline_mpmd
from kubedl_tpu_torch.train import pipeline_runtime as rt
from kubedl_tpu_torch.utils.convert import config_from_fields, params_from_numpy


def _flat(tree, prefix="", specs=False):
    """[(path, leaf)] with dict keys sorted (JAX's leaf order); with specs,
    a PartitionSpec (a tuple) is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{prefix}{k}.", specs)]
    if isinstance(tree, (list, tuple)) and not (specs and type(tree).__name__ ==
                                                "PartitionSpec"):
        return [x for i, v in enumerate(tree) for x in _flat(v, f"{prefix}{i}.", specs)]
    return [(prefix[:-1], tree)]


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype == ml_dtypes.bfloat16 \
        else np.asarray(x)


def models(seed=0, **kw):
    """(JAX config, JAX params, the port's config, a fresh port tree)."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, remat=False,
                                   n_layers=4, **kw)
    jparams = jllama.init(jcfg, jax.random.PRNGKey(seed))
    fields = dict(dataclasses.asdict(jcfg), dtype="float32")
    cfg = config_from_fields(**fields)
    host = jax.device_get(jparams)
    return jcfg, jparams, cfg, lambda: params_from_numpy(host)


def tokens_for(vocab, batch=8, seq=17, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)


# ---------------------------------------------------------------------------
# the helpers and the shared shape rules
# ---------------------------------------------------------------------------


def test_schedule_helpers_match_jax():
    for m, s, v in itertools.product((1, 2, 4, 8), (1, 2, 4), (1, 2, 3)):
        assert pipeline.schedule_steps(m, s, v) == jpipe.schedule_steps(m, s, v)
        assert pipeline.bubble_fraction(m, s, v) == jpipe.bubble_fraction(m, s, v)
    for n, s, v in ((8, 2, 2), (8, 4, 1), (16, 4, 2), (12, 2, 3), (4, 1, 4)):
        np.testing.assert_array_equal(pipeline.interleaved_layer_order(n, s, v),
                                      jpipe.interleaved_layer_order(n, s, v))


GRID = list(itertools.product((0, 1, 2, 4), (1, 2, 4, 8), (0, 1, 2), (None, 4, 6, 8),
                              (None, "gpipe", "1f1b", "zigzag")))


def test_validate_pipeline_shapes_messages_equal():
    assert tval.PIPELINE_SCHEDULES == jval.PIPELINE_SCHEDULES
    nonempty = 0
    for s, m, v, n, sched in GRID:
        for path in ("spec.pipeline", "forward_pipelined"):
            got = tval.validate_pipeline_shapes(s, m, v, n_layers=n, schedule=sched, path=path)
            assert got == jval.validate_pipeline_shapes(s, m, v, n_layers=n, schedule=sched,
                                                        path=path), (s, m, v, n, sched)
            nonempty += bool(got)
    assert 0 < nonempty < 2 * len(GRID)


def test_microbatch_layout_matches_jax():
    x = np.arange(16 * 3).reshape(16, 3)
    np.testing.assert_array_equal(pipeline.microbatch(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jpipe.microbatch(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        pipeline.unmicrobatch(pipeline.microbatch(torch.from_numpy(x), 4)).numpy(), x)
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        pipeline.microbatch(torch.from_numpy(x), 3)
    # local_rows: the rank's rows, microbatched, are its block of each of
    # the reference's microbatches (a microbatch split over the batch axes)
    ref = np.asarray(jpipe.microbatch(jnp.asarray(x), 4))  # [4, 4, 3]
    for block in range(2):
        mine = pipeline.microbatch(torch.from_numpy(x[pipeline.local_rows(16, 4, block, 2)]), 4)
        np.testing.assert_array_equal(mine.numpy(), ref[:, block * 2:(block + 1) * 2])
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.local_rows(16, 4, 0, 3)


def test_stacking_and_specs_match_jax():
    jcfg, jparams, cfg, fresh = models(n_experts=4, expert_top_k=2)
    stacked = llama.stack_params(fresh())
    want = _flat(jax.device_get(jllama.stack_params(jparams)))
    got = _flat(stacked)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
    back = pipeline.unstack_layers(stacked["layers"], 4)
    for (path, a), (_, b) in zip(_flat(back), _flat(fresh()["layers"])):
        assert torch.equal(a, b), path
    jspecs = _flat(jllama.param_specs_pp(jcfg), specs=True)
    tspecs = _flat(llama.param_specs_pp(cfg), specs=True)
    assert [(p, tuple(s)) for p, s in tspecs] == [(p, tuple(s)) for p, s in jspecs]


def _fake_mesh(axes):
    """What the pipelined path's checks read of a DeviceMesh: its dims."""
    import types

    names = ("data", "fsdp", "stage", "tensor", "context", "expert")
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=torch.empty([axes.get(n, 1) for n in names]))


@pytest.mark.parametrize("case", ["layer_windows", "tensor", "context", "expert",
                                  "schedule", "interleave_gpipe"])
def test_pipelined_path_refusals_match_jax(case):
    from kubedl_tpu.parallel.mesh import build_mesh as jbuild_mesh

    kw, axes, sched, v = {}, {"stage": 2}, "gpipe", 1
    if case == "layer_windows":
        kw = dict(layer_windows=(None, 4, None, 4))
    elif case in ("tensor", "context", "expert"):
        axes = {"stage": 2, case: 2}
    elif case == "schedule":
        sched = "zigzag"
    else:
        v = 2
    jcfg, jparams, cfg, fresh = models(**kw)
    tokens = tokens_for(jcfg.vocab_size, seq=16)
    jmesh = jbuild_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    with pytest.raises(ValueError) as want:
        jllama.forward_pipelined_and_aux(jllama.stack_params(jparams), jnp.asarray(tokens),
                                         jcfg, jmesh, schedule=sched, interleave=v)
    with pytest.raises(ValueError) as got:
        llama.forward_pipelined_and_aux(llama.stack_params(fresh()), torch.from_numpy(tokens),
                                        cfg, _fake_mesh(axes), schedule=sched, interleave=v)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the stage plan and the split
# ---------------------------------------------------------------------------


def test_stage_plan_and_split_match_jax():
    jcfg, jparams, cfg, fresh = models()
    for n, s, m in ((4, 2, 4), (4, 4, 4), (4, 1, 2), (8, 2, 8)):
        assert pipeline_mpmd.make_stage_plan(n, s, m) == pipeline_mpmd.StagePlan(n, s, m)
        jplan = jmpmd.make_stage_plan(n, s, m)
        for st in range(s):
            assert pipeline_mpmd.StagePlan(n, s, m).layer_range(st) == jplan.layer_range(st)
    for bad in ((4, 3, 4), (4, 2, 1), (4, 0, 4)):
        with pytest.raises(ValueError) as got:
            pipeline_mpmd.make_stage_plan(*bad)
        with pytest.raises(ValueError) as want:
            jmpmd.make_stage_plan(*bad)
        assert str(got.value) == str(want.value)
    plan, jplan = pipeline_mpmd.make_stage_plan(4, 2, 4), jmpmd.make_stage_plan(4, 2, 4)
    tree = fresh()
    for st in range(2):
        got = _flat(pipeline_mpmd.split_stage_params(tree, plan, st))
        want = _flat(jax.device_get(jmpmd.split_stage_params(jparams, jplan, st)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)
    with pytest.raises(ValueError, match=r"stage 2 out of range \[0, 2\)"):
        plan.layer_range(2)
    # the split works on spec trees too
    assert pipeline_mpmd.split_stage_params(llama.param_specs(cfg), plan, 1)["lm_head"] == \
        llama.param_specs(cfg)["lm_head"]


def test_split_refuses_tied_embeddings_as_jax():
    jcfg, jparams, cfg, fresh = models(tie_embeddings=True)
    plan, jplan = pipeline_mpmd.make_stage_plan(4, 2, 4), jmpmd.make_stage_plan(4, 2, 4)
    with pytest.raises(ValueError) as got:
        pipeline_mpmd.split_stage_params(fresh(), plan, 1)
    with pytest.raises(ValueError) as want:
        jmpmd.split_stage_params(jparams, jplan, 1)
    assert str(got.value) == str(want.value) and "tie_embeddings" in str(got.value)
    with pytest.raises(ValueError, match="tie_embeddings"):
        rt.init_stage_params(cfg, plan, 1, device="cpu")


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_init_stage_params_is_the_split_of_init(n_stages):
    cfg = llama.LlamaConfig.tiny(n_layers=4, dtype=torch.bfloat16)
    whole = llama.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    plan = pipeline_mpmd.make_stage_plan(4, n_stages, 4)
    for st in range(n_stages):
        got = _flat(rt.init_stage_params(cfg, plan, st, torch.Generator().manual_seed(3),
                                         device="cpu"))
        want = _flat(pipeline_mpmd.split_stage_params(whole, plan, st))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))


# ---------------------------------------------------------------------------
# the boundary wire
# ---------------------------------------------------------------------------

WIRE = {
    "float32": (np.float32, torch.float32),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
    "int32": (np.int32, torch.int32),
}


@pytest.mark.parametrize("name", list(WIRE))
def test_boundary_bytes_equal_jax_both_ways(name):
    np_dtype, t_dtype = WIRE[name]
    rng = np.random.default_rng(5)
    arrays = [np.asarray((rng.standard_normal(shape) * 100).astype(np_dtype))
              for shape in ((2, 16, 8), (3,), ())]
    meta = {"mb": 3, "aux": 0.125, "boot": "abc123"}
    want = jmpmd.encode_boundary(arrays, meta=meta)
    tensors = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
               if name == "bfloat16" else torch.from_numpy(a) for a in arrays]
    assert pipeline_mpmd.encode_boundary(tensors, meta=meta) == want  # from tensors
    assert pipeline_mpmd.encode_boundary(arrays, meta=meta) == want   # from numpy
    assert pipeline_mpmd.encode_boundary(arrays) == jmpmd.encode_boundary(arrays)
    got, got_meta = pipeline_mpmd.decode_boundary(want)  # JAX's bytes, the port's decoder
    assert got_meta == meta
    for a, t in zip(arrays, got):
        assert t.dtype == t_dtype and tuple(t.shape) == a.shape
        assert t.reshape(-1).view(torch.uint8).numpy().tobytes() == a.tobytes()
    back, back_meta = jmpmd.decode_boundary(pipeline_mpmd.encode_boundary(tensors, meta=meta))
    assert back_meta == meta
    for a, b in zip(arrays, back):
        assert b.dtype == a.dtype and b.tobytes() == a.tobytes()


def test_boundary_refusals():
    f, i = np.zeros((2,), np.float32), np.zeros((2,), np.int32)
    with pytest.raises(ValueError) as got:
        pipeline_mpmd.encode_boundary([f, i])
    with pytest.raises(ValueError) as want:
        jmpmd.encode_boundary([f, i])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mixed-dtype"):
        pipeline_mpmd.encode_boundary([torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="empty boundary message"):
        pipeline_mpmd.encode_boundary([])
    good = pipeline_mpmd.encode_boundary([f], meta={"mb": 0})
    with pytest.raises(ValueError, match="bad magic"):
        pipeline_mpmd.decode_boundary(b"kdlrl1" + good[6:])
    with pytest.raises(ValueError, match="bad magic"):
        jmpmd.decode_boundary(b"kdlrl1" + good[6:])
    for broken in (good + b"\0", good[:-1]):
        with pytest.raises(ValueError, match="length mismatch"):
            pipeline_mpmd.decode_boundary(broken)
        with pytest.raises(ValueError):
            jmpmd.decode_boundary(broken)


def test_async_sender_and_prefetcher_over_a_dir_channel(tmp_path):
    ch = pipeline_mpmd.DirChannel(str(tmp_path / "edge"))
    tx = pipeline_mpmd.AsyncSender(ch)
    rx = pipeline_mpmd.Prefetcher(ch, timeout=10)
    rx.expect(["t0", "t1", "t2"])
    for k in range(3):
        tx.send(f"t{k}", pipeline_mpmd.encode_boundary([torch.full((4,), float(k))]))
    tx.flush()
    for k in range(3):
        (x,), _ = pipeline_mpmd.decode_boundary(rx.get(f"t{k}"))
        assert torch.equal(x, torch.full((4,), float(k)))
    assert tx.sent_bytes == rx.recv_bytes > 0
    rx.expect(["t4"])
    tx.send("t4", pipeline_mpmd.encode_boundary([torch.zeros(1)]))
    tx.flush()
    with pytest.raises(RuntimeError, match="out of order: expected 't3', got 't4'"):
        rx.get("t3")
    tx.close()
    rx.close()


# ---------------------------------------------------------------------------
# the in-process MPMD pipeline against JAX's
# ---------------------------------------------------------------------------


# a reference gradient this small lies near Adam's eps (1e-8), where the
# rounding of the stages' f32 sums moves g / (|g| + eps) by a share of 1
SMALL_GRAD = 1e-6


def _both(n_stages, n_micro, seed=0, port_tx=None, jax_tx=None, **kw):
    jcfg, jparams, cfg, fresh = models(seed=seed, **kw)
    jmp = jrt.MPMDPipeline(jcfg, jparams, jax_tx or optax.sgd(0.0), n_stages=n_stages,
                           n_microbatches=n_micro)
    tmp = rt.MPMDPipeline(cfg, fresh(), port_tx or optim.sgd(0.0), n_stages=n_stages,
                          n_microbatches=n_micro)
    return jcfg, jmp, tmp


def _grads_close(jmp, tmp, atol=2e-4, rtol=2e-3):
    for js, ts in zip(jmp.stages, tmp.stages):
        want, got = _flat(jax.device_get(js.last_grads)), _flat(ts.last_grads)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol, err_msg=path)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_mpmd_two_stages_match_jax(moe):
    kw = dict(n_experts=4, expert_top_k=2) if moe else {}
    jcfg, jmp, tmp = _both(2, 4, seed=3 if moe else 0, **kw)
    tokens = tokens_for(jcfg.vocab_size, seed=4 if moe else 1)
    try:
        want, got = jmp.step(tokens), tmp.step(tokens)
        assert abs(got["loss"] - want["loss"]) < 1e-5, (got["loss"], want["loss"])
        # the same messages but for the digits of the aux value in a header
        assert abs(got["serialized_bytes"] - want["serialized_bytes"]) <= 8
        assert got["serialized_bytes"] > 0
        assert got["bubble_frac_analytic"] == want["bubble_frac_analytic"]
        _grads_close(jmp, tmp)
        if moe:  # the router of the stage that is not last gets a gradient
            assert float(tmp.stages[0].last_grads["layers"][0]["moe"]["router"].abs().max()) > 0
    finally:
        jmp.close()
        tmp.close()


def test_mpmd_adamw_three_steps_match_jax():
    jcfg, jmp, tmp = _both(2, 4, port_tx=optim.adamw(1e-3, weight_decay=0.01),
                           jax_tx=optax.adamw(1e-3, weight_decay=0.01))
    tokens = tokens_for(jcfg.vocab_size)
    try:
        losses, small = [], {}
        for _ in range(3):
            want, got = jmp.step(tokens), tmp.step(tokens)
            assert abs(got["loss"] - want["loss"]) < 1e-5
            losses.append(got["loss"])
            # the elements whose reference gradient fell below SMALL_GRAD at
            # some step
            for s, js in enumerate(jmp.stages):
                for path, g in _flat(jax.device_get(js.last_grads)):
                    tiny = np.abs(_np(g)) < SMALL_GRAD
                    small[s, path] = small.get((s, path), False) | tiny
        assert losses[-1] < losses[0]
        for s, (js, ts) in enumerate(zip(jmp.stages, tmp.stages)):
            want, got = _flat(jax.device_get(js.params)), _flat(ts.params)
            for (path, a), (_, b) in zip(got, want):
                diff = np.abs(_np(a) - _np(b))
                # Adam's g / (|g| + 1e-8) turns f32 rounding of a gradient
                # near 1e-8 into a share of lr: only there may an element
                # leave 1e-5, and by no more than 0.05 x lr a step
                off = diff > 1e-5
                assert not (off & ~small[s, path]).any(), (s, path, diff[~small[s, path]].max())
                assert diff.max() <= 0.05 * 1e-3 * 3, (s, path, diff.max())
    finally:
        jmp.close()
        tmp.close()


@pytest.mark.parametrize("n_stages,n_micro", [(1, 4), (2, 2)], ids=["one_stage", "m_eq_s"])
def test_mpmd_degenerate_shapes_match_jax(n_stages, n_micro):
    jcfg, jmp, tmp = _both(n_stages, n_micro)
    tokens = tokens_for(jcfg.vocab_size)
    try:
        want, got = jmp.step(tokens), tmp.step(tokens)
        assert abs(got["loss"] - want["loss"]) < 1e-5
        assert (got["serialized_bytes"] == 0) == (n_stages == 1)
        _grads_close(jmp, tmp)
    finally:
        jmp.close()
        tmp.close()


def test_stale_boundary_message_fails_loud():
    """A message from a dead incarnation (another boot id) on the transport
    raises; it is never consumed as current activations."""
    _, _, cfg, fresh = models()
    mp = rt.MPMDPipeline(cfg, fresh(), optim.sgd(0.0), n_stages=2, n_microbatches=4,
                         recv_timeout=5)
    try:
        stale = pipeline_mpmd.encode_boundary(
            [np.zeros((2, 16, 128), np.float32)],
            meta={"mb": 0, "aux": 0.0, "boot": "dead-incarnation"})
        mp.stages[1]._act_rx._channel.send("a1.0", stale)
        with pytest.raises(RuntimeError, match="incarnation"):
            mp.step(tokens_for(cfg.vocab_size))
    finally:
        mp.close()


def test_a_stop_request_reaches_every_stage_in_the_same_step():
    _, _, cfg, fresh = models()
    mp = rt.MPMDPipeline(cfg, fresh(), optim.sgd(0.0), n_stages=2, n_microbatches=4)
    try:
        tokens = tokens_for(cfg.vocab_size)
        results = [mp.stages[s].run_step for s in range(2)]
        assert not any(r["stop"] for r in _run_stages(results, tokens))
        for asking in (0, 1):
            mp.stages[asking].request_stop = True
            assert all(r["stop"] for r in _run_stages(results, tokens))
            mp.stages[asking].request_stop = False
    finally:
        mp.close()


def _run_stages(fns, tokens):
    import threading

    out = [None] * len(fns)
    threads = [threading.Thread(target=lambda s=s: out.__setitem__(s, fns[s](tokens)))
               for s in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_a_stage_mesh_is_refused():
    _, _, cfg, fresh = models()
    plan = pipeline_mpmd.make_stage_plan(4, 2, 4)
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md, item 12e\)"):
        rt.StageRuntime(0, plan, cfg, pipeline_mpmd.split_stage_params(fresh(), plan, 0),
                        optim.sgd(0.0), mesh=object())
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md, item 12e\)"):
        rt.MPMDPipeline(cfg, fresh(), optim.sgd(0.0), n_stages=2, n_microbatches=4,
                        meshes=[object(), object()])
    with pytest.raises(NotImplementedError, match="one process a device"):
        rt.runtime_from_env(cfg, fresh(), optim.sgd(0.0), mesh=object(), env={})


def test_sgd_matches_optax():
    rng = np.random.default_rng(0)
    p, g = rng.standard_normal((3, 5)).astype(np.float32), rng.standard_normal((3, 5)).astype(
        np.float32)
    upd, _ = optax.sgd(0.1).update(jnp.asarray(g), optax.sgd(0.1).init(jnp.asarray(p)))
    tp = torch.from_numpy(p.copy())
    tx = optim.sgd(0.1)
    tx.apply([tp], [torch.from_numpy(g)], tx.init([tp]))
    np.testing.assert_allclose(tp.numpy(), p + np.asarray(upd), rtol=0, atol=1e-7)
