"""The one-card workload programs of the port (kubedl_tpu_torch/train/
{vision,sparse,mnist}.py) and their optimizers against the JAX package.

* `optim.adam` and `optim.adagrad`: three updates within 1e-6 of optax's
  (a row of zero gradients in the Adagrad case stays where it is);
* sparse: the batch's ids and labels equal the reference's draws bit for
  bit, and 3 steps from the reference's initial parameters (converted)
  give its losses within 1e-5 relative. The reference side is built from
  kubedl_tpu.models.embedding and optax as kubedl_tpu/train/sparse.py
  builds it inside its main;
* MNIST: the same for kubedl_tpu/train/mnist.py's MLP and Adam;
* each program's main at tiny flags on the CPU prints the reference's line;
  vision, sparse and MNIST train as a gloo gang of 2 processes (MNIST's
  losses against the reference's MLP on the global batch its two processes
  assemble); without a card every entry point raises unless given
  --device cpu;
* the rendezvous smoke (train/smoke_distributed.py) as a gang of 2, and
  its count check."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubedl_tpu.models.embedding import FeatureSpec as JFeatureSpec, init_tables, lookup_features
from kubedl_tpu.parallel.mesh import build_mesh
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.parallel.train_step import make_train_step
from kubedl_tpu_torch.train import mnist, sparse, vision
from kubedl_tpu_torch.utils.convert import params_from_numpy

# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------


def _three_updates(jtx, ttx, zero_row=False):
    rng = np.random.default_rng(0)
    params = [rng.standard_normal((6, 5)).astype(np.float32),
              rng.standard_normal((7,)).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    if zero_row:
        for g in grads:
            g[0][2] = 0.0
    jparams = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jparams)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = ttx.init(tparams)
    for g in grads:
        upd, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        ttx.apply(tparams, [torch.from_numpy(x) for x in g], tstate)
    return params, jparams, tparams


@pytest.mark.parametrize("name", ["adam", "adagrad"])
def test_three_updates_match_optax(name):
    lr = {"adam": 1e-3, "adagrad": 1e-2}[name]
    jtx = getattr(optax, name)(lr)
    ttx = getattr(optim, name)(lr)
    start, want, got = _three_updates(jtx, ttx, zero_row=name == "adagrad")
    for s, a, b in zip(start, want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
        assert not np.array_equal(b.numpy(), s)
    if name == "adagrad":  # a zero gradient moves nothing
        np.testing.assert_array_equal(got[0][2].numpy(), start[0][2])


# ---------------------------------------------------------------------------
# sparse: the reference built as kubedl_tpu/train/sparse.py builds it
# ---------------------------------------------------------------------------

SPARSE_SCALE, SPARSE_BATCH, SPARSE_HIDDEN, SPARSE_LR = 1000, 64, 32, 1e-2


def _reference_sparse_batch(features, local_batch):
    """kubedl_tpu/train/sparse.py's draws, line for line (one process)."""
    rng = np.random.default_rng(0)
    batch_ids = {}
    for f in features:
        ids = rng.integers(0, f.vocab_size, (local_batch, f.multi_hot), dtype=np.int32)
        if f.multi_hot > 1:
            pad = rng.random((local_batch, f.multi_hot)) < 0.3
            pad[:, 0] = False
            ids[pad] = -1
        batch_ids[f.name] = ids
    labels = rng.integers(0, 2, (local_batch,)).astype(np.float32)
    return batch_ids, labels


def _reference_sparse(features, batch_ids, labels, steps):
    """kubedl_tpu/train/sparse.py's model, loss and Adagrad step on a
    one-device mesh: (initial params as numpy, the losses of `steps`)."""
    mesh = build_mesh({"tensor": 1}, devices=jax.devices()[:1])
    emb_dim = sum(f.dim for f in features)
    k_emb, k_wide, k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 5)
    wide_feats = tuple(JFeatureSpec(f.name, f.vocab_size, 1, f.multi_hot, "sum")
                       for f in features)
    params = {
        "tables": init_tables(k_emb, features, 1),
        "wide": {n + "/wide": t for n, t in init_tables(k_wide, wide_feats, 1).items()},
        "dense": {"w1": jax.random.normal(k1, (emb_dim, SPARSE_HIDDEN), jnp.float32) * 0.02,
                  "b1": jnp.zeros((SPARSE_HIDDEN,)),
                  "w2": jax.random.normal(k2, (SPARSE_HIDDEN, 1), jnp.float32) * 0.02,
                  "b2": jnp.zeros((1,))},
    }
    tx = optax.adagrad(SPARSE_LR)

    def forward(params, batch_ids):
        deep = lookup_features(params["tables"], batch_ids, features, mesh)
        wide_in = {k.replace("/wide", ""): v for k, v in params["wide"].items()}
        wide_logit = lookup_features(wide_in, batch_ids, wide_feats, mesh).sum(-1)
        h = jnp.maximum(
            deep.astype(jnp.bfloat16) @ params["dense"]["w1"].astype(jnp.bfloat16)
            + params["dense"]["b1"].astype(jnp.bfloat16), 0)
        logit = (h @ params["dense"]["w2"].astype(jnp.bfloat16)
                 + params["dense"]["b2"].astype(jnp.bfloat16))
        return logit.astype(jnp.float32).squeeze(-1) + wide_logit

    def loss_fn(params, batch_ids, labels):
        return optax.sigmoid_binary_cross_entropy(forward(params, batch_ids), labels).mean()

    @jax.jit
    def train_step(params, opt_state, batch_ids, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch_ids, labels)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    start = jax.device_get(params)
    opt_state = tx.init(params)
    ids = {k: jnp.asarray(v) for k, v in batch_ids.items()}
    losses = []
    for _ in range(steps):
        params, opt_state, loss = train_step(params, opt_state, ids, jnp.asarray(labels))
        losses.append(float(loss))
    return start, losses


def test_sparse_batch_equals_the_reference_draws():
    features = sparse.features_for(SPARSE_SCALE)
    assert [(f.name, f.vocab_size, f.dim, f.multi_hot, f.combiner) for f in features] == [
        (n, v // SPARSE_SCALE, d, m, c) for n, v, d, m, c in sparse.FEATURE_DEFS]
    want_ids, want_labels = _reference_sparse_batch(features, SPARSE_BATCH)
    got_ids, got_labels = sparse.draw_batch(np.random.default_rng(0), features, SPARSE_BATCH)
    assert list(got_ids) == list(want_ids)
    for k in want_ids:
        assert got_ids[k].dtype == np.int32
        np.testing.assert_array_equal(got_ids[k], want_ids[k])
    assert (got_ids["behavior_seq"] == -1).any() and (got_ids["behavior_seq"][:, 0] >= 0).all()
    np.testing.assert_array_equal(got_labels, want_labels)


def test_sparse_three_steps_match_the_reference_losses():
    features = sparse.features_for(SPARSE_SCALE)
    batch_ids, labels = sparse.draw_batch(np.random.default_rng(0), features, SPARSE_BATCH)
    jfeatures = tuple(JFeatureSpec(f.name, f.vocab_size, f.dim, f.multi_hot, f.combiner)
                      for f in features)
    start, want = _reference_sparse(jfeatures, batch_ids, labels, 3)
    init_state, train_step = sparse.make_step(features, SPARSE_LR)
    state = init_state(params_from_numpy(start))
    batch = ({k: torch.from_numpy(v) for k, v in batch_ids.items()}, torch.from_numpy(labels))
    got = []
    for _ in range(3):
        state, m = train_step(state, batch)
        got.append(m["loss"].item())
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b), (got, want)
    assert got[2] < got[0]


# ---------------------------------------------------------------------------
# MNIST: the reference built as kubedl_tpu/train/mnist.py builds it
# ---------------------------------------------------------------------------


def test_mnist_three_steps_match_the_reference_losses():
    hidden, lr, batch, k = 32, 1e-3, 16, 3
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"w1": jax.random.normal(k1, (784, hidden), jnp.float32) * 0.02,
              "b1": jnp.zeros((hidden,), jnp.float32),
              "w2": jax.random.normal(k2, (hidden, 10), jnp.float32) * 0.02,
              "b2": jnp.zeros((10,), jnp.float32)}
    tx = optax.adam(lr)

    def loss_fn(params, x, y):
        h = jnp.maximum(x.astype(jnp.bfloat16) @ params["w1"].astype(jnp.bfloat16)
                        + params["b1"].astype(jnp.bfloat16), 0)
        logits = (h @ params["w2"].astype(jnp.bfloat16) + params["b2"].astype(jnp.bfloat16))
        logits = logits.astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    xs, ys = mnist.draw_batches(np.random.default_rng(0), k, batch)
    rng = np.random.default_rng(0)  # the reference's draws, in its order
    np.testing.assert_array_equal(xs, rng.standard_normal((k, batch, 784), dtype=np.float32))
    np.testing.assert_array_equal(ys, rng.integers(0, 10, (k, batch), dtype=np.int32))
    init_state, train_step = make_train_step(mnist.loss_fn, optim.adam(lr))
    state = init_state(params_from_numpy(jax.device_get(params)))
    opt_state = tx.init(params)
    for i in range(k):
        params, opt_state, want = step(params, opt_state, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        state, m = train_step(state, (torch.from_numpy(xs[i]), torch.from_numpy(ys[i])))
        assert abs(m["loss"].item() - float(want)) <= 1e-5 * abs(float(want)), i


def test_mnist_steps_per_call_is_clamped_to_a_divisor():
    assert [mnist.steps_per_call(s, 25) for s in (200, 10, 7, 30, 1)] == [25, 10, 7, 15, 1]


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

PROGRAMS = {
    "vision": (vision, ["--model", "tiny", "--steps", "2", "--batch", "4"],
               ("steps=2 batch=4 loss=", " step/sec=", " img/sec=", " params=80256 devices=1")),
    "sparse": (sparse, ["--steps", "2", "--batch", "32", "--hidden", "16",
                        "--vocab-scale", "1000"],
               ("steps=2 batch=32 loss=", " step/sec=", " lookups/sec=",
                " table_shards=1 devices=1")),
    "mnist": (mnist, ["--steps", "4", "--batch", "16", "--hidden", "16",
                      "--steps-per-call", "3"],
              ("steps=4 batch=16 loss=", " step/sec=", " devices=1")),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_runs_on_the_cpu_and_prints_its_line(name, capsys, monkeypatch):
    for env in ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES", "KUBEDL_MESH"):
        monkeypatch.delenv(env, raising=False)
    module, argv, parts = PROGRAMS[name]
    assert module.main(argv + ["--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    pos = 0
    for part in parts:
        pos = line.index(part, pos)  # in this order
    assert np.isfinite(float(line.split("loss=")[1].split()[0]))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_needs_the_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, argv, _ = PROGRAMS[name]
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)


def test_mnist_refuses_a_multi_process_job(capsys, monkeypatch):
    """KUBEDL_NUM_PROCESSES=2 once exited 2 here (unported). Now it is a
    gang's setting: without a coordinator address the process joins no
    group and trains alone, as the reference's does without one, and exits
    0 (test_mnist_trains_as_a_gang_of_2 runs the gang)."""
    monkeypatch.setenv("KUBEDL_NUM_PROCESSES", "2")
    monkeypatch.delenv("KUBEDL_COORDINATOR_ADDRESS", raising=False)
    assert mnist.main(["--device", "cpu", "--steps", "2", "--batch", "8", "--hidden", "8"]) == 0
    assert capsys.readouterr().out.strip().endswith("devices=1")


def _run_ranks(module, argv, world, extra_env):
    """`python -m module argv --device cpu` as `world` gloo processes of
    one gang; (return codes, rank 0's output)."""
    import os
    import subprocess
    import sys

    from torch_gang import ROOT, free_port

    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--device", "cpu"], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT, **extra_env,
                 KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                 KUBEDL_NUM_PROCESSES=str(world), KUBEDL_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], outs


@pytest.mark.parametrize("name,argv,env,want", [
    ("vision", ["--model", "tiny", "--steps", "2", "--batch", "8"], {"KUBEDL_MESH": "data=2"},
     "steps=2 batch=8 loss="),
    ("sparse", ["--steps", "2", "--batch", "32", "--hidden", "16", "--vocab-scale", "997"], {},
     " table_shards=2 devices=2"),
])
def test_program_trains_as_a_gang(name, argv, env, want):
    """vision on data=2 and sparse in its default layout (every process on
    the table axis; at scale 997 two vocabularies have 501 rows, odd over
    2, so the tables are padded): both ranks exit 0, rank 0 prints."""
    rcs, outs = _run_ranks(f"kubedl_tpu_torch.train.{name}", argv, 2, env)
    assert rcs == [0, 0], outs
    assert want in outs[0] and "loss=" not in outs[1], outs


# MNIST's gang: main in each process, its losses written beside its line
_MNIST_RANK = """
import json, sys
from kubedl_tpu_torch.train import mnist
run = mnist.run
def keep(*a, **kw):
    out = run(*a, **kw)
    with open(sys.argv[1], "w") as f:
        json.dump(out["losses"], f)
    return out
mnist.run = keep
sys.exit(mnist.main(sys.argv[2:]))
"""


def test_mnist_trains_as_a_gang_of_2(tmp_path):
    """`mnist.main` as two gloo processes (each through its whole main, the
    rendezvous included): both exit 0 and print devices=2 and the global
    batch; every step's loss matches the reference's MLP and Adam, built
    as test_mnist_three_steps_match_the_reference_losses builds them, on
    the global batch the reference assembles: rows 0-7 of process 0's draw
    from default_rng(0), rows 8-15 of process 1's from default_rng(1). The
    gang's loss is the mean of the two ranks' means and each gradient the
    mean over the gang, a different order of sums than one batch's: the
    bound is 1e-4 relative (one process holds 1e-5)."""
    import os
    import subprocess
    import sys

    from torch_gang import ROOT, free_port

    hidden, lr, batch, k, steps = 32, 1e-3, 17, 3, 6  # 17 rounds to 16 over 2 devices
    port = free_port()
    outs = [tmp_path / f"losses{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MNIST_RANK, str(outs[r]), "--device", "cpu", "--steps",
         str(steps), "--batch", str(batch), "--hidden", str(hidden), "--lr", str(lr),
         "--steps-per-call", str(k)], cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT,
                 KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", KUBEDL_NUM_PROCESSES="2",
                 KUBEDL_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        texts = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], texts
    for text in texts:
        assert f"steps={steps} batch=16 loss=" in text and text.strip().endswith("devices=2")
    import json

    got = [json.loads(o.read_text()) for o in outs]
    assert got[0] == got[1]  # every rank reads the same global loss

    rows = [mnist.draw_batches(np.random.default_rng(r), k, 16) for r in range(2)]
    xs = np.concatenate([rows[0][0][:, :8], rows[1][0][:, 8:]], axis=1)
    ys = np.concatenate([rows[0][1][:, :8], rows[1][1][:, 8:]], axis=1)
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"w1": jax.random.normal(k1, (784, hidden), jnp.float32) * 0.02,
              "b1": jnp.zeros((hidden,), jnp.float32),
              "w2": jax.random.normal(k2, (hidden, 10), jnp.float32) * 0.02,
              "b2": jnp.zeros((10,), jnp.float32)}
    tx = optax.adam(lr)

    def loss_fn(params, x, y):
        h = jnp.maximum(x.astype(jnp.bfloat16) @ params["w1"].astype(jnp.bfloat16)
                        + params["b1"].astype(jnp.bfloat16), 0)
        logits = (h @ params["w2"].astype(jnp.bfloat16) + params["b2"].astype(jnp.bfloat16))
        logits = logits.astype(jnp.float32)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    # the port's init equals the reference's only in distribution: start the
    # reference from the port's parameters (seed 0), as main draws them
    params = jax.tree_util.tree_map(
        jnp.asarray, {n: t.numpy() for n, t in mnist.init_params(hidden, device="cpu").items()})
    opt_state = tx.init(params)
    want = []
    for i in range(steps + k):  # the warm-up call's k steps, then the timed ones
        params, opt_state, loss = step(params, opt_state, jnp.asarray(xs[i % k]),
                                       jnp.asarray(ys[i % k]))
        want.append(float(loss))
    assert len(got[0]) == len(want)
    for a, b in zip(got[0], want):
        assert abs(a - b) <= 1e-4 * abs(b), (got[0], want)


def test_the_rendezvous_smoke_as_a_gang_of_2():
    """`python -m kubedl_tpu_torch.train.smoke_distributed` as two gloo
    processes: both exit 0 with the reference's line, psum over both."""
    rcs, outs = _run_ranks("kubedl_tpu_torch.train.smoke_distributed", [], 2, {})
    assert rcs == [0, 0], outs
    assert "distributed ok: process 0/2 devices 1 local / 2 global, psum=2.0" in outs[0]


def test_the_rendezvous_count_check_exits_1(capsys):
    """The count check with a global count that is not local x processes
    (a wrong KUBEDL_NUM_PROCESSES would hang the rendezvous instead): the
    reference's message and exit 1. Alone, without an address, a process
    told it is one of two sees one device and exits 1 the same way."""
    from kubedl_tpu_torch.train import smoke_distributed

    assert smoke_distributed.count_error(2, 1, 2) is None
    assert smoke_distributed.count_error(3, 1, 2) == "global devices 3 != local 1 x 2 processes"
    import os

    env = {k: v for k, v in os.environ.items() if k != "KUBEDL_COORDINATOR_ADDRESS"}
    old = dict(os.environ)
    try:
        os.environ.clear()
        os.environ.update(env, KUBEDL_NUM_PROCESSES="2")
        assert smoke_distributed.main(["--device", "cpu"]) == 1
    finally:
        os.environ.clear()
        os.environ.update(old)
    assert "global devices 1 != local 1 x 2 processes" in capsys.readouterr().err
