"""The live reshard of a training state and of the trainer on the CPU
(gloo, LlamaConfig.tiny, f32).

The state: one gang of 4 (tests/torch_gang.py, kind "reshard") takes an
AdamW step on data2·fsdp2 (dense) and on data2·expert2 (MoE); its
`leaves_from_state` equals the JAX package's for the JAX state on the same
mesh (shapes, itemsizes and the specs' live axes, path by path under
JAX_PATH below); every rank stages its blocks for 2 chips; the dense state
moves onto fsdp4 over the same ranks with `reshard_state`, byte for byte,
and steps there; `live_resize` to 4 chips keeps every state on its mesh,
nothing moved. A gang of 2 then restores each staging through
`restore_staged` and `state_from_staging`: its gathered state equals the
staged one bit for bit, and so does `state_digest`.

The trainer (`python -m kubedl_tpu_torch.train.trainer --device cpu
--model tiny`, KUBEDL_LIVE_RESHARD=1, a control dir a process): a gang of
2 whose ranks receive RESIZE chips 1 at different steps acts at one step,
replies "staged" on both and exits 113, and one process resumes from the
staging with the same state sha256 and runs to its end; 1 -> 2 the same
way; a RESIZE that keeps the chip count replies "ok" in the reference's
keys, an unknown message "failed"; chips 0 and KUBEDL_RESHARD_TEST_FAIL
fall back closed (a final checkpoint, reply "fallback", exit 113); a
staging with a block missing falls back to the checkpoint, and so does a
fault that only one rank of a gang sees, on every rank; pipeline stages
with live reshard exit 2 with the reference's message."""
import dataclasses
import json
import os
import subprocess
import sys
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kubedl_tpu.models import llama as jllama
from kubedl_tpu.parallel.mesh import ShardingRules, build_mesh
from kubedl_tpu.parallel.reshard import leaves_from_state as jax_leaves_from_state
from kubedl_tpu.parallel.train_step import make_train_step as jax_make_train_step
from kubedl_tpu_torch.train import checkpoint, trainer
from torch_gang import free_port, run_gang

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
ROWS, SEQ = 8, 17
CASES = {
    "dense": dict(ici={"data": 2, "fsdp": 2}, cfg={}, move_to={"fsdp": 4},
                  new_ici={"fsdp": 2}),
    "moe": dict(ici={"data": 2, "expert": 2}, cfg=dict(n_experts=2, moe_dropless=False),
                new_ici={"expert": 2}),
}


def JAX_PATH(port_path: str) -> str:
    """The JAX state's key string of a port leaf: TrainState flattens to
    (params, opt_state, step), and optax.adamw's state is a chain whose
    first element holds count, mu and nu."""
    if port_path == ".step":
        return "[<flat index 2>]"
    if port_path.startswith(".params"):
        return "[<flat index 0>]" + port_path[len(".params"):]
    for slot in ("mu", "nu"):
        head = f".opt_state['{slot}']"
        if port_path.startswith(head):
            return f"[<flat index 1>][0].{slot}" + port_path[len(head):]
    assert port_path == ".opt_state['count']", port_path
    return "[<flat index 1>][0].count"


def _live(spec, ndim, axes):
    """A spec's mesh axes of size above 1, dim by dim."""
    dims = [() if p is None else (p,) if isinstance(p, str) else tuple(p) for p in spec]
    dims += [()] * (ndim - len(dims))
    return [tuple(a for a in d if axes.get(a, 1) > 1) for d in dims]


def _jax_leaves(jcfg, jparams, ici, batch):
    """The reference's leaves_from_state after one AdamW step on the mesh."""
    rules = ShardingRules()
    n = int(np.prod(list(ici.values())))
    mesh = build_mesh(ici, devices=jax.devices()[:n])

    def loss(p, b):
        return jllama.loss_fn(p, b, jcfg, mesh=mesh, rules=rules)

    jinit, jstep = jax_make_train_step(loss, optax.adamw(LR, weight_decay=0.01), mesh,
                                       jllama.param_specs(jcfg, rules),
                                       rules.spec("batch", None), rules)
    state, _ = jstep(jinit(jparams), jnp.asarray(batch))
    return {k: (tuple(shape), item, tuple(spec))
            for k, (shape, item, spec) in jax_leaves_from_state(state).items()}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    cases, jax_parts = [], {}
    for i, (name, spec) in enumerate(CASES.items()):
        jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, use_flash=False, **spec["cfg"])
        jparams = jllama.init(jcfg, jax.random.PRNGKey(i))
        batch = np.random.default_rng(i).integers(0, jcfg.vocab_size, (ROWS, SEQ)).astype(
            np.int32)
        fields = dataclasses.asdict(jcfg)
        fields.update(dtype="float32", use_flash=True)
        params = jax.device_get(jparams)
        cases.append(dict(kind="reshard", name=name, ici=spec["ici"], config=fields,
                          params=params, batch=batch, lr=LR, move_to=spec.get("move_to"),
                          stage=dict(dir=str(tmp / f"staging-{name}"), chips=2)))
        jax_parts[name] = (jcfg, jparams, spec["ici"], batch)
    before, want = run_gang(cases, 4, tmp_path_factory.mktemp("four"), meanwhile=lambda: {
        n: _jax_leaves(*parts) for n, parts in jax_parts.items()})
    restore = [dict(c, name=c["name"], ici=CASES[c["name"]]["new_ici"], move_to=None,
                    stage=None, restore=c["stage"]["dir"]) for c in cases]
    after, _ = run_gang(restore, 2, tmp_path_factory.mktemp("two"))
    return before, after, want


@pytest.mark.parametrize("name", list(CASES))
def test_leaves_match_the_reference(gangs, name):
    before, _, want = gangs
    got = before[name]["leaves"]
    assert sorted(JAX_PATH(p) for p in got) == sorted(want[name])
    axes = before[name]["mesh"]
    for path, (shape, item, spec) in got.items():
        wshape, witem, wspec = want[name][JAX_PATH(path)]
        assert (shape, item) == (wshape, witem), path
        assert _live(spec, len(shape), axes) == _live(wspec, len(shape), axes), path
    # the optimizer's slots carry their parameter's spec
    for path, leaf in got.items():
        if path.startswith(".opt_state['mu']"):
            assert leaf[2] == got[".params" + path[len(".opt_state['mu']"):]][2]


@pytest.mark.parametrize("name", list(CASES))
def test_staged_state_restores_bit_for_bit(gangs, name):
    before, after, _ = gangs
    b, a = before[name], after[name]
    assert a["mesh"] == {k: CASES[name]["new_ici"].get(k, 1) for k in a["mesh"]}
    assert a["step"] == 1 and set(a["state"]) == set(b["state"])
    for path, want in b["state"].items():
        got = a["state"][path]
        if isinstance(want, int):
            assert got == want, path
        else:
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), path
    assert a["digest"] == b["digest"]
    plan = b["plan"]
    assert plan["moved"] + plan["local"] > 0 and len(plan["digest"]) == 64


def _same_state(got, want):
    assert set(got) == set(want)
    for path, w in want.items():
        assert (got[path] == w) if isinstance(w, int) else got[path].tobytes() == w.tobytes(), \
            path


@pytest.mark.parametrize("name", list(CASES))
def test_live_resize_keeps_the_state_at_the_same_chip_count(gangs, name):
    before, _, _ = gangs
    b = before[name]
    assert b["live_mesh"] == b["mesh"] and b["live_moved"] == 0
    _same_state(b["live_state"], b["state"])


def test_reshard_state_moves_the_state_byte_for_byte(gangs):
    before, _, _ = gangs
    d = before["dense"]
    assert d["moved_mesh"]["fsdp"] == 4 and d["moved_mesh"]["data"] == 1
    _same_state(d["moved_state"], d["state"])
    assert np.isfinite(d["moved_loss"])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TINY = ["-m", "kubedl_tpu_torch.train.trainer", "--device", "cpu", "--model", "tiny",
        "--batch", "2", "--seq-len", "17", "--log-every", "1"]


def _env(tmp_path, ctl, **extra):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", KUBEDL_LIVE_RESHARD="1", KUBEDL_RESHARD_TEST_DIGEST="1",
               KUBEDL_RESHARD_DIR=str(tmp_path / "staging"), KUBEDL_CONTROL_DIR=str(ctl))
    for k in ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES", "KUBEDL_PROCESS_ID",
              "KUBEDL_MESH", "KUBEDL_DCN_MESH", "KUBEDL_CHECKPOINT_PATH"):
        env.pop(k, None)
    env.update(extra)
    return env


def _ctl(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return d


def _post(ctl, msg, n=1):
    tmp = ctl / f".msg-{n:04d}.tmp"
    tmp.write_text(json.dumps(msg))
    os.replace(tmp, ctl / f"msg-{n:04d}.json")


def _reply(ctl, n=1):
    return json.loads((ctl / f"reply-{n:04d}.json").read_text())


def _start(env, steps, *extra):
    return subprocess.Popen([sys.executable] + TINY + ["--steps", str(steps)] + list(extra),
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _gang(tmp_path, ctls, steps, **extra):
    port = free_port()
    return [_start(_env(tmp_path, c, KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                        KUBEDL_NUM_PROCESSES=str(len(ctls)), KUBEDL_PROCESS_ID=str(r),
                        **extra), steps) for r, c in enumerate(ctls)]


def _finish(procs, timeout=120):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def _digest(out, what):
    """(step, sha256) of the trainer's "state sha256 <what>" line."""
    line = [x for x in out.splitlines() if f"live reshard: state sha256 {what} at step" in x]
    assert len(line) == 1, out[-3000:]
    words = line[0].replace(":", "").split()
    return int(words[-2]), words[-1]


def _wait_line(proc, text, timeout=60):
    """Read proc's output until a line holds `text`; returns what was read."""
    seen = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        if text in line:
            return "".join(seen)
    raise AssertionError(f"no {text!r} in:\n{''.join(seen)[-3000:]}")


def test_gang_shrinks_two_to_one_at_one_agreed_step(tmp_path, monkeypatch, capsys):
    """Rank 0 holds its RESIZE from the first step; rank 1's arrives after
    step 3 is logged. The gang acts at one step, later than rank 0's
    message: both reply "staged" at it and exit 113, and one process
    resumes from the staging with the same state and runs to its end."""
    c0, c1 = _ctl(tmp_path, "ctl0"), _ctl(tmp_path, "ctl1")
    _post(c0, {"type": "RESIZE", "chips": 1})
    procs = _gang(tmp_path, [c0, c1], 400)
    head = _wait_line(procs[0], "step 3: loss=")
    _post(c1, {"type": "RESIZE", "chips": 1})
    rcs, outs = _finish(procs)
    outs[0] = head + outs[0]
    assert rcs == [113, 113], outs
    r0, r1 = _reply(c0), _reply(c1)
    assert r0 == r1 and r0["outcome"] == "staged" and r0["step"] > 3, (r0, r1)
    at, sha = _digest(outs[0], "staged")
    assert at == r0["step"]
    assert f"staged reshard at step {at}: restarting onto the new topology" in outs[0]
    manifest = json.loads((tmp_path / "staging" / "manifest.json").read_text())
    assert (manifest["old_pods"], manifest["new_pods"], manifest["step"]) == (2, 1, at)
    assert manifest["new_axes"]["data"] == 1
    # one process comes back (in this process: it runs to its end)
    for k, v in _env(tmp_path, _ctl(tmp_path, "ctl")).items():
        monkeypatch.setenv(k, v)
    for k in ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES", "KUBEDL_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert trainer.main(TINY[2:] + ["--steps", str(at + 2)]) == 0
    out = capsys.readouterr().out
    assert f"restored live-reshard staging at step {at} (mesh " in out
    assert _digest(out, "restored") == (at, sha)
    assert f"step {at + 2}: loss=" in out and "done: 2 steps" in out


def test_one_process_grows_to_two(tmp_path):
    """A one-process trainer asked for 2 chips stages for them and exits
    113; a gang of 2 resumes from the staging with the same state."""
    ctl = _ctl(tmp_path, "ctl")
    _post(ctl, {"type": "RESIZE", "chips": 2, "slice": "v5e-2"})
    rcs, outs = _finish([_start(_env(tmp_path, ctl), 50)])
    assert rcs == [113], outs
    assert _reply(ctl) == {"outcome": "staged", "step": 1}
    at, sha = _digest(outs[0], "staged")
    procs = _gang(tmp_path, [_ctl(tmp_path, "ctl0"), _ctl(tmp_path, "ctl1")], 3)
    rcs, outs = _finish(procs)
    assert rcs == [0, 0], outs
    assert "restored live-reshard staging at step 1 (mesh {'data': 2, " in outs[0]
    assert _digest(outs[0], "restored") == (at, sha)
    assert "mesh: {'data': 2, 'fsdp': 1" in outs[0] and "done: 2 steps" in outs[0]


def test_same_chip_count_is_live_and_unknown_messages_fail(tmp_path, monkeypatch, capsys):
    ctl = _ctl(tmp_path, "ctl")
    _post(ctl, {"type": "PING"}, n=1)
    _post(ctl, {"type": "RESIZE", "chips": 1}, n=2)
    for k, v in _env(tmp_path, ctl).items():
        monkeypatch.setenv(k, v)
    assert trainer.main(TINY[2:] + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert _reply(ctl, 1) == {"outcome": "failed", "error": "unknown control message 'PING'"}
    r = _reply(ctl, 2)
    assert sorted(r) == ["chips", "downtime_s", "moved_mb", "outcome", "step"]
    assert (r["outcome"], r["step"], r["chips"], r["moved_mb"]) == ("ok", 2, 1, 0.0)
    assert "live reshard at step 2: mesh -> {} (1 devices, downtime " in out
    assert "live reshard: resumed at step 3" in out and "done: 4 steps" in out


FALLBACKS = {
    "chips_0": ({"type": "RESIZE", "chips": 0}, {}, "bad chip count 0"),
    "test_fail": ({"type": "RESIZE", "chips": 1}, {"KUBEDL_RESHARD_TEST_FAIL": "1"},
                  "KUBEDL_RESHARD_TEST_FAIL injected failure"),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_failures_fall_back_closed_with_a_final_checkpoint(tmp_path, name):
    msg, extra, reason = FALLBACKS[name]
    ctl = _ctl(tmp_path, "ctl")
    _post(ctl, msg)
    ckpt = tmp_path / "ckpt"
    rcs, outs = _finish([_start(_env(tmp_path, ctl, **extra), 50,
                                "--checkpoint-path", str(ckpt))])
    assert rcs == [113], outs
    assert _reply(ctl) == {"outcome": "fallback", "step": 1, "error": reason}
    assert f"live reshard failed ({reason}); falling back to checkpoint restore" in outs[0]
    assert "saved final checkpoint at step 1" in outs[0]
    assert checkpoint.latest_step(str(ckpt)) == 1
    assert not (tmp_path / "staging" / "manifest.json").exists()


def test_corrupt_staging_falls_back_to_the_checkpoint(tmp_path, monkeypatch):
    """A published staging with one npz member removed: restore_staged
    validates it, state_from_staging finds a leaf's coverage short, and the
    trainer restores the checkpoint instead (the staging cleared)."""
    ctl = _ctl(tmp_path, "ctl")
    ckpt = tmp_path / "ckpt"
    for k, v in _env(tmp_path, ctl).items():
        monkeypatch.setenv(k, v)
    assert trainer.main(TINY[2:] + ["--steps", "1", "--checkpoint-path", str(ckpt)]) == 0
    assert checkpoint.latest_step(str(ckpt)) == 1
    _post(ctl, {"type": "RESIZE", "chips": 2})
    rcs, outs = _finish([_start(_env(tmp_path, ctl), 50, "--checkpoint-path", str(ckpt))])
    assert rcs == [113] and _reply(ctl) == {"outcome": "staged", "step": 2}, outs
    # a 2-process staging replayed by 2 processes, one block short
    npz = tmp_path / "staging" / "src-0.npz"
    with zipfile.ZipFile(npz) as z:
        members = {n: z.read(n) for n in z.namelist()}
    drop = next(n for n in sorted(members) if "wq" in n)
    with zipfile.ZipFile(npz, "w") as z:
        for n, blob in members.items():
            if n != drop:
                z.writestr(n, blob)
    procs = _gang(tmp_path, [_ctl(tmp_path, "ctl0"), _ctl(tmp_path, "ctl1")], 3,
                  KUBEDL_CHECKPOINT_PATH=str(ckpt))
    rcs, outs = _finish(procs)
    assert rcs == [0, 0], outs
    assert "staging unusable (coverage violation assembling " in outs[0]
    assert "elements missing, 0 delivered more than once)" in outs[0]
    assert "falling back to checkpoint restore" in outs[0]
    assert "restored checkpoint at step 1" in outs[0]
    assert "restored live-reshard staging" not in outs[0]
    assert not (tmp_path / "staging" / "manifest.json").exists()


def _fsdp2_staging(d):
    """A staging for 2 pods on {"fsdp": 2} of the trainer's tiny state after
    one step, from one process: pod 1 reads the other half of every leaf
    that fsdp shards, so a fault there is one that only rank 1 sees."""
    import torch

    from kubedl_tpu_torch.models import llama as tllama
    from kubedl_tpu_torch.parallel import optim
    from kubedl_tpu_torch.parallel.mesh import AXIS_ORDER
    from kubedl_tpu_torch.parallel.mesh import ShardingRules as TRules
    from kubedl_tpu_torch.parallel.train_step import make_train_step
    from kubedl_tpu_torch.train import reshard_runtime as rt

    cfg, rules = tllama.LlamaConfig.config_for("tiny"), TRules()
    specs = tllama.param_specs(cfg, rules)
    init_state, step = make_train_step(lambda p, b: tllama.loss_fn(p, b, cfg),
                                       optim.adamw(3e-4, weight_decay=0.01))
    state = init_state(tllama.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    batch = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17), dtype=np.int32)
    state, _ = step(state, torch.from_numpy(batch))
    old = rt.mesh_axes(None)
    plan = rt.plan_reshard(rt.leaves_from_state(state, specs), old,
                           {k: 2 if k == "fsdp" else 1 for k in AXIS_ORDER}, 1, 2)
    rt.stage_shards(str(d), plan, 0, rt.provider_from_blocks(rt.addressable_blocks(state, specs)),
                    1)
    assert rt.write_manifest(str(d), plan, 1, 1, timeout=10)


def _drop_member(npz, pick):
    with zipfile.ZipFile(npz) as z:
        members = {n: z.read(n) for n in z.namelist()}
    drop = next(n for n in sorted(members) if pick(n))
    with zipfile.ZipFile(npz, "w") as z:
        for n, blob in members.items():
            if n != drop:
                z.writestr(n, blob)


def _rank1_only(name):
    """An npz member of wq's upper half along some dim: pod 1's part."""
    path, rect, _ = json.loads(name[:-len(".npy")] if name.endswith(".npy") else name)
    return "wq" in path and any(a > 0 for a, _ in rect)


@pytest.mark.parametrize("fault", ["member", "marker"])
def test_a_fault_one_rank_sees_falls_back_on_every_rank(tmp_path, monkeypatch, fault):
    """A staging fault that only rank 1 sees drops the staging on both
    ranks: "member" removes a block of wq that only rank 1 assembles (its
    coverage fails after both ranks built the fsdp2 mesh); "marker" hands
    rank 1 a copy of the staging whose marker digest differs, so it reads
    no staging before the rendezvous while rank 0 reads a valid one. Both
    ranks then restore the checkpoint from a fresh init and train to their
    end."""
    ckpt = tmp_path / "ckpt"
    for k, v in _env(tmp_path, _ctl(tmp_path, "ctl")).items():
        monkeypatch.setenv(k, v)
    assert trainer.main(TINY[2:] + ["--steps", "1", "--checkpoint-path", str(ckpt)]) == 0
    staging = tmp_path / "staging"
    _fsdp2_staging(staging)
    extra = [{}, {}]
    if fault == "member":
        _drop_member(staging / "src-0.npz", _rank1_only)
    else:
        copy = tmp_path / "staging-rank1"
        copy.mkdir()
        for f in staging.iterdir():
            (copy / f.name).write_bytes(f.read_bytes())
        marker = json.loads((copy / "src-0.json").read_text())
        marker["digest"] = "0" * 64
        (copy / "src-0.json").write_text(json.dumps(marker))
        extra[1] = dict(KUBEDL_RESHARD_DIR=str(copy))
    port = free_port()
    procs = [_start(_env(tmp_path, _ctl(tmp_path, f"ctl{r}"),
                         KUBEDL_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         KUBEDL_NUM_PROCESSES="2", KUBEDL_PROCESS_ID=str(r),
                         KUBEDL_CHECKPOINT_PATH=str(ckpt), **extra[r]), 3)
             for r in range(2)]
    rcs, outs = _finish(procs)
    assert rcs == [0, 0], outs
    why = ("staging unusable (" if fault == "member"
           else "live-reshard staging differs across the gang")
    for out in outs:
        assert why in out and "falling back to checkpoint restore" in out, out[-3000:]
        assert "restored live-reshard staging" not in out
    if fault == "member":
        assert "elements missing, 0 delivered more than once)" in outs[1]
        assert "staging unusable (a peer could not assemble its part)" in outs[0]
    assert "restored checkpoint at step 1" in outs[0] and "done: 2 steps" in outs[0]
    # the member's fault shows after the agreed mesh was built: the
    # checkpoint restores onto it; the marker's before, onto KUBEDL_MESH's
    want = "{'data': 1, 'fsdp': 2, " if fault == "member" else "{'data': 2, 'fsdp': 1, "
    assert f"mesh: {want}" in outs[0]
    assert not (staging / "manifest.json").exists()


def test_pipeline_stages_with_live_reshard_exit_2(monkeypatch, capsys):
    monkeypatch.setenv("KUBEDL_LIVE_RESHARD", "1")
    monkeypatch.setenv("KUBEDL_PP_STAGES", "2")
    assert trainer.main(TINY[2:] + ["--steps", "1"]) == 2
    assert ("pipeline config invalid: spec.elastic.liveReshard is unsupported with "
            "spec.pipeline (the reshard planner does not cover stage-stacked layouts)"
            in capsys.readouterr().err)
