"""The port's asynchronous checkpoint saves (kubedl_tpu_torch/train/
checkpoint.py), held to Orbax's semantics in the JAX package's trainer:
`save` returns once the state is snapshotted, a writer thread publishes
the step, `latest_step` lags the write in flight, one save is in flight
at a time, a writer's error is raised on the caller's thread, and the
programs' final saves wait. The write is held by a blocking seam (a
patched `torch.save` waiting on an Event), so nothing here races a
clock; each wait has a timeout."""
import os
import threading

import pytest
import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.parallel import optim
from kubedl_tpu_torch.parallel.train_step import TrainState, make_train_step
from kubedl_tpu_torch.train import checkpoint, generate, trainer

WAIT = 60.0  # seconds any join or event may take before the test fails


def _tiny_state(seed=0):
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    init_state, train_step = make_train_step(lambda p, b: llama.loss_fn(p, b, cfg),
                                             optim.adamw(1e-2, weight_decay=0.01))
    batch = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1),
                          dtype=torch.int32)
    return cfg, init_state(params), train_step, batch


def _copy(state):
    return {"params": llama.tree_map(lambda t: t.detach().clone(), state.params),
            "opt_state": llama.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t, state.opt_state),
            "step": state.step}


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k])
                                                                    for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _published(path, step):
    return torch.load(os.path.join(path, str(step), checkpoint.STATE_FILE),
                      weights_only=True)


class _Held:
    """torch.save held on an Event until `release`; `entered` is set when a
    write reaches it."""

    def __init__(self, monkeypatch):
        self.real, self.go, self.entered = torch.save, threading.Event(), threading.Event()
        monkeypatch.setattr(checkpoint.torch, "save", self)

    def __call__(self, obj, f):
        self.entered.set()
        assert self.go.wait(WAIT), "the held write was never released"
        return self.real(obj, f)

    def release(self):
        self.go.set()


def test_save_returns_before_the_write_and_the_file_is_the_snapshot(tmp_path, monkeypatch):
    """The write is held: save returns, latest_step still reads the older
    step, a train step and an in-place change of the live state run; once
    released the published step equals the state at save, bit for bit."""
    _, state, train_step, batch = _tiny_state()
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    state, _ = train_step(state, batch)
    mngr.save(1, state)
    mngr.wait_until_finished()
    assert mngr.latest_step() == 1
    state, _ = train_step(state, batch)
    want = _copy(state)
    held = _Held(monkeypatch)
    mngr.save(2, state)
    assert held.entered.wait(WAIT)
    assert mngr.latest_step() == 1 and mngr.all_steps() == [1]  # lags the write
    state, _ = train_step(state, batch)  # the optimizer updates the leaves in place
    for p in llama.tree_leaves(state.params):
        p.data.add_(1.0)
    assert not _equal(_copy(state)["params"], want["params"])
    held.release()
    mngr.wait_until_finished()
    assert mngr.all_steps() == [1, 2]
    got = _published(str(tmp_path), 2)
    assert _equal(got["params"], want["params"]) and _equal(got["opt_state"], want["opt_state"])
    assert got["step"] == want["step"] == 2


def test_one_save_in_flight(tmp_path, monkeypatch):
    """A second save waits for the first: while the first write is held,
    the second call does not return; both publish once it is released."""
    _, state, _, _ = _tiny_state()
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    held = _Held(monkeypatch)
    mngr.save(1, state)
    assert held.entered.wait(WAIT)
    second = threading.Thread(target=mngr.save, args=(2, state))
    second.start()
    second.join(0.5)
    assert second.is_alive(), "the second save returned while the first was in flight"
    assert mngr.all_steps() == []
    held.release()
    second.join(WAIT)
    assert not second.is_alive()
    mngr.wait_until_finished()
    assert mngr.all_steps() == [1, 2]


@pytest.mark.parametrize("surfaced_by", ["wait_until_finished", "save"])
def test_a_writer_error_is_raised_on_the_callers_thread(tmp_path, monkeypatch, surfaced_by):
    """torch.save raising on the writer thread: save itself returns, the
    step is not published, and the next wait_until_finished or save raises
    that error; the manager saves again afterwards."""
    _, state, _, _ = _tiny_state()
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    real = torch.save

    def broken(obj, f):
        raise OSError("No space left on device")

    monkeypatch.setattr(checkpoint.torch, "save", broken)
    mngr.save(1, state)
    with pytest.raises(OSError, match="No space left"):
        if surfaced_by == "save":
            mngr.save(2, state)  # raises before it starts a write of its own
        else:
            mngr.wait_until_finished()
    assert mngr.all_steps() == []
    monkeypatch.setattr(checkpoint.torch, "save", real)
    mngr.save(3, state)
    mngr.wait_until_finished()
    assert mngr.all_steps() == [3]


def test_pruning_and_saving_a_step_again(tmp_path):
    """max_to_keep 2 keeps the newest two steps; a step saved again holds
    the newer state; no temporary directory is left behind."""
    _, state, train_step, batch = _tiny_state()
    mngr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        state, _ = train_step(state, batch)
        mngr.save(step, state)
    mngr.wait_until_finished()
    assert mngr.all_steps() == [2, 3]
    state, _ = train_step(state, batch)
    want = _copy(state)
    mngr.save(3, state)
    mngr.wait_until_finished()
    assert mngr.all_steps() == [2, 3]
    assert _equal(_published(str(tmp_path), 3)["params"], want["params"])
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]


def test_an_async_step_restores(tmp_path, capsys):
    """A step saved asynchronously, the live state changed right after:
    restore brings back the state at save into a fresh one, and
    generate.restore_or_init reads its params."""
    cfg, state, train_step, batch = _tiny_state()
    state, _ = train_step(state, batch)
    want = _copy(state)
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    mngr.save(1, state)
    state, _ = train_step(state, batch)
    mngr.wait_until_finished()
    _, fresh, _, _ = _tiny_state(seed=5)
    restored = checkpoint.CheckpointManager(str(tmp_path)).restore(1, fresh)
    assert restored.step == 1 and _equal(_copy(restored)["params"], want["params"])
    assert _equal(_copy(restored)["opt_state"], want["opt_state"])
    params = generate.restore_or_init(cfg, str(tmp_path), device="cpu")
    assert _equal(params, want["params"])
    assert "restored target params from checkpoint step 1" in capsys.readouterr().out


def test_the_trainers_final_save_waits(tmp_path, monkeypatch, capsys):
    """Every write takes 0.2 s longer; the trainer saves every step and
    returns with its last step published and nothing left in flight."""
    import time

    real = torch.save

    def slow(obj, f):
        time.sleep(0.2)
        return real(obj, f)

    monkeypatch.setattr(checkpoint.torch, "save", slow)
    writers = threading.active_count()
    assert trainer.main(["--device", "cpu", "--model", "tiny", "--batch", "2", "--seq-len", "17",
                         "--steps", "3", "--log-every", "100", "--checkpoint-path",
                         str(tmp_path), "--checkpoint-interval", "1"]) == 0
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert threading.active_count() == writers
    assert "saved final checkpoint at step 3" in capsys.readouterr().out


def test_a_state_with_no_tensors_in_some_leaves(tmp_path):
    """Non-tensor leaves (counts, None) pass through the snapshot as they are."""
    state = TrainState(params={"w": torch.arange(6.0).reshape(2, 3)},
                       opt_state={"count": 4, "mu": [torch.ones(2), None]}, step=7)
    mngr = checkpoint.CheckpointManager(str(tmp_path))
    mngr.save(7, state)
    state.params["w"].zero_()
    mngr.wait_until_finished()
    got = _published(str(tmp_path), 7)
    assert torch.equal(got["params"]["w"], torch.arange(6.0).reshape(2, 3))
    assert got["opt_state"]["count"] == 4 and got["opt_state"]["mu"][1] is None
    assert got["step"] == 7


def test_many_saves_with_a_short_switch_interval(tmp_path, monkeypatch):
    """Forty saves with the interpreter switching threads every microsecond,
    the state changed in place right after each, every third write failing:
    each failure is raised exactly once, by the next call, and every other
    step is published holding the state at its save."""
    import sys

    state = TrainState(params={"w": torch.zeros(64, 64)}, opt_state={}, step=0)
    mngr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=0)
    real = torch.save

    def flaky(obj, f):
        if obj["step"] % 3 == 0:
            raise OSError(f"write of step {obj['step']} failed")
        return real(obj, f)

    monkeypatch.setattr(checkpoint.torch, "save", flaky)
    raised = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(1, 41):
            state.step = step
            state.params["w"].fill_(step)
            try:
                mngr.save(step, state)
            except OSError as e:
                raised.append(str(e))
                mngr.save(step, state)  # the failed step's successor saves anew
            state.params["w"].fill_(-1.0)  # in place, the write in flight
        try:
            mngr.wait_until_finished()
        except OSError as e:
            raised.append(str(e))
    finally:
        sys.setswitchinterval(interval)
    assert raised == [f"write of step {s} failed" for s in range(3, 41, 3)]
    published = mngr.all_steps()
    assert published == [s for s in range(1, 41) if s % 3]
    for s in published:
        got = _published(str(tmp_path), s)
        assert got["step"] == s and torch.equal(got["params"]["w"], torch.full((64, 64), float(s)))
