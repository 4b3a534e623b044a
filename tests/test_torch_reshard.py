"""The port's live-reshard modules against the JAX package's, on the CPU
without a gang: the planner (kubedl_tpu_torch/parallel/reshard.py) over
tests/test_reshard.py's mesh pairs and leaves -- equal transfers, locals,
byte counts and digest() strings, the same PlanErrors; `pod_region`,
`assemble` and the port's `coverage`; `refit_axes` over a grid with every
ReshardError; the staging (train/reshard_runtime.py) both ways -- for the
same plan and blocks the port's markers, manifest and npz members equal the
reference's, a staging written by either package restores in the other,
and the fail-closed cases; `ReshardControl` polling and replying as the
reference's; and the socket control channel and staged fetch
(transport/control.py, transport/blocks.py) across the two packages'
planes in both directions, with a stale epoch and a corrupt transfer
refused. Every recv waits at most 10 s; every plane is closed after its
test."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import json
import os
import shutil
import time
import zipfile

import numpy as np
import pytest
import torch

from kubedl_tpu.parallel import reshard as jr
from kubedl_tpu.train import reshard_runtime as jrt
from kubedl_tpu.transport import SocketControlRouter as JaxRouter
from kubedl_tpu.transport import SocketReshardControl as JaxControl
from kubedl_tpu.transport import TransportPlane as JaxPlane
from kubedl_tpu.transport import fetch_staging as jax_fetch
from kubedl_tpu.transport import serve_staging as jax_serve
from kubedl_tpu_torch.parallel import reshard as tr
from kubedl_tpu_torch.parallel.mesh import P
from kubedl_tpu_torch.train import reshard_runtime as trt
from kubedl_tpu_torch.transport import (
    SocketControlRouter,
    SocketReshardControl,
    TransportError,
    TransportPlane,
    fetch_staging,
    serve_staging,
)
from test_reshard import MESH_PAIRS, _leaves

TOKEN = "reshard-token"
RECV_S = 10.0


def _port_leaves(leaves):
    """The same leaves with the port's PartitionSpec."""
    return {k: (shape, item, P(*tuple(spec))) for k, (shape, item, spec) in leaves.items()}


def _moves(plan):
    return ([(t.path, t.src, t.dst, t.rect, t.nbytes) for t in plan.transfers],
            [(t.path, t.src, t.dst, t.rect, t.nbytes) for t in plan.locals_])


@pytest.mark.parametrize("axes_a,pods_a,axes_b,pods_b", MESH_PAIRS)
def test_plans_and_digests_equal_the_reference(axes_a, pods_a, axes_b, pods_b):
    leaves = _leaves()
    want = jr.plan_reshard(leaves, axes_a, axes_b, pods_a, pods_b)
    got = tr.plan_reshard(_port_leaves(leaves), axes_a, axes_b, pods_a, pods_b)
    assert _moves(got) == _moves(want)
    assert (got.moved_bytes, got.local_bytes, got.total_bytes) == \
        (want.moved_bytes, want.local_bytes, want.total_bytes)
    assert got.digest() == want.digest()
    for pod in range(max(pods_a, pods_b)):
        assert _moves_of(got.for_source(pod)) == _moves_of(want.for_source(pod))
        assert _moves_of(got.for_dest(pod)) == _moves_of(want.for_dest(pod))
    # the live-shrink variant: sources restricted to surviving pods
    if pods_a > 1:
        alive = list(range(pods_a - 1))
        try:
            want = jr.plan_reshard(leaves, axes_a, axes_b, pods_a, pods_b, survivors=alive)
        except jr.PlanError as e:
            with pytest.raises(tr.PlanError, match="no surviving source") as got_e:
                tr.plan_reshard(_port_leaves(leaves), axes_a, axes_b, pods_a, pods_b,
                                survivors=alive)
            assert str(got_e.value) == str(e)
        else:
            got = tr.plan_reshard(_port_leaves(leaves), axes_a, axes_b, pods_a, pods_b,
                                  survivors=alive)
            assert got.digest() == want.digest()


def _moves_of(ts):
    return [(t.path, t.src, t.dst, t.rect, t.nbytes) for t in ts]


PLAN_ERRORS = {
    "indivisible": dict(leaves={"w": ((10, 4), 4, ("fsdp", None))},
                        old={"fsdp": 8}, new={"fsdp": 4}, pods=(1, 1), survivors=None),
    "dead_source": dict(leaves={"w": ((16, 8), 4, ("fsdp", None))},
                        old={"fsdp": 8}, new={"fsdp": 4}, pods=(4, 4), survivors=[0, 1, 2]),
    "pods": dict(leaves={"w": ((16, 8), 4, ("fsdp", None))},
                 old={"fsdp": 8}, new={"fsdp": 4}, pods=(3, 1), survivors=None),
}


@pytest.mark.parametrize("name", list(PLAN_ERRORS))
def test_plan_errors_equal_the_reference(name):
    c = PLAN_ERRORS[name]
    with pytest.raises(jr.PlanError) as want:
        jr.plan_reshard(c["leaves"], c["old"], c["new"], *c["pods"], survivors=c["survivors"])
    with pytest.raises(tr.PlanError) as got:
        tr.plan_reshard(_port_leaves(c["leaves"]), c["old"], c["new"], *c["pods"],
                        survivors=c["survivors"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axes_a,pods_a,axes_b,pods_b", MESH_PAIRS[:4])
def test_pod_region_assemble_and_coverage(axes_a, pods_a, axes_b, pods_b):
    leaves = _leaves()
    rng = np.random.default_rng(3)
    for path, (shape, _, spec) in leaves.items():
        glob = rng.integers(0, 1 << 30, size=shape, dtype=np.int32)
        for axes, pods in ((axes_a, pods_a), (axes_b, pods_b)):
            for pod in range(pods):
                want = jr.pod_region(shape, spec, axes, pods, pod)
                got = tr.pod_region(shape, P(*tuple(spec)), axes, pods, pod)
                assert got == want
                for rect in got:
                    assert tr.coverage(rect, [rect]) == (0, 0)
                    block = tr.extract_block(glob, rect)
                    np.testing.assert_array_equal(
                        tr.assemble(shape, glob.dtype, [(rect, block)], region=rect),
                        jr.assemble(shape, glob.dtype, [(rect, block)], region=rect))
        # the whole leaf from pod regions of the old mesh, deduped
        rects = sorted({r for pod in range(pods_a)
                        for r in tr.pod_region(shape, P(*tuple(spec)), axes_a, pods_a, pod)})
        pieces = [(r, tr.extract_block(glob, r)) for r in rects]
        np.testing.assert_array_equal(tr.assemble(shape, glob.dtype, pieces), glob)
        if not shape or len(pieces) < 2:
            continue
        # both coverage violations, the same message as the reference's
        full = tuple((0, s) for s in shape)
        for bad in (pieces[1:], pieces + pieces[:1]):
            with pytest.raises(jr.PlanError) as want:
                jr.assemble(shape, glob.dtype, bad)
            with pytest.raises(tr.PlanError) as got:
                tr.assemble(shape, glob.dtype, bad)
            assert str(got.value) == str(want.value)
            under, over = tr.coverage(full, [r for r, _ in bad])
            assert f"{under} elements missing, {over} delivered more than once" \
                in str(want.value)


REFIT_AXES = [{"data": 8}, {"data": 2, "fsdp": 4}, {"data": 2, "tensor": 2},
              {"tensor": 8}, {"data": 3}, {"data": 2, "fsdp": 3, "expert": 2},
              {"fsdp": 2}, {"data": 1}, {"data": 4, "context": 2}]


@pytest.mark.parametrize("axes", REFIT_AXES, ids=lambda a: ",".join(f"{k}{v}" for k, v in a.items()))
def test_refit_axes_equals_the_reference(axes):
    for total in (1, 2, 3, 4, 6, 7, 8, 12, 16):
        try:
            want = jrt.refit_axes(axes, total)
        except jrt.ReshardError as e:
            with pytest.raises(trt.ReshardError) as got:
                trt.refit_axes(axes, total)
            assert str(got.value) == str(e)
        else:
            assert trt.refit_axes(axes, total) == want


# ---------------------------------------------------------------------------
# the staging, both ways
# ---------------------------------------------------------------------------


def _state_leaves():
    """_leaves() plus a bf16 and an f32 leaf (dtype names ride in the keys)."""
    leaves = _leaves()
    leaves["h_bf16"] = ((8, 4), 2, leaves["w_embed"][2])
    leaves["h_f32"] = ((8, 4), 4, leaves["w_proj"][2])
    return leaves


def _arrays(leaves, seed=0):
    """Global arrays: the JAX side's numpy (ml_dtypes bf16), the port's torch."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    jax_side, port_side = {}, {}
    for path, (shape, item, _) in leaves.items():
        if path == "h_bf16":
            f = rng.standard_normal(shape).astype(np.float32)
            t = torch.from_numpy(f).to(torch.bfloat16)
            port_side[path] = t
            jax_side[path] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        elif path == "h_f32":
            f = rng.standard_normal(shape).astype(np.float32)
            jax_side[path], port_side[path] = f, torch.from_numpy(f.copy())
        else:
            a = (rng.integers(0, 1 << 30, size=shape, dtype=np.int32) if shape
                 else np.int32(rng.integers(0, 1 << 30)))
            jax_side[path], port_side[path] = np.asarray(a), torch.from_numpy(np.array(a))
    return jax_side, port_side


def _stores(leaves, arrays, axes, pods, port):
    """pod -> {(path, rect): block} under one topology."""
    planner = tr if port else jr
    store = {p: {} for p in range(pods)}
    for path, (shape, _, spec) in leaves.items():
        for pod in range(pods):
            for rect in planner.pod_region(shape, spec, axes, pods, pod):
                a = arrays[path]
                store[pod][(path, rect)] = a[tuple(slice(x, y) for x, y in rect)] if rect else a
    return store


def _stage(root, leaves, arrays, old, new, pods_a, pods_b, port, step=7):
    rt, planner = (trt, tr) if port else (jrt, jr)
    lv = _port_leaves(leaves) if port else leaves
    plan = planner.plan_reshard(lv, old, new, pods_a, pods_b)
    store = _stores(lv, arrays, old, pods_a, port)
    for pod in range(pods_a):
        rt.stage_shards(root, plan, pod, rt.provider_from_blocks(store[pod]), step)
    assert rt.write_manifest(root, plan, step, n_pods=pods_a, timeout=5.0)
    return plan


def _members(npz):
    with zipfile.ZipFile(npz) as z:
        return {n: z.read(n) for n in z.namelist()}


STAGE_PAIRS = [({"data": 2, "fsdp": 2}, 2, {"data": 4}, 1),
               ({"fsdp": 2}, 2, {"fsdp": 1}, 1),
               ({"data": 1}, 1, {"data": 2}, 2)]


@pytest.mark.parametrize("old,pods_a,new,pods_b", STAGE_PAIRS)
def test_staging_bytes_equal_and_restore_both_ways(tmp_path, old, pods_a, new, pods_b):
    leaves = _state_leaves()
    jax_arrays, port_arrays = _arrays(leaves)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _stage(jdir, leaves, jax_arrays, old, new, pods_a, pods_b, port=False)
    _stage(tdir, leaves, port_arrays, old, new, pods_a, pods_b, port=True)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in sorted(os.listdir(jdir)):
        if name.endswith(".json"):
            with open(os.path.join(jdir, name)) as a, open(os.path.join(tdir, name)) as b:
                assert a.read() == b.read(), name
        else:  # the zip container carries timestamps: compare its members
            assert _members(os.path.join(jdir, name)) == _members(os.path.join(tdir, name))
    for pod in range(pods_b):
        # each package's staging through the other's restore, and its own
        for root in (jdir, tdir):
            got_t = trt.restore_staged(root, pod, pods_b, expect_axes=new)
            got_j = jrt.restore_staged(root, pod, pods_b, expect_axes=new)
            assert got_t is not None and got_j is not None
            assert got_t[:2] == got_j[:2] == (7, {k: new.get(k, 1) for k in tr.AXIS_ORDER})
            assert sorted(got_t[2].keys()) == sorted(got_j[2].keys())
            for key in got_j[2].keys():
                assert got_t[2].load(key).tobytes() == got_j[2].load(key).tobytes(), key
            # assembled through the port's exactly-once coverage
            for path, (shape, _, spec) in leaves.items():
                for rect in tr.pod_region(shape, P(*tuple(spec)), new, pods_b, pod):
                    mine = [(r, got_t[2].load((p, r))) for (p, r) in got_t[2].keys()
                            if p == path and all(a >= ra and b <= rb for (a, b), (ra, rb)
                                                 in zip(r, rect))]
                    out = tr.assemble(shape, mine[0][1].dtype, mine, region=rect or None)
                    want = port_arrays[path]
                    want = want[tuple(slice(x, y) for x, y in rect)] if rect else want
                    assert out.tobytes() == trt._host_bytes(want)[0].tobytes(), path


def _staged_dir(tmp_path):
    leaves = _state_leaves()
    _, port_arrays = _arrays(leaves)
    root = str(tmp_path / "staging")
    plan = _stage(root, leaves, port_arrays, {"data": 2, "fsdp": 2}, {"data": 4}, 2, 2,
                  port=True)
    return root, plan


FAIL_CLOSED = ("digest_mismatch", "missing_source", "manifest_timeout", "wrong_pods",
               "wrong_axes")


@pytest.mark.parametrize("case", FAIL_CLOSED)
def test_staged_restore_fails_closed(tmp_path, case):
    """tests/test_reshard.py's fail-closed cases on the port's functions,
    and a staging for another pod count or topology."""
    expect, n_pods = {"data": 4}, 2
    if case == "manifest_timeout":
        leaves = _state_leaves()
        _, port_arrays = _arrays(leaves)
        root = str(tmp_path / "partial")
        lv = _port_leaves(leaves)
        plan = tr.plan_reshard(lv, {"data": 2, "fsdp": 2}, {"data": 4}, 2, 2)
        store = _stores(lv, port_arrays, {"data": 2, "fsdp": 2}, 2, True)
        trt.stage_shards(root, plan, 0, trt.provider_from_blocks(store[0]), 3)
        assert not trt.write_manifest(root, plan, 3, n_pods=2, timeout=0.2)
        assert not trt.staging_exists(root)
    else:
        root, _ = _staged_dir(tmp_path)
        assert trt.restore_staged(root, 0, n_pods, expect_axes=expect) is not None
        if case == "digest_mismatch":
            mpath = os.path.join(root, "manifest.json")
            with open(mpath) as f:
                manifest = json.load(f)
            manifest["digest"] = "0" * 64
            with open(mpath, "w") as f:
                json.dump(manifest, f)
        elif case == "missing_source":
            os.remove(os.path.join(root, "src-1.npz"))
        elif case == "wrong_pods":
            n_pods = 4
        else:
            expect = {"data": 2, "fsdp": 2}
        assert trt.staging_exists(root)
    assert trt.restore_staged(root, 0, n_pods, expect_axes=expect) is None
    assert jrt.restore_staged(root, 0, n_pods, expect_axes=expect) is None
    trt.clear_staging(root)
    assert not [n for n in os.listdir(root) if n == "manifest.json" or n.startswith("src-")]


# ---------------------------------------------------------------------------
# the control channel
# ---------------------------------------------------------------------------


def _post(d, n, msg):
    with open(os.path.join(d, f"msg-{n:04d}.json"), "w") as f:
        f.write(msg if isinstance(msg, str) else json.dumps(msg))


def test_reshard_control_polls_and_replies_as_the_reference(tmp_path):
    """Both packages' dir backends over the same messages: the same order,
    a corrupt file skipped, an answered message skipped by a restarted
    poller, the same reply bytes."""
    logs = {}
    for kind, cls in (("jax", jrt.ReshardControl), ("port", trt.ReshardControl)):
        d = str(tmp_path / kind)
        os.makedirs(d)
        _post(d, 1, {"type": "RESIZE", "chips": 4, "slice": "v5e-4"})
        _post(d, 2, "{not json")
        _post(d, 3, [1, 2])
        _post(d, 4, {"type": "DRAIN", "reply": "custom.json"})
        ctl = cls(d)
        seen = []
        msg = ctl.poll()
        while msg is not None:
            seen.append(msg)
            ctl.reply(msg, outcome="ok", step=len(seen), downtime_s=0.25)
            msg = ctl.poll()
        # a restarted poller skips what an earlier incarnation answered
        _post(d, 5, {"type": "RESIZE", "chips": 2})
        again = cls(d).poll()
        replies = {n: open(os.path.join(d, n)).read() for n in sorted(os.listdir(d))
                   if not n.startswith("msg-")}
        logs[kind] = (seen, again, replies)
    assert logs["port"] == logs["jax"]
    seen, again, _ = logs["port"]
    assert [m["reply"] for m in seen] == ["reply-0001.json", "custom.json"]
    assert again["reply"] == "reply-0005.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KUBEDL_CONTROL_DIR", str(tmp_path / "port"))
        mp.setenv("KUBEDL_TRANSPORT", "socket")  # the dir backend wins
        assert isinstance(trt.control_from_env(), trt.ReshardControl)
        mp.delenv("KUBEDL_CONTROL_DIR")
        mp.delenv("KUBEDL_TRANSPORT")
        assert trt.control_from_env() is None


@pytest.fixture
def planes():
    made = []

    def make(kind="port", **kw):
        kw.setdefault("token", TOKEN)
        kw.setdefault("latch", False)
        p = (TransportPlane if kind == "port" else JaxPlane)(**kw)
        made.append(p)
        return p

    try:
        yield make
    finally:
        for p in made:
            p.close()


def _wait_for(pred, timeout=RECV_S):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def _next_msg(ctl):
    """The endpoint's next message, waiting at most RECV_S."""
    got = []
    assert _wait_for(lambda: got.append(ctl.poll()) or got[-1] is not None)
    return got[-1]


def _dir_reply(tmp_path):
    d = str(tmp_path / "dirctl")
    os.makedirs(d)
    _post(d, 1, {"type": "RESIZE", "chips": 4, "slice": "v5e-4", "quiesce_timeout_s": 5.0})
    ctl = trt.ReshardControl(d)
    got = ctl.poll()
    ctl.reply(got, outcome="ok", downtime_s=0.25, step=7)
    with open(os.path.join(d, got["reply"])) as f:
        return got, f.read()


@pytest.mark.parametrize("router_kind,pod_kind", [("jax", "port"), ("port", "jax"),
                                                  ("port", "port")])
def test_socket_control_across_packages(planes, tmp_path, router_kind, pod_kind):
    """A RESIZE over one package's router to the other's pod endpoint: the
    pod sees the dir backend's fields, the spooled reply is the dir
    backend's bytes; a stale epoch is refused and counted."""
    dir_msg, dir_reply = _dir_reply(tmp_path)
    op = planes(router_kind, service="operator")
    op.listen("127.0.0.1:0")
    pod = planes(pod_kind, service="pod")
    pod_addr = pod.listen("127.0.0.1:0")
    epoch = {"e": 0}
    router = (JaxRouter if router_kind == "jax" else SocketControlRouter)(
        op, str(tmp_path / "spool"), addr_for=lambda ns, n: pod_addr,
        epoch_fn=lambda: epoch["e"])
    ctl = (JaxControl if pod_kind == "jax" else SocketReshardControl)(pod)
    path = router.post("default", "w0", {"type": "RESIZE", "chips": 4, "slice": "v5e-4",
                                         "quiesce_timeout_s": 5.0})
    assert path is not None and not os.path.exists(path)
    msg = _next_msg(ctl)
    for key in ("type", "chips", "slice", "quiesce_timeout_s"):
        assert msg[key] == dir_msg[key]
    ctl.reply(msg, outcome="ok", downtime_s=0.25, step=7)
    assert _wait_for(lambda: os.path.exists(path))
    with open(path) as f:
        assert f.read() == dir_reply
    # fencing: epoch 2 speaks, then a deposed epoch 1 is refused
    epoch["e"] = 2
    assert router.post("default", "w0", {"type": "RESIZE", "chips": 2}) is not None
    assert _next_msg(ctl)["epoch"] == 2
    epoch["e"] = 1
    assert router.post("default", "w0", {"type": "RESIZE", "chips": 1}) is not None
    assert _wait_for(lambda: ctl.poll() is None and ctl.stale_epoch_refusals == 1)
    # an unreachable pod returns None -- the scheduler's checkpoint path
    router2 = (JaxRouter if router_kind == "jax" else SocketControlRouter)(
        op, str(tmp_path / "spool2"), addr_for=lambda ns, n: None)
    assert router2.post("default", "gone", {"type": "RESIZE"}) is None


@pytest.mark.parametrize("server_kind,fetch_kind", [("jax", "port"), ("port", "jax")])
def test_staged_fetch_across_packages(planes, tmp_path, server_kind, fetch_kind):
    """A real staging served by one package's plane and fetched by the
    other's: every file byte for byte, the manifest last, the fetched copy
    restores; names outside the staging are not servable; a swarm peer
    without a file falls back to the publisher; a corrupt transfer is
    refused and leaves no manifest."""
    src, _ = _staged_dir(tmp_path)
    serve = jax_serve if server_kind == "jax" else serve_staging
    fetch = jax_fetch if fetch_kind == "jax" else fetch_staging
    peer = planes(server_kind, service="peer")
    peer_addr = peer.listen("127.0.0.1:0")
    serve(peer, src)
    empty = planes(server_kind, service="swarm")
    empty_addr = empty.listen("127.0.0.1:0")
    serve(empty, str(tmp_path / "nothing"))
    me = planes(fetch_kind, service="restarter")
    me.listen("127.0.0.1:0")
    dst = str(tmp_path / "fetched")
    n = fetch(me, peer_addr, dst, timeout=RECV_S, peers=[empty_addr])
    names = sorted(x for x in os.listdir(src) if not x.startswith("."))
    assert n == len(names) and sorted(os.listdir(dst)) == names
    for name in names:
        with open(os.path.join(src, name), "rb") as a, open(os.path.join(dst, name), "rb") as b:
            assert a.read() == b.read(), name
    assert trt.restore_staged(dst, 0, 2, expect_axes={"data": 4}) is not None
    from kubedl_tpu.transport.blocks import _fetch_one as jax_fetch_one
    from kubedl_tpu_torch.transport.blocks import _fetch_one

    with open(os.path.join(src, "secrets.txt"), "w") as f:
        f.write("no")
    one = jax_fetch_one if fetch_kind == "jax" else _fetch_one
    assert one(me, peer_addr, "secrets.txt", RECV_S) is None
    assert one(me, peer_addr, "../secrets.txt", RECV_S) is None
    with pytest.raises(TransportError if fetch_kind == "port" else Exception,
                       match="no published staging"):
        fetch(me, empty_addr, str(tmp_path / "d2"), timeout=RECV_S)

    orig = me.recv

    def corrupting(channel, tag, timeout=60.0):
        payload = orig(channel, tag, timeout)
        hlen = int.from_bytes(payload[:4], "big")
        if len(payload) > 4 + hlen:
            body = bytearray(payload)
            body[4 + hlen] ^= 0xFF
            return bytes(body)
        return payload

    me.recv = corrupting
    local = str(tmp_path / "corrupt")
    with pytest.raises(Exception, match="corrupt"):
        fetch(me, peer_addr, local, timeout=RECV_S)
    assert not os.path.exists(os.path.join(local, "manifest.json"))
    shutil.rmtree(local, ignore_errors=True)
