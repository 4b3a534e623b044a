"""The port's rendezvous (kubedl_tpu_torch/train/coordinator.py) against
the JAX package's: `process_info` and `_resolve_local` case by case; a
2-process gloo group formed from KUBEDL_COORDINATOR_ADDRESS,
KUBEDL_NUM_PROCESSES and KUBEDL_PROCESS_ID, its service-DNS host mapped to
loopback; and a process without an address left ungrouped. Name lookups
are answered by a stand-in for socket.getaddrinfo, so no test asks a
resolver."""
import torch_threads  # noqa: F401 -- one intra-op thread (tests/torch_threads.py)
import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from kubedl_tpu.train import coordinator as jcoord
from kubedl_tpu_torch.train import coordinator
from torch_gang import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = {
    "empty": {},
    "gang": {"KUBEDL_COORDINATOR_ADDRESS": "job-worker-0.default.svc:8471",
             "KUBEDL_NUM_PROCESSES": "4", "KUBEDL_PROCESS_ID": "3"},
    "multislice": {"KUBEDL_NUM_PROCESSES": "8", "KUBEDL_PROCESS_ID": "5",
                   "KUBEDL_NUM_SLICES": "2", "KUBEDL_SLICE_ID": "1"},
    "reshard": {"KUBEDL_CONTROL_DIR": "/ctl", "KUBEDL_LIVE_RESHARD": "1",
                "KUBEDL_RESHARD_DIR": "/stage"},
    "reshard_off": {"KUBEDL_LIVE_RESHARD": "0"},
}
KNOWN = {"127.0.0.1", "localhost"}


def _getaddrinfo(host, *args, **kwargs):
    if host in KNOWN:
        return [(socket.AF_INET, socket.SOCK_STREAM, 6, "", ("127.0.0.1", 0))]
    raise socket.gaierror(socket.EAI_NONAME, "not known")


@pytest.mark.parametrize("name", list(ENVS))
def test_process_info_matches_the_jax_package(name, monkeypatch):
    for k in list(os.environ):
        if k.startswith("KUBEDL_"):
            monkeypatch.delenv(k)
    for k, v in ENVS[name].items():
        monkeypatch.setenv(k, v)
    mine, ref = coordinator.process_info(), jcoord.process_info()
    for field in ("coordinator_address", "num_processes", "process_id", "num_slices",
                  "slice_id", "control_dir", "live_reshard", "reshard_dir",
                  "is_distributed", "is_multislice"):
        assert getattr(mine, field) == getattr(ref, field), field


@pytest.mark.parametrize("address", ["job-worker-0.default.svc:8471",
                                     "job-worker-0.default.svc", "127.0.0.1:1234",
                                     "localhost:29500", "other.ns.svc.cluster.local:9"])
def test_resolve_local_matches_the_jax_package(address, monkeypatch):
    monkeypatch.setattr(socket, "getaddrinfo", _getaddrinfo)
    assert coordinator._resolve_local(address) == jcoord._resolve_local(address)


def test_a_process_without_an_address_stays_ungrouped(monkeypatch):
    for k in ("KUBEDL_COORDINATOR_ADDRESS", "KUBEDL_NUM_PROCESSES", "KUBEDL_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    info = coordinator.initialize()
    assert info.coordinator_address is None and info.num_processes == 1
    assert not dist.is_initialized()


GANG = (
    "import socket, sys, torch, torch.distributed as dist\n"
    "real = socket.getaddrinfo\n"
    "def lookup(host, *a, **kw):\n"
    "    if host.endswith('.svc'):\n"
    "        raise socket.gaierror(socket.EAI_NONAME, 'not known')\n"
    "    return real(host, *a, **kw)\n"
    "socket.getaddrinfo = lookup\n"
    "from kubedl_tpu_torch.train import coordinator\n"
    "info = coordinator.initialize()\n"
    "x = torch.tensor([info.process_id + 1.0])\n"
    "dist.all_reduce(x)\n"
    "print('rank', dist.get_rank(), 'of', dist.get_world_size(), dist.get_backend(), "
    "'sum', int(x.item()))\n"
    "dist.destroy_process_group()\n")


def test_two_processes_form_a_group_from_the_operator_env():
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   KUBEDL_COORDINATOR_ADDRESS=f"gang-worker-0.default.svc:{port}",
                   KUBEDL_NUM_PROCESSES="2", KUBEDL_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", GANG], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    for rank, out in enumerate(outs):
        assert f"rank {rank} of 2 gloo sum 3" in out, out
