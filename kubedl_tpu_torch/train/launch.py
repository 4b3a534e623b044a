"""One process per local device: a pod's command starts a child process for
each card it holds, each child one rank of the gang.

    python -m kubedl_tpu_torch.train.launch [--local-devices N] [--device cpu] \\
        -- <module> [args]

The port runs one device per process (parallel/mesh.py), where one JAX
process drives all of its host's chips, so this has no counterpart in the
JAX package. The operator injects KUBEDL_COORDINATOR_ADDRESS,
KUBEDL_NUM_PROCESSES (P pods) and KUBEDL_PROCESS_ID (this pod, p). With G
local devices (the CUDA driver's count, or --local-devices), child l
runs ``python -m <module> [args]`` with

    KUBEDL_PROCESS_ID = p * G + l,  KUBEDL_NUM_PROCESSES = P * G,
    CUDA_VISIBLE_DEVICES = the pod's l-th visible card (on the card),

so `mesh_from_env` and the trainer see a gang of P * G processes of one
device each, and child 0 of pod 0 (rank 0) hosts the store at the
coordinator address. A pod of one without an address gets a loopback one.
Child 0 keeps the pod's POD_NAME (its trace spans are the pod's); child
l > 0 records under POD_NAME-l.
`--device cpu` starts --local-devices children without touching
CUDA_VISIBLE_DEVICES (the CPU tests).

SIGTERM to the launcher goes to every child. The launcher exits 113 when
any child exited 113 (preempted: the ExitCode policy restarts the pod),
otherwise with the first non-zero code, otherwise 0. A child that dies
with another code takes the others down (they would wait on it in their
next collective); nothing is retried here.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

from kubedl_tpu_torch.train.coordinator import (ENV_COORDINATOR_ADDRESS, ENV_NUM_PROCESSES,
                                                ENV_PROCESS_ID)
from kubedl_tpu_torch.utils.exit_codes import EXIT_TPU_PREEMPTED


def parse_args(argv=None):
    p = argparse.ArgumentParser("kubedl-launch-torch",
                                usage="%(prog)s [--local-devices N] [--device cpu] "
                                      "-- <module> [args]")
    p.add_argument("--local-devices", type=int, default=None,
                   help="children to start (default: the visible CUDA devices)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cpu: start --local-devices children on the CPU")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- <module> [args]: the program each child runs")
    args = p.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        p.error("no module to run: -- <module> [args]")
    args.command = cmd
    return args


def cuda_device_count() -> int:
    """The CUDA devices this process sees (CUDA_VISIBLE_DEVICES applies),
    as the driver counts them; 0 without a driver. The launcher asks the
    driver (cuInit, cuDeviceGetCount) rather than torch, whose import would
    cost every pod seconds before its children start."""
    import ctypes

    try:
        driver = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    n = ctypes.c_int(0)
    if driver.cuInit(0) != 0 or driver.cuDeviceGetCount(ctypes.byref(n)) != 0:
        return 0
    return n.value


def _visible_cards(n: int, env: dict) -> List[str]:
    """The names of the pod's n visible cards, as CUDA_VISIBLE_DEVICES
    lists them (or their indices when it is unset)."""
    seen = env.get("CUDA_VISIBLE_DEVICES")
    names = [x.strip() for x in seen.split(",") if x.strip()] if seen else []
    return names[:n] if len(names) >= n else [str(i) for i in range(n)]


def _loopback_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def child_envs(local: int, device: str, env: Optional[dict] = None) -> List[dict]:
    """The environment of each of the `local` children of this pod."""
    env = dict(os.environ if env is None else env)
    pods = int(env.get(ENV_NUM_PROCESSES, "1"))
    pod = int(env.get(ENV_PROCESS_ID, "0"))
    if env.get(ENV_COORDINATOR_ADDRESS) is None and pods == 1 and local > 1:
        env[ENV_COORDINATOR_ADDRESS] = _loopback_address()
    cards = _visible_cards(local, env) if device == "cuda" else None
    out = []
    for l in range(local):
        e = dict(env, **{ENV_PROCESS_ID: str(pod * local + l),
                         ENV_NUM_PROCESSES: str(pods * local)})
        if cards is not None:
            e["CUDA_VISIBLE_DEVICES"] = cards[l]
        if l and env.get("POD_NAME"):  # each child's spans and steps a file of its own
            e["POD_NAME"] = f"{env['POD_NAME']}-{l}"
        out.append(e)
    return out


def exit_code(codes: List[Optional[int]]) -> int:
    """113 when any child was preempted, else the first non-zero code (in
    the order the children ended), else 0."""
    if EXIT_TPU_PREEMPTED in codes:
        return EXIT_TPU_PREEMPTED
    for c in codes:
        if c:
            return c if c > 0 else 128 - c  # killed by signal s: 128 + s
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    local = args.local_devices
    if local is None:
        if args.device == "cpu":
            print("--device cpu needs --local-devices", file=sys.stderr)
            return 2
        local = cuda_device_count()
        if local < 1:
            print("no CUDA device is visible: pass --device cpu --local-devices N "
                  "to start CPU processes", file=sys.stderr)
            return 2
    procs: List[subprocess.Popen] = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)

    prev = signal.signal(signal.SIGTERM, forward)
    ended: List[int] = []  # exit codes in the order the children ended
    try:
        envs = child_envs(local, args.device)
        for e in envs:
            procs.append(subprocess.Popen([sys.executable, "-m"] + args.command, env=e))
        live = dict(enumerate(procs))
        while live:
            for l, p in list(live.items()):
                if p.poll() is None:
                    continue
                del live[l]
                ended.append(p.returncode)
                print(f"launch: rank {envs[l][ENV_PROCESS_ID]} exited {p.returncode}",
                      file=sys.stderr, flush=True)
                if p.returncode not in (0, EXIT_TPU_PREEMPTED):
                    for q in live.values():  # the rest would wait on it forever
                        q.kill()
            time.sleep(0.05)
    finally:
        signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return exit_code(ended)


if __name__ == "__main__":
    sys.exit(main())
