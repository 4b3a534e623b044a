"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each ``ops/csrc/<name>.cu`` exposes a plain C interface. It is compiled
with nvcc for sm_90a into ``build/kubedl_tpu_torch/`` at the root of the
checkout, under a file name that carries a hash of the source and flags,
so an edited source rebuilds and an unchanged one loads from disk. The
compiler's register and spill report (``-Xptxas -v``) is kept beside the
library as ``<lib>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubedl_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


_loaded: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when it was
# already on disk); chip_smoke.py reports them
build_seconds: Dict[str, float] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's default
    install prefix. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile each csrc/<name>.cu whose library is not built yet, one nvcc
    process a source, all started together; returns {name: library}."""
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log = proc.communicate()[0]
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".so.log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise BuildError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first call."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """Registers / shared memory / spill lines nvcc printed for `name`."""
    log = library_path(name).with_suffix(".so.log")
    if not log.exists():
        return ""
    keep = ("registers", "spill", "Compiling entry")
    return "\n".join(ln.strip() for ln in log.read_text().splitlines()
                     if any(k in ln for k in keep))
