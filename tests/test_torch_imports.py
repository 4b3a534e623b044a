"""kubedl_tpu_torch stands alone: no module of it, nor chip_smoke.py,
imports JAX, optax, orbax or anything of kubedl_tpu, and every module (the
trainer, the transport plane and the serving plane included) imports with
those and ml_dtypes made unimportable; the transport and serving planes
import no ml_dtypes at all (bf16 crosses as raw words viewed through
torch). Entry points never pick the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "kubedl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m in ("jax", "optax", "orbax", "kubedl_tpu")
           or m.startswith(("jax.", "jaxlib", "kubedl_tpu.", "optax.", "orbax."))]
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_without_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in PORT_FILES if p.name != "chip_smoke.py"]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'kubedl_tpu', 'optax', 'orbax', 'ml_dtypes'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.startswith(('jax', 'kubedl_tpu.', 'optax',"
            " 'orbax', 'ml_dtypes')) and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok', len([m for m in sys.modules if m.startswith('kubedl_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


PLANE_FILES = [ROOT / "kubedl_tpu_torch" / sub / f"{n}.py"
               for sub, names in (("transport", ("__init__", "plane", "metrics", "control",
                                                 "blocks")),
                                  ("serving", ("__init__", "kv_pool", "handoff",
                                               "engine_prefill", "engine_decode",
                                               "disaggregated", "router", "rollout")))
               for n in names]


def test_the_planes_are_walked():
    """The transport and serving planes are among the files both checks
    above cover."""
    assert set(PLANE_FILES) <= set(PORT_FILES)


PIPELINE_FILES = [ROOT / "kubedl_tpu_torch" / f for f in (
    "parallel/pipeline.py", "parallel/pipeline_mpmd.py", "train/pipeline_runtime.py",
    "train/pipeline_trainer.py")]


def test_the_pipeline_modules_are_walked():
    """The pipeline's modules are among the files both checks above cover."""
    assert all(p.is_file() for p in PIPELINE_FILES)
    assert set(PIPELINE_FILES) <= set(PORT_FILES)


CONTEXT_FILES = [ROOT / "kubedl_tpu_torch" / f for f in (
    "ops/ring_attention.py", "ops/ulysses.py", "train/launch.py")]


def test_the_context_modules_are_walked():
    """Context parallelism's modules and the per-GPU launcher are among the
    files both checks above cover."""
    assert all(p.is_file() for p in CONTEXT_FILES)
    assert set(CONTEXT_FILES) <= set(PORT_FILES)


RESHARD_FILES = [ROOT / "kubedl_tpu_torch" / f for f in (
    "parallel/reshard.py", "train/reshard_runtime.py", "transport/control.py",
    "transport/blocks.py")]


def test_the_reshard_modules_are_walked():
    """The live reshard's modules (the planner, the trainer's runtime, the
    socket control channel and the staged fetch) are among the files both
    checks above cover, and the ml_dtypes check below."""
    assert all(p.is_file() for p in RESHARD_FILES)
    assert set(RESHARD_FILES) <= set(PORT_FILES)


SLICE21_FILES = [ROOT / "kubedl_tpu_torch" / f for f in (
    "train/smoke_distributed.py", "train/checkpoint.py", "train/mnist.py")]


def test_the_rendezvous_smoke_is_walked():
    """The rendezvous smoke, the asynchronous checkpoint manager and the
    multi-process MNIST job are among the files both checks above cover."""
    assert all(p.is_file() for p in SLICE21_FILES)
    assert set(SLICE21_FILES) <= set(PORT_FILES)


@pytest.mark.parametrize("path", PLANE_FILES + RESHARD_FILES[:2],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_planes_never_import_ml_dtypes(path):
    bad = [m for m in _imports(path) if m == "ml_dtypes" or m.startswith("ml_dtypes.")]
    assert not bad, f"{path.name} imports {bad}"


def test_resolve_device_raises_without_a_card(monkeypatch):
    from kubedl_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)  # the default is the card, never the CPU
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_model_entry_points_default_to_the_card(monkeypatch):
    from kubedl_tpu_torch.models import decode, llama

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError):
        llama.init(cfg)
    with pytest.raises(RuntimeError):
        decode.init_kv_cache(cfg, 1, 8)


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
