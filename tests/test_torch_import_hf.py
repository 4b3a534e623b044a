"""kubedl_tpu_torch/models/import_hf.py against the JAX package's importer on
the same local Hugging Face directories, each built here with transformers'
save_pretrained: the configs equal field by field (the refusals included),
the trees equal bit for bit (bf16 included) from a single safetensors file,
a sharded index and pytorch_model.bin, f32 logits within 1e-4 of max|JAX|
and at the JAX test's tolerance of transformers' own, greedy decode equal
token for token."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from kubedl_tpu.models import decode as jdecode
from kubedl_tpu.models import import_hf as jimport
from kubedl_tpu.models import llama as jllama
from kubedl_tpu_torch.models import decode as tdecode
from kubedl_tpu_torch.models import import_hf as timport
from kubedl_tpu_torch.models import llama as tllama
from kubedl_tpu_torch.utils.convert import params_to_numpy, torch_dtype
from hf_dirs import GEMMA2, save_hf

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=144, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
             rms_norm_eps=1e-5)
# name: (config class, keys, saved as: "single" | "sharded" | "bin", dtype on disk)
CASES = {
    "llama": ("LlamaConfig", dict(SMALL), "sharded", torch.bfloat16),
    "mistral": ("MistralConfig", dict(SMALL, sliding_window=8), "single", torch.float32),
    "gemma": ("GemmaConfig", dict(SMALL, head_dim=16), "bin", torch.float32),
    # Gemma-2 (tests/hf_dirs.py): tie_word_embeddings left at its default
    # (True), so save_pretrained leaves it out of config.json
    "gemma2": (*GEMMA2, "single", torch.bfloat16),
    "qwen2": ("Qwen2Config", dict(SMALL, num_hidden_layers=3, use_sliding_window=True,
                                  sliding_window=8, max_window_layers=1),
              "single", torch.float32),
    "llama3": ("LlamaConfig", dict(SMALL, vocab_size=96, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
        "single", torch.float32),
    "linear": ("LlamaConfig", dict(SMALL, vocab_size=96, tie_word_embeddings=True,
                                   rope_scaling={"rope_type": "linear", "factor": 2.0}),
               "bin", torch.float32),
}
F32 = {"dtype": jnp.float32, "use_flash": False}


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """name -> (dir, transformers model), built once a module."""
    made = {}

    def get(name, form=None):
        cls_name, keys, default_form, dtype = CASES[name]
        form = form or default_form
        key = (name, form)
        if key not in made:
            path = str(tmp_path_factory.mktemp(f"{name}-{form}"))
            made[key] = path, save_hf(path, cls_name, keys, form, dtype,
                                      seed=list(CASES).index(name))
        return made[key]

    return get


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = torch_dtype(out["dtype"])
    return out


def _jax_config(path, **overrides):
    return jimport.config_from_hf(transformers.AutoConfig.from_pretrained(path), **overrides)


@pytest.mark.parametrize("name", list(CASES))
def test_config_equals_jax_field_by_field(hf, name):
    path, _ = hf(name)
    with open(f"{path}/config.json") as f:
        saved = json.load(f)
    if name == "gemma2":  # the pitfall: the default is not written
        assert "tie_word_embeddings" not in saved
    port = timport.config_from_hf(saved)
    assert _fields(port) == _fields(_jax_config(path))
    assert port.dtype == torch.bfloat16


REFUSALS = [
    (dict(model_type="gpt2"), "unsupported model_type"),
    (dict(model_type="llama", rope_scaling={"rope_type": "yarn", "factor": 8.0}),
     "rope_scaling"),
    (dict(model_type="llama", rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
     "rope_scaling"),
    (dict(model_type="llama", rope_scaling={"rope_type": "llama3", "factor": 8.0}),
     "missing"),
    (dict(model_type="llama", attention_bias=True), "bias"),
    (dict(model_type="llama", mlp_bias=True), "bias"),
    (dict(model_type="gemma", hidden_size=3072, num_attention_heads=16, head_dim=256),
     "head_dim mismatch"),
]


@pytest.mark.parametrize("keys,match", REFUSALS, ids=[m for _, m in REFUSALS])
def test_refusals_equal_jax(keys, match):
    """The port refuses what the reference refuses, with its message (the
    JAX side reads the same keys from a duck-typed config, as its own tests
    do where transformers would refuse at construction)."""
    import types

    base = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64)
    keys = dict(base, **keys)
    with pytest.raises(ValueError, match=match) as jerr:
        jimport.config_from_hf(types.SimpleNamespace(**keys))
    with pytest.raises(ValueError, match=match) as terr:
        timport.config_from_hf(keys)
    assert str(terr.value) == str(jerr.value)


def test_disabled_qwen2_windows_collapse_like_jax():
    import types

    base = dict(model_type="qwen2", vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
                max_position_embeddings=64, rms_norm_eps=1e-6)
    for extra in ({"use_sliding_window": True, "sliding_window": None},
                  {"use_sliding_window": True, "sliding_window": 0},
                  {"use_sliding_window": True, "sliding_window": 16, "max_window_layers": 2}):
        port = timport.config_from_hf(dict(base, **extra))
        jax_cfg = jimport.config_from_hf(types.SimpleNamespace(**base, **extra))
        assert port.layer_windows is None and port.sliding_window is None, extra
        assert _fields(port) == _fields(jax_cfg)


def _assert_trees_bit_equal(port, ref):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _assert_trees_bit_equal(port[k], ref[k])
    elif isinstance(ref, list):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _assert_trees_bit_equal(p, r)
    elif ref is None:
        assert port is None
    else:
        ref = np.asarray(ref)
        assert port.dtype == ref.dtype and port.shape == ref.shape
        assert port.tobytes() == ref.tobytes()


TREE_CASES = [(n, None) for n in CASES] + [("gemma2", "sharded"), ("gemma2", "bin")]


@pytest.mark.parametrize("name,form", TREE_CASES,
                         ids=[f"{n}-{f or CASES[n][2]}" for n, f in TREE_CASES])
def test_tree_bit_equal_to_jax(hf, name, form):
    """load_hf on the same directory: every leaf equal bit for bit through
    utils/convert.py, in the config's bf16."""
    path, _ = hf(name, form)
    written = {"single": "model.safetensors", "sharded": "model.safetensors.index.json",
               "bin": "pytorch_model.bin"}[form or CASES[name][2]]
    assert os.path.isfile(os.path.join(path, written))
    jparams, jcfg = jimport.load_hf(path)
    tparams, tcfg = timport.load_hf(path, device="cpu")
    assert _fields(tcfg) == _fields(jcfg)
    _assert_trees_bit_equal(params_to_numpy(tparams), jax.device_get(jparams))
    assert ("lm_head" in tparams) == (not tcfg.tie_embeddings)


@pytest.fixture(scope="module")
def f32_models(hf):
    """name -> (JAX params, JAX config, port params, port config, HF model), f32."""
    out = {}

    def get(name):
        if name not in out:
            path, model = hf(name)
            jp, jc = jimport.load_hf(path, config_overrides=F32)
            tp, tc = timport.load_hf(path, {"dtype": torch.float32}, device="cpu")
            out[name] = jp, jc, tp, tc, model
        return out[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_jax_and_transformers(f32_models, name):
    jp, jc, tp, tc, model = f32_models(name)
    # 24 tokens: past every window (8) and, for llama3, the rescaled bands
    tokens = np.random.default_rng(5).integers(0, tc.vocab_size, (2, 24))
    ours = tllama.forward(tp, torch.from_numpy(tokens), tc).numpy()
    ref = np.asarray(jllama.forward(jp, jnp.asarray(tokens), jc))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    with torch.no_grad():
        hf_logits = model(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(ours, hf_logits, atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("name", ["llama", "gemma2", "qwen2"])
def test_greedy_decode_equals_jax(f32_models, name):
    """Cached greedy decode token for token against the JAX package's: the
    windowed, softcapped Gemma-2 and Qwen2's per-layer windows past their
    window, and plain Llama."""
    jp, jc, tp, tc, _ = f32_models(name)
    prompt = np.random.default_rng(6).integers(1, tc.vocab_size, (1, 13)).astype(np.int32)
    ref = np.asarray(jdecode.generate(jp, jnp.asarray(prompt), jc, max_new_tokens=6,
                                      max_len=19))
    ours = tdecode.generate(tp, torch.from_numpy(prompt), tc, 6, max_len=19)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_load_hf_refuses_what_it_cannot_read(tmp_path, monkeypatch):
    """A missing directory, a directory with no config or no weights, and a
    truncated safetensors file raise with the path; asking for the card
    without one raises."""
    missing = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError, match=missing):
        timport.load_hf(missing, device="cpu")
    with pytest.raises(FileNotFoundError, match="no config.json"):
        timport.load_hf(str(tmp_path), device="cpu")
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "llama", **SMALL}))
    with pytest.raises(FileNotFoundError, match=f"{tmp_path}: no model.safetensors"):
        timport.load_hf(str(tmp_path), device="cpu")
    (tmp_path / "model.safetensors").write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{}")
    with pytest.raises(ValueError, match="cut short"):
        timport.load_hf(str(tmp_path), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        timport.load_hf(str(tmp_path))
