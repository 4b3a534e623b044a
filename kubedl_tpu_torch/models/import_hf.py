"""Hugging Face Llama, Mistral, Gemma, Gemma-2 and Qwen2 checkpoints, read
from a local directory (kubedl_tpu/models/import_hf.py).

    params, config = load_hf("/models/gemma-2-2b", device="cuda")

`config_from_hf` maps a ``config.json`` dict onto the port's LlamaConfig
exactly as the reference maps a transformers config: Gemma's GeGLU, its
RMSNorm weights stored as w - 1 and its sqrt(d) embedding scale; Gemma-2's
sandwich norms, both softcaps, query_pre_attn_scalar, decoupled head_dim
and alternating windows; Qwen2's q/k/v biases and per-layer windows; the
"llama3" and "linear" rope scalings. `params_from_state_dict` gives the
port's parameter tree (projections transposed to [in, out]).

The directory is read without transformers: ``config.json`` with json, the
weights from ``model.safetensors``, a sharded
``model.safetensors.index.json`` (both through this module's reader of the
format) or ``pytorch_model.bin``, safetensors first, as transformers
prefers them. `load_hf` moves one tensor at a time onto the device, so a
7B import never holds a second copy of the tree on the host.
"""
from __future__ import annotations

import json
import os
import struct
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from kubedl_tpu_torch.models.llama import LlamaConfig, RopeScaling
from kubedl_tpu_torch.utils.device import resolve_device

MODEL_TYPES = ("llama", "mistral", "gemma", "gemma2", "qwen2")

# transformers' defaults (its LlamaConfig, MistralConfig, GemmaConfig,
# Gemma2Config and Qwen2Config) for every key config_from_hf reads:
# save_pretrained writes only the keys that differ from them, so a saved
# Gemma-2 config.json has no tie_word_embeddings (True) and may have no
# sliding_window (4096)
_COMMON = dict(rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
               rope_scaling=None, attention_bias=False, mlp_bias=False)
HF_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "llama": dict(_COMMON, vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=None,
                  max_position_embeddings=2048, head_dim=None),
    "mistral": dict(_COMMON, vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=131072, sliding_window=4096, head_dim=None),
    "gemma": dict(_COMMON, vocab_size=256000, hidden_size=3072, intermediate_size=24576,
                  num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16,
                  max_position_embeddings=8192, head_dim=256, tie_word_embeddings=True),
    "gemma2": dict(_COMMON, vocab_size=256000, hidden_size=2304, intermediate_size=9216,
                   num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4,
                   max_position_embeddings=8192, head_dim=256, tie_word_embeddings=True,
                   sliding_window=4096, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, query_pre_attn_scalar=256,
                   layer_types=None),
    "qwen2": dict(_COMMON, vocab_size=151936, hidden_size=4096, intermediate_size=22016,
                  num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
                  max_position_embeddings=32768, sliding_window=4096,
                  use_sliding_window=False, max_window_layers=28),
}


def _resolved(hf_config: Dict[str, Any], model_type: str) -> Dict[str, Any]:
    """The config's keys as transformers' config class holds them after
    loading the dict: its defaults under the dict, then the values its
    constructor derives."""
    c = {**HF_DEFAULTS[model_type], **hf_config}
    if c.get("num_key_value_heads") is None:
        c["num_key_value_heads"] = c["num_attention_heads"]
    if model_type == "llama" and c.get("head_dim") is None:
        c["head_dim"] = c["hidden_size"] // c["num_attention_heads"]
    if model_type == "gemma2" and c.get("layer_types") is None:
        # sliding on even layers (configs that predate layer_types too)
        c["layer_types"] = ["sliding_attention" if (i + 1) % 2 else "full_attention"
                            for i in range(c["num_hidden_layers"])]
    if model_type == "qwen2" and not c.get("use_sliding_window"):
        c["sliding_window"] = None
    return c


def config_from_hf(hf_config: Dict[str, Any], **overrides) -> LlamaConfig:
    """LlamaConfig from a Hugging Face ``config.json`` dict."""
    model_type = hf_config.get("model_type", "llama")
    if model_type not in MODEL_TYPES:
        raise ValueError(
            f"unsupported model_type {model_type!r} "
            f"(llama, mistral, gemma, gemma2, qwen2)")
    c = _resolved(hf_config, model_type)
    kw = dict(
        vocab_size=c["vocab_size"],
        d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        d_ff=c["intermediate_size"],
        max_seq_len=c["max_position_embeddings"],
        rope_theta=float(c["rope_theta"]),
        rms_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        # sliding_window None or 0 means disabled
        sliding_window=(c.get("sliding_window") or None),
        dtype=torch.bfloat16,
    )
    if model_type in ("gemma", "gemma2"):
        kw.update(
            act="gelu_tanh",
            norm_offset=1.0,  # RMSNorm weights are stored as w - 1
            embed_scale=float(c["hidden_size"]) ** 0.5,
        )
    if model_type == "gemma2":
        # sandwich norms, attention and final logit softcaps, scores scaled
        # by query_pre_attn_scalar**-0.5, head_dim apart from d_model /
        # n_heads, and alternating local / global attention
        kw.update(
            post_block_norms=True,
            attn_logit_softcap=float(c.get("attn_logit_softcapping", 0.0) or 0.0),
            final_logit_softcap=float(c.get("final_logit_softcapping", 0.0) or 0.0),
            query_pre_attn_scalar=float(c["query_pre_attn_scalar"]),
            head_dim_override=int(c["head_dim"]),
        )
        kw["sliding_window"] = None
        w = c.get("sliding_window") or None
        if w is not None:
            wins = tuple(int(w) if lt == "sliding_attention" else None
                         for lt in c["layer_types"])
            if any(x is not None for x in wins):
                kw["layer_windows"] = wins
    if model_type == "qwen2":
        # biased q/k/v; a window only with use_sliding_window, and then only
        # on the layers at and above max_window_layers. A disabled window, or
        # one that covers no layer, is plain full attention
        kw["attn_qkv_bias"] = True
        kw["sliding_window"] = None
        if c["use_sliding_window"]:
            w = c.get("sliding_window") or None
            cut = int(c["max_window_layers"])
            if w is not None and cut < c["num_hidden_layers"]:
                kw["layer_windows"] = tuple(None if i < cut else int(w)
                                            for i in range(c["num_hidden_layers"]))

    # rope scaling: llama3 and linear; dynamic / yarn are refused (importing
    # them would give degraded logits with exit 0)
    scaling = c.get("rope_scaling")
    if scaling:
        rope_type = scaling.get("rope_type") or scaling.get("type")
        if rope_type in (None, "default"):
            pass
        elif rope_type == "llama3":
            # all four are required: a guessed original_max_position_embeddings
            # would rescale at the wrong wavelength boundaries
            missing = [k for k in ("factor", "low_freq_factor", "high_freq_factor",
                                   "original_max_position_embeddings")
                       if k not in scaling]
            if missing:
                raise ValueError(
                    f"rope_scaling llama3 is missing {missing} — refusing "
                    f"to guess frequency boundaries")
            kw["rope_scaling"] = RopeScaling(
                kind="llama3",
                factor=float(scaling["factor"]),
                low_freq_factor=float(scaling["low_freq_factor"]),
                high_freq_factor=float(scaling["high_freq_factor"]),
                original_max_position_embeddings=int(
                    scaling["original_max_position_embeddings"]),
            )
        elif rope_type == "linear":
            kw["rope_scaling"] = RopeScaling(kind="linear", factor=float(scaling["factor"]))
        else:
            raise ValueError(
                f"rope_scaling {scaling!r} not supported (default, llama3, "
                f"linear; dynamic/yarn aren't implemented)")
    kw.update(overrides)
    if c["attention_bias"] or c["mlp_bias"]:
        raise ValueError("attention/mlp bias tensors not supported "
                         "(this stack's projections are bias-free)")
    cfg = LlamaConfig(**kw)
    expect_hd = c["hidden_size"] // c["num_attention_heads"]
    got_hd = c.get("head_dim") or expect_hd
    if cfg.head_dim != got_hd:
        raise ValueError(
            f"head_dim mismatch: ours {cfg.head_dim}, HF {got_hd} — "
            f"non-standard head_dim checkpoints aren't supported")
    return cfg


def params_from_state_dict(state_dict: Mapping, config: LlamaConfig,
                           device=None) -> Dict:
    """The port's parameter tree from an HF state dict (tensors, or a
    mapping that reads them on access). Each weight goes through f32 to
    config.dtype, projections transposed to [in, out]; norms and biases
    are f32. `device` (default: where each tensor lies) is where the
    conversion runs and the tree lives."""

    def arr(key: str, transpose: bool = False):
        t = state_dict[key].detach()
        # to the device in the checkpoint's dtype, then a new f32 copy there
        t = t.to(device if device is not None else t.device).to(torch.float32, copy=True)
        return t.T if transpose else t

    def cast(t):
        return t.to(config.dtype).contiguous()

    def f32(key: str):
        return arr(key).contiguous()

    layers = []
    for i in range(config.n_layers):
        p = f"model.layers.{i}"
        layer = {
            "attn_norm": f32(f"{p}.input_layernorm.weight"),
            "wq": cast(arr(f"{p}.self_attn.q_proj.weight", transpose=True)),
            "wk": cast(arr(f"{p}.self_attn.k_proj.weight", transpose=True)),
            "wv": cast(arr(f"{p}.self_attn.v_proj.weight", transpose=True)),
            "wo": cast(arr(f"{p}.self_attn.o_proj.weight", transpose=True)),
            # Gemma-2 uses this name for its attention output norm; its
            # pre-MLP norm is pre_feedforward_layernorm (below)
            "mlp_norm": (None if config.post_block_norms
                         else f32(f"{p}.post_attention_layernorm.weight")),
            "w1": cast(arr(f"{p}.mlp.gate_proj.weight", transpose=True)),
            "w3": cast(arr(f"{p}.mlp.up_proj.weight", transpose=True)),
            "w2": cast(arr(f"{p}.mlp.down_proj.weight", transpose=True)),
        }
        if config.attn_qkv_bias:  # Qwen2
            for name, proj in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                layer[name] = f32(f"{p}.self_attn.{proj}.bias")
        if config.post_block_norms:  # Gemma-2 sandwich norms
            layer["mlp_norm"] = f32(f"{p}.pre_feedforward_layernorm.weight")
            layer["post_attn_norm"] = f32(f"{p}.post_attention_layernorm.weight")
            layer["post_mlp_norm"] = f32(f"{p}.post_feedforward_layernorm.weight")
        layers.append(layer)
    params = {
        "embed": cast(arr("model.embed_tokens.weight")),
        "layers": layers,
        "final_norm": f32("model.norm.weight"),
    }
    if not config.tie_embeddings:
        # a checkpoint with no lm_head ties it, whatever its config said
        key = "lm_head.weight" if "lm_head.weight" in state_dict else "model.embed_tokens.weight"
        params["lm_head"] = cast(arr(key, transpose=True))
    return params


# safetensors: an 8-byte little-endian header length, a JSON header
# {name: {"dtype", "shape", "data_offsets": [begin, end]}} (offsets from the
# end of the header), then the raw little-endian bytes
SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
                      "F64": torch.float64}
SAFETENSORS_SINGLE = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_BIN = "pytorch_model.bin"


def read_safetensors_header(path: str) -> Tuple[int, Dict[str, Any]]:
    """(byte offset of the data, header without __metadata__) of a
    .safetensors file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        raw = f.read(n)
    if len(raw) != n:
        raise ValueError(f"{path}: safetensors header of {n} bytes is cut short")
    header = json.loads(raw)
    header.pop("__metadata__", None)
    return 8 + n, header


class SafetensorsWeights(Mapping):
    """Read-on-access mapping name -> CPU tensor over one or more
    .safetensors files: each access maps that tensor's bytes alone."""

    def __init__(self, paths):
        self._where: Dict[str, Tuple[str, int, Dict[str, Any]]] = {}
        for path in paths:
            start, header = read_safetensors_header(path)
            for name, info in header.items():
                self._where[name] = (path, start, info)

    def __getitem__(self, name: str) -> torch.Tensor:
        path, start, info = self._where[name]
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']} "
                             f"(supported: {sorted(SAFETENSORS_DTYPES)})")
        begin, end = info["data_offsets"]
        if start + end > os.path.getsize(path):
            raise ValueError(f"{path}: tensor {name!r} is cut short")
        if end == begin:
            return torch.empty(info["shape"], dtype=dtype)
        # mapped copy-on-write: the bytes come from the page cache as the
        # caller copies them, and the file is never written
        raw = np.memmap(path, dtype=np.uint8, mode="c", offset=start + begin,
                        shape=(end - begin,))
        return torch.from_numpy(raw).view(dtype).reshape(info["shape"])

    def __iter__(self):
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def hf_weights(path: str) -> Mapping:
    """The weights of a checkpoint directory as a name -> tensor mapping:
    model.safetensors, a sharded model.safetensors.index.json, else
    pytorch_model.bin (memory-mapped)."""
    single = os.path.join(path, SAFETENSORS_SINGLE)
    index = os.path.join(path, SAFETENSORS_INDEX)
    if os.path.isfile(single):
        return SafetensorsWeights([single])
    if os.path.isfile(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        return SafetensorsWeights([os.path.join(path, s) for s in shards])
    binary = os.path.join(path, TORCH_BIN)
    if os.path.isfile(binary):
        return torch.load(binary, map_location="cpu", mmap=True, weights_only=True)
    raise FileNotFoundError(
        f"{path}: no {SAFETENSORS_SINGLE}, {SAFETENSORS_INDEX} or {TORCH_BIN}")


def load_hf(path: str, config_overrides: Optional[Dict] = None,
            device="cuda") -> Tuple[Dict, LlamaConfig]:
    """(params on `device`, config) from a local Hugging Face checkpoint
    directory. A missing or unreadable directory raises with its path."""
    dev = resolve_device(device)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: not a Hugging Face checkpoint directory")
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"{path}: no config.json")
    with open(cfg_path) as f:
        hf_config = json.load(f)
    config = config_from_hf(hf_config, **(config_overrides or {}))
    params = params_from_state_dict(hf_weights(path), config, device=dev)
    return params, config
