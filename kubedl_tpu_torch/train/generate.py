"""Weight resolution for the generate/serve entry points
(kubedl_tpu/train/generate.py). Only the fresh-init route is ported:
checkpoint restore and Hugging Face import raise until they are
(ROADMAP.md)."""
from __future__ import annotations

import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.utils.device import resolve_device


def resolve_params(model, hf_model="", checkpoint_path="", allow_fresh_init=False,
                   seed=0, label="target", device="cuda"):
    """(params, config) for a named model: --hf-model and checkpoints are
    not ported yet, so this is a fresh init, which must be asked for."""
    if hf_model:
        raise NotImplementedError(
            f"--hf-model {hf_model!r}: Hugging Face import is not yet ported "
            f"to kubedl_tpu_torch (ROADMAP.md)")
    config = llama.LlamaConfig.config_for(model)
    return restore_or_init(config, checkpoint_path, allow_fresh_init, seed=seed,
                           label=label, device=device), config


def restore_or_init(config, checkpoint_path="", allow_fresh_init=False, seed=0,
                    label="target", device="cuda"):
    """Fresh parameters on `device`, drawn from a generator seeded with
    `seed`, as the JAX package does when no checkpoint path is given. A
    checkpoint path raises: restore is not yet ported."""
    if checkpoint_path:
        raise NotImplementedError(
            f"--checkpoint-path {checkpoint_path!r} ({label}): checkpoint "
            f"restore is not yet ported to kubedl_tpu_torch (ROADMAP.md)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return llama.init(config, gen, device=dev)
