"""The port's trainer with LlamaConfig.tiny in f32, as a module a launcher
runs (``python -m kubedl_tpu_torch.train.launch ... -- torch_trainer_f32
[trainer args]``, with tests/ on PYTHONPATH), so a gang's losses can be
held to a one-device step at 1e-5. With KUBEDL_TEST_BATCH_DIR set, every
batch the loss sees is saved there as rank<r>-<i>.npy."""
import os
import sys

import numpy as np
import torch

from kubedl_tpu_torch.models import llama

tiny = llama.LlamaConfig.tiny
llama.LlamaConfig.tiny = staticmethod(lambda **kw: tiny(**{"dtype": torch.float32, **kw}))

record = os.environ.get("KUBEDL_TEST_BATCH_DIR")
if record:
    loss_fn, seen = llama.loss_fn, [0]

    def recording_loss_fn(params, tokens, *a, **kw):
        rank = os.environ.get("KUBEDL_PROCESS_ID", "0")
        np.save(os.path.join(record, f"rank{rank}-{seen[0]}.npy"), tokens.numpy())
        seen[0] += 1
        return loss_fn(params, tokens, *a, **kw)

    llama.loss_fn = recording_loss_fn

if __name__ == "__main__":
    from kubedl_tpu_torch.train import trainer

    sys.exit(trainer.main(sys.argv[1:]))
