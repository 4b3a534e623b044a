"""A post-training program of the port (train/dpo.py, grpo.py or
evaluate.py) with LlamaConfig.tiny in f32, as a module a gang's processes
run (``python -m torch_post_training_f32 dpo [program args]``, with tests/
on PYTHONPATH), so a gang's numbers can be held to one process's at 1e-4.
With KUBEDL_TEST_METRICS set, every DPO or GRPO step's metrics are
appended to that path (one JSON object a line, suffixed .rank<r>)."""
import json
import os
import sys

import torch

from kubedl_tpu_torch.models import llama
from kubedl_tpu_torch.train import preference, rl

tiny = llama.LlamaConfig.tiny
llama.LlamaConfig.tiny = staticmethod(lambda **kw: tiny(**{"dtype": torch.float32, **kw}))


def recording(make_step):
    """make_step with its last returned function (the update) recording
    each step's metrics."""
    path = os.environ.get("KUBEDL_TEST_METRICS")
    if not path:
        return make_step
    path += f".rank{os.environ.get('KUBEDL_PROCESS_ID', '0')}"

    def make(*a, **kw):
        *fns, step = make_step(*a, **kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            with open(path, "a") as f:
                f.write(json.dumps({k: float(v) for k, v in metrics.items()}) + "\n")
            return state, metrics
        return (*fns, recorded)
    return make


preference.make_dpo_step = recording(preference.make_dpo_step)
rl.make_grpo_step = recording(rl.make_grpo_step)

if __name__ == "__main__":
    import importlib

    program = importlib.import_module(f"kubedl_tpu_torch.train.{sys.argv[1]}")
    sys.exit(program.main(sys.argv[2:]))
