"""One intra-op thread for torch in the port's CPU tests.

The tests run tiny shapes, where OpenMP's fork/join and spin-waiting cost
more than the work, and the suite runs several pytest workers side by side
on one host, each of which would otherwise start a thread per core: on an
8-core CPU host a tiny GRPO step took 0.1-3.5 s with 8 threads and 0.03 s
with one. Every tests/test_torch_*.py imports this module; the gang
processes get OMP_NUM_THREADS=1 from tests/torch_gang.py."""
import torch

torch.set_num_threads(1)
