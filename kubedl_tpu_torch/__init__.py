"""PyTorch/CUDA port of the kubedl_tpu compute plane for NVIDIA Hopper.

The package mirrors kubedl_tpu's layout (models/, ops/, train/, utils/) so
each module names its reference by path, and it imports neither JAX nor
anything of kubedl_tpu. Plain tensor code is PyTorch; every kernel that the
JAX package wrote in Pallas is a kernel written by hand for sm_90a
(ops/csrc/), built at first use and bound with ctypes. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; a CPU tensor takes each
kernel's plain PyTorch version, a CUDA tensor the kernel.
"""
