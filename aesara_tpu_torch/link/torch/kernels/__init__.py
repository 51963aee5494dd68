"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version: K1 ``elemwise`` (Triton) and K2 ``attention`` (CUDA C++).

Nothing here imports ``triton`` or builds a kernel at import time.
"""
