"""Hand-written CUDA kernels (csrc/) and their wrappers.

Each wrapper takes the JAX function's public layout, checks device, dtype,
shape and contiguity, and keeps a launch count (`launches`). A tensor on the
CPU goes to the plain PyTorch version in the same module; a CUDA tensor
launches the kernel or raises.
"""
