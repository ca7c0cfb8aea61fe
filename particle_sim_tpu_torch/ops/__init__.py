"""Physics, gravity and sort: the plain PyTorch versions and the wrappers
of their CUDA kernels."""
