"""Attractor physics: the plain PyTorch stepper and the CUDA kernel."""
