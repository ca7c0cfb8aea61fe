"""Small utilities: PNG writer, searches, the CUDA kernel build."""
