"""Multi-device stepping on torch.distributed (one process a device)."""
