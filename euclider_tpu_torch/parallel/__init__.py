"""Multi-device rendering and training over torch.distributed."""
