"""Inverse rendering on the port: the training step and the trainer."""
