"""Tensor ops of the port: K1 attention, resize, panoptic post-processing."""
