"""DDIM schedule and sampler of the port."""
