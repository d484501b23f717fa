"""PyTorch/CUDA port of ``ldmseg_tpu`` for NVIDIA Hopper GPUs.

Mirrors the JAX package's module names. Plain tensor code is PyTorch; each
Pallas kernel of the ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``). Entry
points run on ``"cuda"`` unless the caller passes another device; on the
CPU every kernel wrapper runs its plain PyTorch version.
"""
