"""Configuration, meters, the stdout tee and the profiling hooks of the
port."""

from .logging import Logger

__all__ = ["Logger"]
