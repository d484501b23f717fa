"""Debug and numerical-safety utilities (counterpart of
``ldmseg_tpu/train/debug.py``).

  * ``checkified(fn)``: run ``fn`` under
    ``torch.autograd.detect_anomaly(check_nan=True)`` (a backward that
    makes a NaN raises naming its autograd function) and raise
    ``FloatingPointError`` naming the first non-finite floating output,
    where JAX's ``checkify`` raises on the NaN inside.
  * ``assert_all_finite(tree)``: a host-side finiteness sweep of nested
    dicts, lists, state dicts or a module's parameters and buffers, for
    post-mortems.

Both are opt-in: no training or serving path calls them.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from collections.abc import Mapping
from typing import Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` in JAX's ``tree_leaves_with_path`` order and its
    ``keystr`` form: a dict's keys sorted, another Mapping's (an
    ``OrderedDict``, a state dict) in its order, a list's or tuple's by
    index; a module as its parameters, then its buffers, by name; None is
    an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, nn.Module):
        tree = OrderedDict(list(tree.named_parameters())
                           + list(tree.named_buffers()))
    if isinstance(tree, Mapping):
        keys = sorted(tree) if type(tree) is dict else list(tree)
        for k in keys:
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    """False for a floating tensor or array with a NaN or an infinity; True
    for anything else (integers, bools, Python numbers)."""
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(
            torch.isfinite(leaf.detach()).all())
    if isinstance(leaf, (np.ndarray, np.generic)) and np.issubdtype(
            leaf.dtype, np.floating):
        return bool(np.isfinite(leaf).all())
    return True


def checkified(fn):
    """Return a wrapped ``fn`` that raises ``FloatingPointError`` on a NaN
    or an infinity among its floating outputs, and runs under autograd's
    anomaly mode with its NaN check, so that a backward run inside ``fn``
    that makes a NaN raises at the function that made it."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.autograd.detect_anomaly(check_nan=True):
            out = fn(*args, **kwargs)
        for path, leaf in _leaves(out, "output"):
            if not _finite(leaf):
                raise FloatingPointError(
                    f"non-finite values in {path} of "
                    f"{getattr(fn, '__name__', fn)!s}")
        return out

    return wrapped


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming (the first 10 of) the floating
    leaves of ``tree`` that hold a NaN or an infinity: nested dicts, lists
    and tuples of tensors or numpy arrays, a state dict, or a module (its
    parameters and buffers)."""
    bad = [path for path, leaf in _leaves(tree) if not _finite(leaf)]
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: {bad[:10]}"
            + ("..." if len(bad) > 10 else ""))
