"""The kernels' launch counters, and their replay under a CUDA graph.

Every kernel wrapper of the port counts on the host where it launches its
kernel (``fn.launches += 1``; K1's wide class in ``wide_launches``) and,
where it has a plain branch on a shape its kernel does not take, where it
takes that branch (``fn.fallbacks``).
A CUDA graph launches its kernels without running the wrappers, so
:class:`CountReplay` records what one capture counted and adds it again on
every replay: the counters then read as they would after the same steps
run eagerly.
"""

from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Optional, Tuple

COUNTERS = ("launches", "fallbacks", "wide_launches")
# the modules that hold counted wrappers
_MODULES = ("attention", "attention_s8", "geglu", "gemm", "gn_silu_conv",
            "groupnorm_silu")


def counted_wrappers() -> List[object]:
    """Every function of the port's ops modules that counts its launches."""
    out, seen = [], set()
    for name in _MODULES:
        mod = importlib.import_module(f"{__package__}.{name}")
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "launches") and \
                    id(fn) not in seen:
                seen.add(id(fn))
                out.append(fn)
    return out


class CountReplay:
    """``start()`` before a capture, ``stop()`` after it: the counts that
    the capture made are kept as the delta of one replay and taken back off
    the counters (the capture launched nothing). ``replay(n)`` adds ``n``
    deltas. ``fns`` defaults to :func:`counted_wrappers`."""

    def __init__(self, fns: Optional[Iterable[object]] = None):
        self.fns = list(counted_wrappers() if fns is None else fns)
        self.delta: Dict[Tuple[int, str], int] = {}
        self._before: Optional[Dict[Tuple[int, str], int]] = None

    def read(self) -> Dict[Tuple[int, str], int]:
        return {(i, a): getattr(f, a) for i, f in enumerate(self.fns)
                for a in COUNTERS if hasattr(f, a)}

    def start(self) -> None:
        self._before = self.read()

    def stop(self) -> None:
        if self._before is None:
            raise RuntimeError("CountReplay.stop() without start()")
        after = self.read()
        self.delta = {k: after[k] - v for k, v in self._before.items()
                      if after[k] != v}
        for (i, a), v in self._before.items():
            setattr(self.fns[i], a, v)
        self._before = None

    def replay(self, n: int = 1) -> None:
        for (i, a), d in self.delta.items():
            setattr(self.fns[i], a, getattr(self.fns[i], a) + n * d)
