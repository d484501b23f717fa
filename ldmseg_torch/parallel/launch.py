"""Start N ranks of one function in fresh processes and collect their
results (the port's ``mp.spawn``, reference ``tools/main_ldm.py:70``).

Each rank is a ``spawn`` process that joins a group through a ``FileStore``
in a private directory (no TCP port to race for), calls ``fn(rank,
*args)``, and writes what it returns with ``torch.save``; ranks on the
CPU share the caller's torch threads equally. The parent waits
at most ``timeout_s`` seconds for all of them; a rank that raises, dies or
outlives the deadline fails the call, and no rank is left running.

    from ldmseg_torch.parallel.launch import run_ranks
    results = run_ranks(my_module.work, 2, args=(cfg,), device="cpu")
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch


def _rank_main(fn, rank: int, n: int, args: tuple, store: str, out: str,
               device: str, backend: Optional[str], local_rank,
               timeout_s: float, threads: int) -> None:
    import torch.distributed as dist

    from .multihost import initialize_from_env
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the caller's cores: threads beyond a share
            # spin against each other
            torch.set_num_threads(threads)
        initialize_from_env(f"file://{store}", n, rank, device=device,
                            backend=backend,
                            local_rank=rank if local_rank is None
                            else local_rank, timeout_s=timeout_s)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, n: int, args: tuple = (), device: str = "cuda",
              backend: Optional[str] = None,
              local_rank: Optional[int] = None,
              timeout_s: float = 300.0) -> List[Any]:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each rank in its own
    process and group of ``n``. ``fn`` must be importable by name (a
    module-level function) and its module must not need the caller's
    imports. ``device``/``backend`` as :func:`~.multihost.
    initialize_from_env`, on the card unless the caller asks for the CPU
    (raises when CUDA is asked for and absent); ``local_rank`` binds every
    rank to that card (ranks sharing one device; gloo then, since NCCL
    refuses it)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: device 'cuda' asked for but "
                           "torch.cuda.is_available() is False")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ldmseg_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, n, args, store, tmp, device, backend, local_rank,
                  timeout_s, max(1, torch.get_num_threads() // n)),
            daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        late = False
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs
                          if not p.is_alive() and p.exitcode != 0]
                late = time.monotonic() > deadline
                if failed or late:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                why = (f"the deadline of {timeout_s} s" if late
                       else "another rank failed")
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (f" (killed: {why})" if p.exitcode is None
                                 or p.exitcode < 0 else ""))
        if errors:
            raise RuntimeError(f"{len(errors)} of {n} ranks failed:\n"
                               + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
