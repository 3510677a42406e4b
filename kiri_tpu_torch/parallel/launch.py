"""Start a function on N fresh processes, one rank each, and collect what
every rank returns: the port's launcher where ``torchrun`` is not the
caller (the tests on the CPU, ``entry.dryrun_multichip``, the card's smoke
run of two ranks on one card).

    results = spawn("package.module:function", 2, {"x": 1}, device="cpu")

The ranks are ``torch.multiprocessing.start_processes`` children: each
joins the group over ``tcp://127.0.0.1:<a free port>`` with
``parallel.initialize`` (gloo unless told otherwise), calls the function
with the keyword arguments, writes its return value (pickled) and leaves
the group. A rank that fails fails the call and the other ranks are
stopped; a call that outlives ``timeout`` stops them all, so a rank waiting
in a collective never hangs the caller.
"""
from __future__ import annotations

import importlib
import pickle
import socket
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, n: int, kwargs: Optional[Dict[str, Any]] = None,
          device: str = "cpu", backend: str = "gloo", timeout: float = 600,
          threads: int = 2, paths: Sequence[str] = ()) -> List[Any]:
    """Run ``target`` ("module:function") as ranks 0..n-1 of a new process
    group on ``device`` ("cpu", "cuda:0" for every rank on card 0, "cuda"
    for card rank % cards) over ``backend``; returns each rank's return
    value in rank order. ``paths`` are put on the ranks' ``sys.path`` (the
    target's module may live there); ``threads`` is each rank's torch
    thread count. Raises RuntimeError naming the failing rank, with its
    traceback."""
    coordinator = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="kiri_spawn_") as tmp:
        ctx = mp.start_processes(
            _rank, (target, n, coordinator, device, backend,
                    pickle.dumps(kwargs or {}), tmp, threads, list(paths)),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(0.0, deadline - time.monotonic()), 5.0):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"{target} on {n} ranks timed out "
                                       f"after {timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"{target} on {n} ranks: rank {e.error_index} "
                               f"failed, the others stopped\n{e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [pickle.loads((Path(tmp) / f"result{r}.pkl").read_bytes())
                for r in range(n)]


def _rank(rank: int, target: str, n: int, coordinator: str, device: str,
          backend: str, kwargs: bytes, tmp: str, threads: int,
          paths: List[str]) -> None:
    import torch

    from . import initialize, shutdown

    torch.set_num_threads(threads)
    sys.path[:0] = paths
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    initialize(coordinator, n, rank, backend=backend, device=device)
    out = fn(**pickle.loads(kwargs))
    shutdown()
    (Path(tmp) / f"result{rank}.pkl").write_bytes(pickle.dumps(out))
