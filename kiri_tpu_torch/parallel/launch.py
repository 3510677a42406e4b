"""Start a function on N fresh processes, one rank each, and collect what
every rank returns: the port's launcher where ``torchrun`` is not the
caller (the tests on the CPU, ``entry.dryrun_multichip``, the card's smoke
run of two ranks on one card).

    results = spawn("package.module:function", 2, {"x": 1}, device="cpu")

The ranks are ``torch.multiprocessing.start_processes`` children: each
joins the group with ``parallel.initialize`` (gloo unless told otherwise)
through a ``TCPStore`` that the caller hosts on a port the OS picks and
holds until the ranks are done (so no other process can take the port
between its choice and the ranks' start), calls the function
with the keyword arguments, writes its return value (pickled) and leaves
the group. A rank that fails fails the call and the other ranks are
stopped; a call that outlives ``timeout`` stops them all, so a rank waiting
in a collective never hangs the caller.
"""
from __future__ import annotations

import importlib
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp


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
    host = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                         wait_for_workers=False)
    with tempfile.TemporaryDirectory(prefix="kiri_spawn_") as tmp:
        ctx = mp.start_processes(
            _rank, (target, n, host.port, device, backend,
                    pickle.dumps(kwargs or {}), tmp, threads, list(paths)),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(0.0, deadline - time.monotonic()), 5.0):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"{target} on {n} ranks timed out "
                                       f"after {timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            rank, why = _first_failure(tmp, e)
            raise RuntimeError(f"{target} on {n} ranks: rank {rank} failed, "
                               f"the others stopped\n{why}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [pickle.loads((Path(tmp) / f"result{r}.pkl").read_bytes())
                for r in range(n)]


def _first_failure(tmp: str, e: Exception):
    """(rank, traceback) of the rank that raised first: a rank that fails
    makes the ranks waiting for it in a collective fail after it, and any
    of them may be the one ``join`` saw first. ``e``'s own where no rank
    raised (a rank killed by a signal)."""
    failed = []
    for f in Path(tmp).glob("failed*.txt"):
        when, _, why = f.read_text().partition("\n")
        failed.append((float(when), int(f.stem[6:]), why))
    if not failed:
        return e.error_index, str(e)
    return min(failed)[1:]


def _rank(rank: int, target: str, n: int, port: int, device: str,
          backend: str, kwargs: bytes, tmp: str, threads: int,
          paths: List[str]) -> None:
    import torch

    from . import initialize, shutdown

    torch.set_num_threads(threads)
    sys.path[:0] = paths
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    store = dist.TCPStore("127.0.0.1", port, n, is_master=False)
    initialize(None, n, rank, backend=backend, device=device, store=store)
    try:
        out = fn(**pickle.loads(kwargs))
    except BaseException:
        (Path(tmp) / f"failed{rank}.txt").write_text(
            f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    shutdown()
    (Path(tmp) / f"result{rank}.pkl").write_bytes(pickle.dumps(out))
