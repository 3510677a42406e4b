"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The cell (``BENCHMARK.json``) names its configuration
(``gpubench/configs/<config>.json``) and its traffic mix
(``gpubench/traffic/mixes/<traffic>.json``); ``gpubench/workloads/<cell>.json``
holds the cell's check. The run builds the system once, makes the pool of
inputs from the seed, warms up every call the window will make, then calls
back to back for ``--seconds``. With ``--trace 0`` it reports the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read by
``gpubench/metrics/<metric>.py`` from the untraced calls and from a
profiled slice of the window. After the window the served answers of a
seeded sample are held to the plain reference (``gpubench/reference``):
each compared number with its limit is printed last on standard error and
last in the result line.

It exits non-zero and prints no result where no card is present, where the
cell's chips are missing, or where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start on ``time.time()``'s clock (Linux), or now."""
    try:
        with open(f"/proc/{os.getpid()}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The harness's own modules, then the program at the checkout's root.
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kiri_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def pin_host_threads(mix) -> int:
    """The mix's ``host_threads``, if it names them, as the size of the
    thread pools of OpenMP, MKL and OpenBLAS: set before torch or NumPy is
    imported, since each reads it when it starts its pool. 0 where the mix
    leaves the program's default."""
    n = int(mix.get("host_threads", 0))
    if n:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                    "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(n)
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec

    cell = spec.load_cell(args.workload)
    threads = pin_host_threads(cell["mix"])

    import torch

    from harness.cell import run_cell

    if threads:
        torch.set_num_threads(threads)
    if not torch.cuda.is_available():
        print("gpubench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"gpubench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", start=START)
    bad = loaded_forbidden()
    if bad:
        print(f"gpubench: modules loaded that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
