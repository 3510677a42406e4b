"""Where the time goes in kiri_tpu_torch's CTC fast path on one GPU.

    python3 scripts/profile_torch_ctc.py [--batch 128] [--reps 10] [--out F]

Drives ``RecognizerEngine.recognize_batch(imgs, "ctc", widths)`` (bf16, the
committed checkpoint, the committed smoke lines repeated to ``--batch``
lines) and ``recognize_crops``, and reports for each:

* the host-clock time per call (texts fetched, so the device has finished);
* under ``torch.profiler``, the device time summed by kernel name and the
  device's busy share of the wall time (the rest is the device idling on the
  host: Python, uploads, launches, text decoding).

Writes the full table as JSON to ``--out`` (default
``output/profile_torch_ctc.json``) and prints a summary. Needs a CUDA
device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path,
                    default=REPO / "output" / "profile_torch_ctc.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_ctc: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from kiri_tpu_torch.engine import RecognizerEngine
    from kiri_tpu_torch.smoke import load_smoke_lines

    eng = RecognizerEngine.from_checkpoint(
        str(REPO / "models" / "model.safetensors"), device="cuda")
    d, crops = load_smoke_lines()
    idx = np.arange(args.batch) % len(d["imgs"])
    imgs, widths = d["imgs"][idx], d["widths"][idx]
    crops = [crops[i] for i in idx]
    paths = {
        "recognize_batch": lambda: eng.recognize_batch(imgs, "ctc", widths),
        "recognize_crops": lambda: eng.recognize_crops(crops, "ctc"),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = {"device": smi, "batch": args.batch, "reps": args.reps,
              "paths": {}}
    for name, fn in paths.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        host_ms = (time.perf_counter() - t0) / args.reps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels, copies, memsets): host ops also
        # carry their children's device time, which would count it twice.
        kernels = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                     + evt.time_range.elapsed_us() / 1e3
                                     / args.reps)
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])
        # The port's own kernels, by the names in csrc/*.cu.
        stem = sum(v for k, v in kernels.items()
                   if "stem_layer_kernel" in k or "stem_conv01_kernel" in k
                   or "conv3x3_silu_kernel" in k)
        pre = sum(v for k, v in kernels.items()
                  if "preprocess_lines_kernel" in k)
        report["paths"][name] = {
            "host_ms_per_call": host_ms,
            "lines_per_s": args.batch / host_ms * 1e3,
            "profiled_wall_ms_per_call": wall_ms / args.reps,
            "device_busy_ms_per_call": busy,
            "device_busy_share": busy / (wall_ms / args.reps),
            "stem_kernels_ms_per_call": stem,
            "preprocess_kernel_ms_per_call": pre,
            "device_ms_by_kernel": dict(top),
        }
        print(f"{name}: {host_ms:.2f} ms/call ({args.batch / host_ms * 1e3:.1f}"
              f" lines/s); device busy {busy:.2f} ms of "
              f"{wall_ms / args.reps:.2f} ms profiled "
              f"({100 * busy / (wall_ms / args.reps):.1f}%); stem kernels "
              f"{stem:.3f} ms, preprocess kernel {pre:.3f} ms")
        for k, v in top[:8]:
            print(f"    {v:8.3f} ms  {k[:100]}")
    print(smi)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
