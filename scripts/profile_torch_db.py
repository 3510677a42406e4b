"""Where the DB detector's forward spends the card's time.

    python3 scripts/profile_torch_db.py [--reps 5] [--out F]

For each canvas bucket of the committed pages (576², 704×576, 704², 960²)
at batch 1 and 8, runs ``DBDetector.forward_wire`` (upload, normalize,
``DBNet`` in float32 with TF32 off, u16 quantization) under
``torch.profiler`` with cuDNN's own algorithm choice and with
``torch.backends.cudnn.benchmark`` (the fastest algorithm measured per
shape), and prints the host ms a call, the device's busy ms a call (the sum
of device-side events) and the kernels that take the most device time,
with the card's name and power limit; the table goes to ``--out`` as JSON
(default ``output/profile_torch_db.json``). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kiri_tpu_torch.detect.db import DBDetector
    from kiri_tpu_torch.ops.preprocess import invert_if_dark, to_gray
    from kiri_tpu_torch.smoke import load_smoke_pages

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path,
                    default=REPO / "output" / "profile_torch_db.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_db: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    db = DBDetector(str(REPO / "models" / "detector.safetensors"))
    canvases = {}
    for p in load_smoke_pages()["pages"]:
        c = db._resize_image(invert_if_dark(to_gray(p["image"])))[0]
        canvases.setdefault(c.shape, c)
    report = {"device": card, "reps": args.reps, "runs": []}
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        for shape, c in sorted(canvases.items()):
            for nb in (1, 8):
                x = np.stack([c] * nb)
                for _ in range(3):
                    db.forward_wire(x).cpu()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    db.forward_wire(x).cpu()
                host = (time.perf_counter() - t0) * 1e3 / args.reps
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.reps):
                        db.forward_wire(x).cpu()
                    torch.cuda.synchronize()
                kernels = {}
                for e in prof.events():
                    if e.device_type == torch.autograd.DeviceType.CUDA:
                        kernels[e.name] = (kernels.get(e.name, 0.0)
                                           + e.time_range.elapsed_us() / 1e3
                                           / args.reps)
                busy = sum(kernels.values())
                top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
                report["runs"].append({
                    "cudnn_benchmark": benchmark, "canvas": list(shape),
                    "batch": nb, "host_ms": host, "device_busy_ms": busy,
                    "top_kernels_ms": dict(top)})
                print(f"benchmark={benchmark} {shape[0]}x{shape[1]} batch "
                      f"{nb}: host {host:.3f} ms a call, device busy "
                      f"{busy:.3f} ms ({card})", flush=True)
                for k, v in top:
                    print(f"    {v:8.3f} ms  {k[:110]}")
    print(card)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
