"""Where a recognizer training step spends the card's time.

    python3 scripts/profile_torch_train.py [--reps 5] [--batch 64] [--out F]

Warm-starts ``Trainer`` from ``models/model.safetensors`` (bf16, dropout
0.15, as the checkpoint trained) and runs ``run_step`` on a ``collate``
batch of the committed smoke lines (48 x 640) under ``torch.profiler``:
prints the host ms a step, the device's busy ms a step (the sum of
device-side events), the device operations a step, and the kernels that
take the most device time, with the card's name and power limit; the table
goes to ``--out`` as JSON (default ``output/profile_torch_train.json``).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kiri_tpu_torch.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu_torch.smoke import load_smoke_lines
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train.trainer import TrainConfig, Trainer, collate

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", type=Path,
                    default=REPO / "output" / "profile_torch_train.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ckpt = REPO / "models" / "model.safetensors"
    model, cfg, meta = load_checkpoint(ckpt, device="cuda")
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""),
                                        str(ckpt)), cfg)
    d, _ = load_smoke_lines()
    n = len(d["imgs"])
    samples = [{"image": d["imgs"][i % n], "text": str(d["texts"][i % n])}
               for i in range(args.batch)]
    batch = collate(samples, tok, 512, img_hw=(cfg.IMG_H, cfg.IMG_W))
    tr = Trainer(cfg, tok, TrainConfig(lr=1e-5), model=model, device="cuda")
    for _ in range(3):
        tr.run_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        tr.run_step(batch)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / args.reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.reps):
            tr.run_step(batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / args.reps
        by_name[e.name][1] += 1
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    report = {"device": card, "batch": args.batch, "dtype": cfg.COMPUTE_DTYPE,
              "reps": args.reps, "host_ms_step": host,
              "device_busy_ms_step": busy,
              "device_ops_step": len(dev) / args.reps,
              "top": [{"name": k, "ms_step": v[0],
                       "calls_step": v[1] / args.reps} for k, v in top]}
    print(f"train step (bf16, batch {args.batch}, 48x640; {card}): "
          f"{host:.2f} ms host, device busy {busy:.2f} ms "
          f"({100 * busy / host:.1f}%), {len(dev) / args.reps:.0f} device "
          "operations a step")
    for row in report["top"]:
        print(f"  {row['ms_step']:8.3f} ms  {row['calls_step']:6.1f}x  "
              f"{row['name'][:110]}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
