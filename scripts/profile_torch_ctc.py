"""Where the time goes in kiri_tpu_torch's recognition paths on one GPU.

    python3 scripts/profile_torch_ctc.py [--method ctc|decoder|beam|auto]
        [--batch 128] [--reps 10] [--stream W] [--out F]

Drives ``RecognizerEngine.recognize_batch(imgs, method, widths)`` (bf16, the
committed checkpoint, the committed smoke lines repeated to ``--batch``
lines) and ``recognize_crops(crops, method)`` or, with ``--stream W``,
``stream_records_batch(imgs, method)`` one-shot and with ``window=W`` (every
record read), and reports for each:

* the host-clock time per call (texts fetched, so the device has finished);
* under ``torch.profiler``, the device time summed by kernel name, the
  number of device operations (kernels, copies, memsets) per call, and the
  device's busy share of the wall time (the rest is the device idling on the
  host: Python, uploads, launches, text decoding);
* for the decoder paths, in a pass of its own, the time per call inside
  ``spec_decode`` (and how many rounds it took), inside ``beam_search`` and
  its step loop (and how many steps), and inside ``ctc_alignment_scores``
  as called from either: host clock with the device synchronized at both
  ends of each section, so a section's time is what it costs alone and the
  sections do not overlap as they may in a plain call. With ``--method
  auto`` the threshold is the smoke fixture's raised one, under which 25 of
  64 lines escalate (the default escalates none of the smoke lines).

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
    ap.add_argument("--method", default="ctc",
                    choices=("ctc", "decoder", "beam", "auto"))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--stream", type=int, default=None, metavar="W",
                    help="profile streaming, one-shot and in windows of W")
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
    from kiri_tpu_torch.ops import decode as D
    from kiri_tpu_torch.smoke import load_smoke_lines

    eng = RecognizerEngine.from_checkpoint(
        str(REPO / "models" / "model.safetensors"), device="cuda")
    d, crops = load_smoke_lines()
    method = args.method
    if method == "auto":
        eng = RecognizerEngine(eng.model, eng.cfg.replace(
            AUTO_CONF_THRESHOLD=float(d["auto_escalate_threshold"])),
            eng.tok, device="cuda")
    idx = np.arange(args.batch) % len(d["imgs"])
    imgs, widths = d["imgs"][idx], d["widths"][idx]
    crops = [crops[i] for i in idx]
    paths = {
        "recognize_batch": lambda: eng.recognize_batch(imgs, method, widths),
        "recognize_crops": lambda: eng.recognize_crops(crops, method),
    }
    if args.stream:
        def stream(w):
            return lambda: [list(r) for r in eng.stream_records_batch(
                imgs, method, window=w)]
        paths = {"stream_records_batch": stream(None),
                 f"stream_records_batch window={args.stream}":
                     stream(args.stream)}

    # Sections of the decoder paths: [ms, calls], summed over a pass.
    sections = {}
    outer = []

    def section(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outer.append(name)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                outer.pop()
                key = ".".join(outer + [name])
                acc = sections.setdefault(key, [0.0, 0])
                acc[0] += (time.perf_counter() - t0) * 1e3
                acc[1] += 1
        return timed

    def sections_pass(fn):
        """One pass of ``reps`` calls with the sections timed; the module's
        functions are patched for the pass only."""
        names = ("spec_decode", "beam_search", "_beam_step",
                 "ctc_alignment_scores", "greedy_decode",
                 "beam_stream_window", "greedy_stream_window")
        saved = {n: getattr(D, n) for n in names}
        heads = eng.model.decoder_forward_heads
        sections.clear()
        try:
            for n in names:
                setattr(D, n, section(n, saved[n]))
            eng.model.decoder_forward_heads = section(
                "decoder_forward_heads", heads)
            for _ in range(args.reps):
                fn()
        finally:
            for n in names:
                setattr(D, n, saved[n])
            del eng.model.decoder_forward_heads
        return {k: {"ms_per_call": v[0] / args.reps,
                    "times_per_call": v[1] / args.reps}
                for k, v in sorted(sections.items())}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = {"device": smi, "method": method, "batch": args.batch,
              "reps": args.reps, "stream": args.stream, "paths": {}}
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
        kernels, n_ops = {}, 0
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                n_ops += 1
                kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                     + evt.time_range.elapsed_us() / 1e3
                                     / args.reps)
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])
        # The port's own kernels, by the names in csrc/*.cu.
        stem = sum(v for k, v in kernels.items()
                   if "stem_layer_kernel" in k or "stem_conv01_kernel" in k
                   or "stem_f32_layer_kernel" in k
                   or "stem_f32_conv01_kernel" in k)
        pre = sum(v for k, v in kernels.items()
                  if "preprocess_lines_kernel" in k)
        report["paths"][name] = {
            "host_ms_per_call": host_ms,
            "lines_per_s": args.batch / host_ms * 1e3,
            "profiled_wall_ms_per_call": wall_ms / args.reps,
            "device_busy_ms_per_call": busy,
            "device_busy_share": busy / (wall_ms / args.reps),
            "device_ops_per_call": n_ops / args.reps,
            "sections": sections_pass(fn) if method != "ctc" else {},
            "stem_kernels_ms_per_call": stem,
            "preprocess_kernel_ms_per_call": pre,
            "device_ms_by_kernel": dict(top),
        }
        print(f"{method} {name}: {host_ms:.2f} ms/call ({args.batch / host_ms * 1e3:.1f}"
              f" lines/s); device busy {busy:.2f} ms of "
              f"{wall_ms / args.reps:.2f} ms profiled "
              f"({100 * busy / (wall_ms / args.reps):.1f}%), "
              f"{n_ops / args.reps:.0f} device operations per call; stem "
              f"kernels {stem:.3f} ms, preprocess kernel {pre:.3f} ms")
        for k, v in top[:8]:
            print(f"    {v:8.3f} ms  {k[:100]}")
        for k, v in report["paths"][name]["sections"].items():
            print(f"    section {k}: {v['ms_per_call']:.2f} ms per call in "
                  f"{v['times_per_call']:.1f} calls")
    print(smi)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
