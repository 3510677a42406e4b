#!/usr/bin/env python3
"""Smoke run of ``kiri_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from ``kiri_tpu_torch/kernels/csrc`` (one nvcc per
   source, in parallel) into ``build/kiri_tpu_torch/``;
2. holds each kernel against its plain torch version on the card at the
   shapes of the main path, and times kernel, plain version and (for the
   stem) the cuDNN convolutions as a yardstick;
3. drives the main path — ``RecognizerEngine.recognize_batch(imgs, "ctc",
   widths)`` and ``recognize_crops(crops, "ctc")`` with the committed
   checkpoint over the committed smoke lines — with the launch counters set
   to 0 just before, and checks that both kernels ran, that bfloat16 (the
   checkpoint's dtype) reads each script with CER <= 0.02, and that float32
   gives the JAX package's stored texts line for line;
4. prints the card's name and power limit, one ``{"kernels": [...]}`` line,
   and as its last line ``{"ok": true, "device": {...}}``.

Any failed phase exits with code 1 and prints no result line. The script
needs the rest of the repository beside it and a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import unicodedata
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published H100 SXM peaks (dense), used for the bounds.
PEAK_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_F32 = 67e12          # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12      # B/s, HBM3

TOL_STEM_F32 = 1e-4       # summation order only (TF32 off)
# bf16: kernel and plain version round each layer's output to bf16 from
# float32 sums taken in different orders; a flipped rounding moves a value
# by one bf16 ulp (2^-8 relative) and later layers carry it on.
TOL_STEM_BF16_REL = 2.0 ** -5
TOL_PRE = 2e-3            # normalized units; ~0.26 of a u8 grey level
CER_MAX = 0.02            # tests/test_ckpt_regression.py, "ctc" row
BATCH = 128
WIDTHS = (160, 320, 480, 640)

failures = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        failures.append(what)


def lev(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for x, ca in enumerate(a, 1):
        cur = [x]
        for y, cb in enumerate(b, 1):
            cur.append(min(prev[y] + 1, cur[y - 1] + 1,
                           prev[y - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def cer(pairs) -> float:
    nfc = lambda s: unicodedata.normalize("NFC", s)  # noqa: E731
    return sum(lev(nfc(t), nfc(o)) / max(1, len(t)) for t, o in pairs) / max(
        1, len(pairs))


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def stem_phase(torch, np, model, imgs):
    """Stem kernel vs plain at B=128 and every width bucket; times at 640."""
    from kiri_tpu_torch.kernels.stem import (STRIDES, fold_stem_weights,
                                             stem_fused, stem_plain)
    from kiri_tpu_torch.ops.preprocess import normalize_u8

    F = torch.nn.functional
    u8 = torch.from_numpy(np.resize(imgs, (BATCH,) + imgs.shape[1:])).cuda()
    errs, errs_bf16 = {}, {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            folded = fold_stem_weights(model.stem.net, dtype)
            for w in WIDTHS:
                x = normalize_u8(u8[:, :, :w].contiguous(), dtype)
                got = stem_fused(x, folded).float()
                want = stem_plain(x, folded).float()
                assert got.shape == (BATCH, 6, w // 4, folded[-2].shape[1])
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                if dtype == torch.float32:
                    errs[w] = err
                    check(err <= TOL_STEM_F32 and bool(got.isfinite().all()),
                          f"stem f32 W={w}: max |kernel-plain| {err:.3e} "
                          f"(tol {TOL_STEM_F32:g}, scale {scale:.3f})")
                else:
                    errs_bf16[w] = err
                    check(err <= TOL_STEM_BF16_REL * max(1.0, scale)
                          and bool(got.isfinite().all()),
                          f"stem bf16 W={w}: max |kernel-plain| {err:.3e} "
                          f"(tol {TOL_STEM_BF16_REL:g} x max(1, scale "
                          f"{scale:.3f}))")
        x = normalize_u8(u8, torch.bfloat16)
        folded = fold_stem_weights(model.stem.net, torch.bfloat16)
        ms = time_ms(torch, lambda: stem_fused(x, folded))
        plain_ms = time_ms(torch, lambda: stem_plain(x, folded), iters=5)
        # Yardstick: cuDNN convolutions with bias and SiLU, bf16 NCHW.
        lib_w = []
        for i in range(4):
            wk, b = folded[2 * i], folded[2 * i + 1]
            cin, cout = wk.shape[0] // 9, wk.shape[1]
            lib_w.append((wk.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                          .to(torch.bfloat16).contiguous(),
                          b.to(torch.bfloat16)))

        def library():
            h = x.unsqueeze(1)
            for (wk, b), s in zip(lib_w, STRIDES):
                h = F.silu(F.conv2d(h, wk, b, stride=s, padding=1))
            return h

        library_ms = time_ms(torch, library)
    # Bound at B=128, W=640: conv0 in float32, convs 1-3 in bf16.
    h, w, cin, flops0, flops = 48, 640, 1, 0.0, 0.0
    out_bytes = 0
    for i, (sh, sw) in enumerate(STRIDES):
        cout = folded[2 * i].shape[1]
        h, w = (h - 1) // sh + 1, (w - 1) // sw + 1
        f = 2.0 * BATCH * h * w * cout * 9 * cin
        flops0, flops = (flops0 + f, flops) if i == 0 else (flops0, flops + f)
        cin = cout
        out_bytes = BATCH * h * w * cout * 2
    in_bytes = BATCH * 48 * 640 * 2 + sum(t.numel() * t.element_size()
                                          for t in folded)
    ops_ms = (flops0 / PEAK_F32 + flops / PEAK_BF16) * 1e3
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    print(f"stem bound: {flops0 / 1e9:.2f} GFLOP f32 + {flops / 1e9:.1f} "
          f"GFLOP bf16 -> {ops_ms:.4f} ms; {(in_bytes + out_bytes) / 1e6:.1f}"
          f" MB -> {bytes_ms:.4f} ms", flush=True)
    return {
        "name": "stem_fused", "route": "cuda",
        "source": "kiri_tpu_torch/kernels/csrc/stem_conv.cu",
        "replaces": "kiri_tpu/kernels/stem.py:233",
        "launches": 0, "max_abs_err": max(errs.values()),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
        "shape": f"x bf16 [{BATCH},48,640] -> [{BATCH},6,160,256]",
        "max_abs_err_bf16": max(errs_bf16.values()),
        "tolerance": f"f32 {TOL_STEM_F32:g} (TF32 off); bf16 "
                     f"{TOL_STEM_BF16_REL:g} x max(1, max |plain|)",
    }


def preprocess_phase(torch, np, crops):
    """Preprocess kernel vs plain on (a) the main path's input, the smoke
    crops repeated to 128 lines as ``recognize_crops`` packs them, timed;
    (b) 128 edge cases: dark, small (cubic upscale), wide (clipped) and
    linear-flagged variants of the smoke crops."""
    from kiri_tpu_torch.kernels.resize import (pack_crops, preprocess_lines,
                                               preprocess_lines_plain)

    main = [crops[i % len(crops)] for i in range(BATCH)]
    edge = []
    for i, c in enumerate(main):
        if i % 3 == 0:
            edge.append(np.ascontiguousarray(c[::3, ::3]))        # ~11-24 px
        elif i % 3 == 1:
            edge.append(np.ascontiguousarray(np.tile(c, (1, 3))))  # clipped
        else:
            edge.append(np.ascontiguousarray(255 - c))              # dark
    inputs = {}
    for name, batch in (("main path", main), ("edge cases", edge)):
        buf, sizes = pack_crops(batch)
        sizes3 = np.zeros((len(batch), 3), np.int32)
        sizes3[:, :2] = sizes
        if name == "edge cases":
            sizes3[::4, 2] = 1                                   # linear flag
        dbuf = torch.from_numpy(buf).cuda()
        dsizes = torch.from_numpy(sizes3).cuda()
        got = preprocess_lines(dbuf, dsizes, 48, 640)
        want = preprocess_lines_plain(dbuf, dsizes, 48, 640)
        err = float((got - want).abs().max())
        nw = np.clip(np.rint(sizes3[:, 1] * 48
                             / np.maximum(1, sizes3[:, 0])), 1, 640)
        check(err <= TOL_PRE and bool(got.isfinite().all()),
              f"preprocess ({name}): max |kernel-plain| {err:.3e} (tol "
              f"{TOL_PRE:g}) on {len(batch)} crops in [{buf.shape[1]},"
              f"{buf.shape[2]}], {int((sizes3[:, 0] < 48).sum())} upscaled, "
              f"{int((nw >= 640).sum())} clipped, "
              f"{int(sizes3[:, 2].sum())} linear")
        inputs[name] = (dbuf, dsizes, sizes3, err)
    dbuf, dsizes, sizes3, err = inputs["main path"]
    ms = time_ms(torch, lambda: preprocess_lines(dbuf, dsizes, 48, 640))
    plain_ms = time_ms(
        torch, lambda: preprocess_lines_plain(dbuf, dsizes, 48, 640), iters=5)
    # Bound: each valid crop byte read once, sizes read, output written.
    nbytes = (int((sizes3[:, 0] * sizes3[:, 1]).sum()) + sizes3.nbytes
              + BATCH * 48 * 640 * 4)
    return {
        "name": "preprocess_lines", "route": "cuda",
        "source": "kiri_tpu_torch/kernels/csrc/preprocess_lines.cu",
        "replaces": "kiri_tpu/kernels/resize.py:188",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "shape": f"crops u8 [{BATCH},{dbuf.shape[1]},{dbuf.shape[2]}] -> "
                 f"f32 [{BATCH},48,640]",
        "max_abs_err_edge_cases": inputs["edge cases"][3],
        "tolerance": f"{TOL_PRE:g}",
    }


def main_path_phase(torch, np, model, cfg, tok, d, crops):
    """The engine's CTC paths: bf16 with counters, then f32 agreement."""
    from kiri_tpu_torch.engine import RecognizerEngine
    from kiri_tpu_torch.kernels import launch_counts, reset_launch_counts

    imgs, widths = d["imgs"], d["widths"]
    texts = [str(t) for t in d["texts"]]
    is_kh = [any(0x1780 <= ord(c) <= 0x17FF for c in t) for t in texts]
    eng = RecognizerEngine(model, cfg.replace(COMPUTE_DTYPE="bfloat16"), tok,
                           device="cuda")
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = {"batch": eng.recognize_batch(imgs, "ctc", widths),
            "crops": eng.recognize_crops(crops, "ctc")}
    dt = time.perf_counter() - t0
    counts = launch_counts()
    print(f"main path (bf16): {len(imgs)} lines x 2 paths in {dt:.3f} s "
          f"(first call, kernels built); launches {counts}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"main path launched {name} {n} times")
    for path, res in outs.items():
        hyp = [t for t, _ in res]
        kh = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if k])
        en = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if not k])
        agree = sum(a == str(b) for a, b in zip(hyp, d[f"{path}_texts_bf16"]))
        conf = np.asarray([c for _, c in res])
        check(kh <= CER_MAX and en <= CER_MAX and np.isfinite(conf).all(),
              f"bf16 {path}: Khmer CER {kh:.4f}, English CER {en:.4f} "
              f"(max {CER_MAX}); {agree}/{len(hyp)} texts equal kiri_tpu's "
              f"bf16 texts; max |conf diff| "
              f"{np.abs(conf - d[f'{path}_conf_bf16']).max():.2e}")

    with torch.inference_mode():
        memp, ctc, ids, conf, est, n = eng.encode_batch(imgs[:8])
    check(tuple(ctc.shape) == (8, cfg.IMG_W // 4, tok.ctc_classes)
          and tuple(memp.shape) == (8, cfg.IMG_W // 4, cfg.DEC_DIM)
          and bool(ctc.isfinite().all()) and bool(memp.float().isfinite().all()),
          f"encode_batch: ctc {tuple(ctc.shape)}, memp {tuple(memp.shape)}, "
          "finite")

    eng32 = RecognizerEngine(model, cfg.replace(COMPUTE_DTYPE="float32"), tok,
                             device="cuda")
    for path, res in (("batch", eng32.recognize_batch(imgs, "ctc", widths)),
                      ("crops", eng32.recognize_crops(crops, "ctc"))):
        want = [str(t) for t in d[f"{path}_texts_f32"]]
        hyp = [t for t, _ in res]
        diff = [(i, h, w) for i, (h, w) in enumerate(zip(hyp, want)) if h != w]
        dconf = np.abs(np.asarray([c for _, c in res])
                       - d[f"{path}_conf_f32"]).max()
        check(not diff, f"f32 {path}: {len(hyp) - len(diff)}/{len(hyp)} texts "
              f"equal kiri_tpu's f32 texts (max |conf diff| {dconf:.2e})"
              + (f"; first differences {diff[:3]}" if diff else ""))

    # Throughput at batch 128 (the smoke lines twice), width-bucketed.
    idx = np.arange(BATCH) % len(imgs)
    big, bw = imgs[idx], widths[idx]
    for _ in range(2):
        eng.recognize_batch(big, "ctc", bw)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.recognize_batch(big, "ctc", bw)
    dt = (time.perf_counter() - t0) / reps
    print(f"throughput (bf16, batch {BATCH}, width-bucketed, host clock, "
          f"texts fetched): {BATCH / dt:.1f} lines/s ({dt * 1e3:.2f} ms per "
          f"call)", flush=True)
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (REPO / "kiri_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: kiri_tpu_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)

    from kiri_tpu_torch.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu_torch.kernels import build
    from kiri_tpu_torch.smoke import load_smoke_lines
    from kiri_tpu_torch.tokenizer import CharTokenizer

    t0 = time.perf_counter()
    try:
        built = build.build()
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"build: {time.perf_counter() - t0:.1f} s (compiled {built})",
          flush=True)
    for name, log in build.build_logs.items():
        lines = {ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln}
        for line in sorted(lines):
            print(f"  {name} (ptxas): {line}")

    ckpt = REPO / "models" / "model.safetensors"
    model, cfg, meta = load_checkpoint(ckpt, device="cuda")
    tok = CharTokenizer(find_vocab_file(meta.get("vocab_path", ""), str(ckpt)),
                        cfg)
    d, crops = load_smoke_lines()

    kernels = [stem_phase(torch, np, model, d["imgs"]),
               preprocess_phase(torch, np, crops)]
    counts = main_path_phase(torch, np, model, cfg, tok, d, crops)
    for k in kernels:
        k["launches"] = counts[k["name"]]

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
              else f"nvidia-smi failed: {smi.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"nvidia-smi failed: {e}")
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
