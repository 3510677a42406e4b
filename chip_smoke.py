#!/usr/bin/env python3
"""Smoke run of ``kiri_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from ``kiri_tpu_torch/kernels/csrc`` (one nvcc per
   source, in parallel) into ``build/kiri_tpu_torch/``;
2. holds each kernel against its plain torch version on the card at the
   shapes of the main path: the bf16 tensor-core stem and the float32
   (3xTF32) stem at every width bucket, at a ragged batch and widths, and
   on their edge rows and columns alone, the preprocess kernel on the main
   path's input, on edge cases and on extreme shapes; and times kernel,
   plain version and (for both stems, as a whole and launch by launch) the
   cuDNN convolutions as a yardstick;
3. drives the main paths with the committed checkpoint over the committed
   smoke lines: ``RecognizerEngine.recognize_batch(imgs, m, widths)`` for m
   in "ctc", "decoder", "beam", "auto" (the last also under a threshold that
   escalates 25 of the 64 lines) and ``recognize_crops(crops, m)`` for "ctc"
   and "decoder", in bfloat16 (the checkpoint's dtype) and in float32, each
   run with the launch counters set to 0 just before it. It checks that
   every kernel of a run was launched in it, that bfloat16 reads each script
   with CER <= 0.02 (0.03 for "decoder") and confidences in [0, 1], and that
   float32 gives the JAX package's stored texts line for line and its
   confidences within 1e-3; then "decoder" once more under
   ``SPEC_MAX_ROUNDS=1``, which sends lines through the step-loop fallback,
   against the JAX package's answers for that setting;
4. drives the rest of the engine the same way, each run with the counters
   at 0: ``stream_records_batch(imgs, m)`` one-shot and with ``window=8`` for
   "ctc", "decoder" and "beam", and "auto" (float32 records equal the JAX
   package's stored records, windowed records equal one-shot ones, bfloat16
   final texts within the CER limits); ``recognize_crops(noisy_crops, m,
   enhance=True, sharpen=mask)`` for "ctc" and "decoder" (``enhance_lines``
   on the card gives the CPU's bytes and flags lines for the preprocess
   kernel's linear resize; float32 texts equal the stored ones); and "beam"
   under ``SPEC_BEAM=True`` (the step-loop beam's texts, with LM fusion on,
   where no line certifies, and off, where most do);
5. the int8 phase (``ops/quant8.Q8Encoder``, ``kernels/quant8.py``):
   (a) ``q8_stem01`` (conv0 + conv1) and ``q8_conv3x3`` (conv2, conv3), the
   stem's three launches of ``csrc/q8_stem.cu``, at batch 128 x 48 x 640,
   3 x 48 x 160 and the ragged 2 x 48 x 636 and 1 x 48 x 52, and
   ``q8_linear`` (``csrc/q8_gemm.cu``) on the encoder's four matmul shapes
   at M = 20,480 and 37, in bfloat16 and float32 on calibrated scales: each
   output identical to its plain version's (the epilogues use no FMA, SiLU
   is PyTorch's formula); the peak memory of an int8 forward below conv0's
   output alone;
   (b) float32 on ``kiri_tpu``'s stored scales
   (``kiri_tpu_torch/assets/smoke_q8.npz``, ``convert.q8_scales_from_jax``)
   for ``parts`` {stem}, {stem, attn, ffn} and {attn, ffn}: the greedy CTC
   texts of the 64 smoke lines equal ``kiri_tpu``'s stored texts, and the
   port's own calibration on lines 0-31 within 1e-5 relative of the stored
   scales; (c) bf16 on its own calibration: each set's CER per script
   within 0.02 and its text CER against the port's own bf16 path at most
   max(0.0005, ``kiri_tpu``'s own + 0.0005); (d) each kernel launch by
   launch at the main path's shapes (kernel, plain version, bound from
   1979 TOPS int8 and 3.35 TB/s, the mma.sync kernels' time, cuDNN bf16
   convolution + bias + SiLU and im2col + ``torch._int_mm`` for the convs,
   ``torch._int_mm`` + dequant for the matmuls; the bf16 ``wgmma`` stem
   beside the int8 stem) and encode + CTC at batch 128 for the reference
   path and the three sets, interleaved over 5 rounds (each round's host
   ms, the host's ms to queue a batch, the device's busy ms and its longest
   kernels), with the card's name and power limit; (e) every int8 run
   with the counters at 0, launching ``q8_stem01`` and ``q8_conv3x3``
   (stem sets: 3 launches a forward) and ``q8_linear`` (encoder sets);
6. the pages phase: ``OCR`` on the card with both committed checkpoints
   (``models/model.safetensors``, ``models/detector.safetensors``) over the
   committed pages (``kiri_tpu_torch/assets/smoke_pages.npz``), each run with
   the counters at 0: the DB u16 map of the stored page within 8 counts of
   kiri_tpu's; every page the stored number of line boxes, each within 1 px;
   float32 "fast" and "accurate" (and "fast" with ``preprocess="device"``,
   which launches the preprocess kernel, and with ``enhance=True`` on the
   noisy page) texts equal kiri_tpu's stored texts on identical boxes,
   confidences within 1e-3; the pooled ``process_documents`` equal to the
   per-page results; bf16 line CER per script within the gates (or, where
   kiri_tpu's own stored answers read the pages worse, no worse than them by
   more than 0.005), with ``end2end_cer`` and ``doc_cer``; the 64 smoke
   crops through the cv2-free host preprocessing against the committed
   lines; then pages/s of ``process_documents`` (32 pages), the p50 of
   ``extract_text``, ms per stage, the detection split, the DB forward per
   canvas bucket and the device's busy share of a page, each with the
   card's name and power limit;
7. the rotated-pages phase, with ``models/craft.safetensors`` too, over
   the committed pages and their three rotated pages (each run with the
   counters at 0): CRAFT's float16 region and affinity maps of two stored
   pages within 2 float16 steps of kiri_tpu's, its quads on all twelve
   pages, ``TextDetector("craft")``'s boxes and one page's ``poly=True``
   outlines equal to the stored ones; DB and CRAFT with ``deskew=True``:
   each rotated page's applied angle, boxes and upright boxes equal to the
   stored ones; float32 "fast" and "accurate" texts equal kiri_tpu's
   stored texts on identical boxes for DB + deskew with
   ``deskew_single_resample`` on and off, "fast" with
   ``preprocess="device"`` (the preprocess kernel on single-resample crops)
   and with ``enhance=True`` on the noisy rotated page, CRAFT on all pages
   and CRAFT + deskew; the pooled ``process_documents`` equal to the
   per-page results; bf16 line CER per script within the gates (or
   kiri_tpu's own + 0.005); the rotated pages' line recall and CER of DB
   with deskew off and on. Then it prints the CRAFT forward per canvas (batch 1
   and 8, device ms, peak memory, cuDNN FFT share), the host ms of the
   deskew stages, pages/s of ``process_documents`` for CRAFT and for DB +
   deskew, and the device's busy share of a page;
8. the legacy and word-level phase (each run with the counters at 0): the
   classic-CV detector's lines, words, blocks, characters and
   ``detect_all`` on the thirteen stored pages (the twelve above and a
   tinted colour page), legacy + deskew on the rotated pages and blocks
   over DB lines, all equal to kiri_tpu's stored boxes; float32 "fast"
   texts of ``det_method="legacy"`` and of ``mode="words"`` equal the
   stored texts on identical boxes (confidences within 1e-3), the pooled
   ``process_documents`` equal to the per-page results, a
   ``preprocess="device"`` words run (the preprocess kernel), bf16 legacy
   line CER per script within the gate (or kiri_tpu's own + 0.005);
   ``python -m kiri_tpu_torch.cli predict --no-render --mode words
   --det-method legacy`` on a PNG the port wrote, as a subprocess, equal to
   the in-process ``extract_text``; ``create_report``'s embedded PNG. Then
   the detector's host ms by stage, pages/s of ``process_documents`` for
   legacy lines and for words, and the device's busy share of a page;
9. the training phase (each run with the counters at 0), from the committed
   checkpoints and ``kiri_tpu_torch/assets/smoke_train.npz``: (a) the
   recognizer's float32 step 0 on 32 smoke lines (DROPOUT 0): its loss,
   CTC and CE losses within 1e-4 relative (gradient norm 1e-3) of
   kiri_tpu's stored float64 run of the same step, and the port's float64
   step within 1e-9 of it (kiri_tpu's stored float32 numbers lie ~1.5e-4
   from its own float64 run: float32 sums on the CPU, on a loss of 0.009;
   the port's distance to them is printed); the phase runs under
   PyTorch's default TF32 flags, so the trainers' own float32 scope is what
   keeps TF32 out; (b) ``train_loop`` in bf16 with dropout
   0.15 warm-started from the checkpoint, 30 steps at batch 64 over the 64
   lines: every loss finite, the last five steps' mean below the first
   five's; (c) its saved checkpoint through
   ``RecognizerEngine.from_checkpoint`` reads the lines within the CER
   gates ("ctc" 0.02, "decoder" 0.03); (d) 10 decoder-only steps leave the
   CTC logits bit-identical; (e) a float32 run resumed from its epoch-1
   checkpoint ends where the uninterrupted run ends; (f) ``train_db`` and
   ``train_craft``, 20 steps each warm-started from the committed detectors
   on the fixture's four documents laid out as a ``generate-detector``
   directory: float32 step 0 equal to kiri_tpu's stored loss within 1e-4
   relative, the loss falling, the saved file detecting on a fixture page.
   It prints the trainer's steps/s and lines/s, host ms of ``collate`` and
   of the step, the device's busy share of a step, peak memory, and the
   detector trainers' steps/s;
10. the generators phase, against ``kiri_tpu``'s answers in
   ``kiri_tpu_torch/assets/smoke_gen.npz`` (``scripts/make_torch_smoke_gen.py``),
   with font discovery off (the pseudo-glyph pool, as the fixture was
   drawn), each device run with the counters at 0: (a) 64 augmented lines
   of ``MultilingualDatasetGenerator(khmer_ratio=0.5, sign_boost=0.3)``
   through ``generate_dataset``: every image's digest and ``labels.txt``
   equal; (b) one 640 x 640 document per layout, each under every
   condition and ``rotated+noisy``, one rescaled to 960 x 960: digests,
   lines, texts and chars equal; (c) ``kiri-tpu-torch generate-detector
   --num-train 8 --num-val 2`` through ``cli.main``: every file's digest
   equal; (d) the DB and CRAFT trainers' live pools (batch 8, 640 x 640,
   ``aug_conditions`` 0.5, CRAFT ``scale_aug`` 0.5): both batches' digests
   equal, then ``train_db`` and ``train_craft`` from the committed
   checkpoints, 20 steps with ``pool_size=16``: float32 step 0 within 1e-4
   (relative) of ``kiri_tpu``'s stored loss on the same batch; their
   steps/s from the pool and with ``pool_size=0`` come from two runs of
   different lengths; (e) ``kiri-tpu-torch generate -n 128`` (labels and
   images equal), then ``kiri-tpu-torch train`` on it, 5 epochs of 2
   steps at batch 64 in bf16 from ``models/model.safetensors``, its
   validation through the stem kernel; (f) ``evalpage.eval_condition`` over
   4 pages per condition (clean, rotated, noisy, textured, low contrast,
   inverted) with ``OCR`` on the committed checkpoints: float32 rows equal
   and texts equal on identical boxes, bf16 with ``preprocess="device"``
   the same line recall and CERs within ``kiri_tpu``'s + 0.005. It prints
   lines/s, docs/s and ms per condition on the host, the live trainers'
   steps/s pooled and with ``pool_size=0`` and ``make_batch``'s share of
   a step, and pages/s of ``eval_condition``, each with the card's name
   and power limit;
11. the model-files phase, against ``kiri_tpu``'s answers in
   ``kiri_tpu_torch/assets/smoke_models.npz``
   (``scripts/make_torch_smoke_models.py``), each device run with the
   counters at 0: (a) ``models/model.safetensors`` written as an F16
   ``.safetensors`` with its meta, an F32 one without, the reference's
   ``{"config", "model"}`` ``.pt`` and a bare state-dict ``.pt``; each
   through ``RecognizerEngine.from_checkpoint``: its config equal to
   ``kiri_tpu``'s (the meta-less and ``.pt`` loads infer 4 heads for v13),
   float32 "ctc" and "decoder" texts over the 64 smoke lines equal to
   ``kiri_tpu``'s for that file and confidences within 1e-3, the F16 file in
   bf16 within the CER gate; ``OCR(<the .pt>, preprocess="device")`` in
   float32 "fast" on two pages (the preprocess kernel) against ``kiri_tpu``'s
   stored results; (b) ``KiriOCR.from_checkpoint`` in float32: CTC logits of
   8 lines at 48 x 320 within 1e-3 and its parameter count; (c) the PP-OCR
   DB graph (MobileNetV3-large x0.5, DBFPN(96), the DB head), rebuilt from
   its seed by ``kiri_tpu_torch.smoke.build_ppocr_det`` and held to the
   stored SHA-256, through ``DBDetector(det.onnx)`` on three pages of three
   canvas buckets: u16 maps within 8 counts, quads identical (the stored
   maps keep more than 8 counts from the threshold), the batched path and
   ``TextDetector``'s equal to per page, ``OCR(det_model_path=det.onnx)``'s
   float32 "fast" pages equal to the stored ones; it prints the graph's
   forward per canvas at batch 1 and 8 (host ms and the device's busy ms
   under the profiler) with the peak memory; (d)
   ``corpus_cluster_cer`` of the stored float32 texts equal to
   ``kiri_tpu``'s, and the bf16 Khmer cluster and codepoint CER of "ctc",
   "decoder" and "beam". The Hugging Face hub is not driven (the machine
   has no network; only local paths are passed);
12. the parallel phase (one card: ``kiri_tpu_torch.parallel``): (a) NCCL
   at world size 1 in this process (``parallel.initialize``, an all-reduce
   on the card, ``make_mesh(1, 1)``): ``RecognizerEngine(mesh=)`` gives the
   single-device engine's texts and confidences exactly on the 64 smoke
   lines, bf16 and float32, "ctc" and "decoder" (accurate); (b) two ranks on
   card 0 over gloo (NCCL refuses two ranks on one card), started by
   ``parallel.launch.spawn`` with ``smoke.parallel_rank``: the engine at a
   model axis of 2 (TP), ``recognize_batch`` "ctc" and "decoder" and
   ``recognize_crops`` "ctc", float32 texts equal to the single card's,
   confidences within 1e-4, bf16 within the CER gates; 3 float32 train
   steps at a data axis of 2 (DP) on ``smoke_train.npz``'s 32 lines, the
   losses within 1e-4 of the single card's steps on the same global batch;
   1 step at TP = 2, loss within 1e-5; after each, every weight of each
   rank within atol 1e-5, rtol 1e-4 of the single card's after the same
   steps and of the other rank's; ``save_sharded`` by both ranks (two
   files), ``restore_sharded``
   onto the mesh (each rank's shards back) and ``to_reference`` (equal to
   the TP weights gathered, loaded here); the DB trainer's step at DP = 2
   within 1e-4 of the single card's; (c) each rank's launch counts of the
   engine runs hold both kernels; (d) a local Hugging Face dataset of the
   smoke lines (image folder) through ``load_hf_dataset`` and one train
   step from it, where ``datasets`` imports (a line says so where it does
   not); it prints the phase's wall time and the per-rank ms of a TP-2
   bf16 "ctc" ``recognize_batch`` against the single card, with the card's
   name and power limit;
13. prints one throughput line per method, one line per streamed method with
   the time to the first record one-shot and with ``window=8``, the card's
   name and power limit, one ``{"kernels": [...]}`` line, and as its last
   line ``{"ok": true, "device": {...}}``.

Any failed phase exits with code 1 and prints no result line. The script
needs the rest of the repository beside it and a CUDA device.
"""
from __future__ import annotations

import base64
import functools
import hashlib
import json
import subprocess
import sys
import tempfile
import time
import unicodedata
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published H100 SXM peaks (dense), used for the bounds.
PEAK_BF16 = 989e12        # FLOP/s, tensor cores
PEAK_F32 = 67e12          # FLOP/s, CUDA cores
PEAK_TF32 = 495e12        # FLOP/s, tensor cores
PEAK_INT8 = 1979e12       # OP/s, tensor cores
F32X3_PASSES = 3          # TF32 products a float32 one takes (3xTF32)
PEAK_BYTES = 3.35e12      # B/s, HBM3

# float32 (TF32 off in the plain version): summation order, and the
# dropped a_lo * w_lo term of 3xTF32 (~2^-22 of a product).
TOL_STEM_F32 = 1e-4
# bf16: kernel and plain version round each layer's output to bf16 from
# float32 sums taken in different orders; a flipped rounding moves a value
# by one bf16 ulp (2^-8 relative) and later layers carry it on.
TOL_STEM_BF16_REL = 2.0 ** -5
# ... and each element on its own: 2 bf16 ulps of its value plus as much of
# 1, so that a fault in small values (an edge that is off by a fraction of
# the output scale) does not pass under the scale of the largest.
TOL_STEM_BF16_ELEM = 2.0 ** -6
TOL_PRE = 2e-3            # normalized units; ~0.26 of a u8 grey level
# The port's float32 calibration against kiri_tpu's stored scales: channel
# and tensor abs-maxes after float32 sums taken in another order.
TOL_Q8_CALIB = 1e-5
Q8_TEXT_CER = 0.0005      # int8 against bf16 texts, tests/test_quant8.py
ROUNDS = 5                # interleaved rounds of the int8 encode + CTC timing
# The times of the int8 kernels' first, mma.sync version (conv0 a launch of
# its own; PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's in the phase's lines, not in the kernels line.
MMA_SYNC_Q8_MS = {"conv0": 0.5002, "conv1": 0.5833, "conv2": 0.4698,
              "conv3": 0.5836, "stem": 2.1370, "qkv": 0.0814, "wo": 0.0294,
              "lin1": 0.1001, "lin2": 0.0796}
CER_MAX = 0.02            # tests/test_ckpt_regression.py, "ctc" and "beam"
CER_MAX_DECODER = 0.03    # ... and its "decoder" row
TOL_CONF_F32 = 1e-3       # float32 confidences against kiri_tpu's
STREAM_WINDOW = 8
PAGE_MAP_TOL = 8          # u16 counts of the DB map (1.2e-4)
PAGE_BOX_TOL = 1          # px, a line box against kiri_tpu's
PAGES_TIMED = 32          # pages of a timed process_documents call
PAGE_CER_SLACK = 0.005    # bf16 page line CER above kiri_tpu's own
CRAFT_MAP_STEPS = 2       # float16 steps of a CRAFT map value
STREAM_WINDOWS_TIMED = (1, 4, 8, 16, 32)
WORDS_DEVICE_MAX = 200    # words of a page for the device-preprocess run
TOL_TRAIN_STEP0 = 1e-4    # float32 step-0 losses against kiri_tpu's, relative
TOL_TRAIN_GRAD_NORM = 1e-3
# float64 step-0 numbers against kiri_tpu's float64 run: ~1e-13 apart on the
# CPU; float32 effects are 1e-5 and more.
TOL_TRAIN_F64 = 1e-9
TOL_TRAIN_RESUME = 1e-5   # resumed against uninterrupted weights, of scale
TRAIN_LR = 5e-5           # warm-started fine-tunes of the smoke phase
TOL_PAR_CONF = 1e-4       # float32 confidences, TP engine against one card
TOL_PAR_DP = 1e-4         # DP losses against one card (tests/test_sharding.py)
TOL_PAR_TP = 1e-5         # TP loss against one card
TOL_PAR_DB = 1e-4         # the DB trainer's DP loss, relative
TRAIN_BATCH = 64
TRAIN_REPEAT = 6          # the 64 lines six times: 6 steps an epoch
TRAIN_EPOCHS = 5
DET_STEPS = 20
GEN_TIMED_STEPS = 10      # live-pool steps/s: 2N steps less N steps
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
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events. The
    calls are queued behind a few milliseconds of other work on the stream,
    so that a kernel shorter than the host's time to launch it is timed at
    the device's pace and not at the host's."""
    spin = torch.zeros((8192, 8192), dtype=torch.bfloat16, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.mm(spin, spin)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _stem_convs(folded, batch, h, w):
    """Per conv of the stem on [batch, h, w] lines: its FLOP, the values it
    reads and writes, and the bytes of its weights and bias."""
    convs, cin, n_in = [], 1, batch * h * w
    for i, (sh, sw) in enumerate(((1, 1), (2, 2), (2, 2), (2, 1))):
        wk, b = folded[2 * i], folded[2 * i + 1]
        h, w = (h - 1) // sh + 1, (w - 1) // sw + 1
        n_out = batch * h * w * wk.shape[1]
        convs.append({"flop": 2.0 * n_out * 9 * cin, "n_in": n_in,
                      "n_out": n_out, "conv0": i == 0,
                      "w_bytes": (wk.numel() * wk.element_size()
                                  + b.numel() * b.element_size())})
        cin, n_in = wk.shape[1], n_out
    return convs


def _bound_ms(convs, in_size, peak_convs, passes=1):
    """(ops_ms, bytes_ms) of consecutive convs run as one function: conv0 at
    the float32 rate, the others ``passes`` times at ``peak_convs``; the
    first one's input, the weights and the last one's output moved once."""
    ops = sum(c["flop"] / PEAK_F32 if c["conv0"]
              else passes * c["flop"] / peak_convs for c in convs)
    nbytes = ((convs[0]["n_in"] + convs[-1]["n_out"]) * in_size
              + sum(c["w_bytes"] for c in convs))
    return ops * 1e3, nbytes / PEAK_BYTES * 1e3


def stem_phase(torch, np, model, imgs):
    """Both stem kernels vs plain at B=128 and every width bucket, at a
    ragged batch and widths and on their edges alone; times at width 640, as
    a whole and launch by launch. Returns the bf16 and the float32 kernel's
    entries."""
    from kiri_tpu_torch.kernels.stem import (STRIDES, stem_fused,
                                             stem_fused_f32, stem_mma_layer,
                                             stem_plain)
    from kiri_tpu_torch.ops.preprocess import normalize_u8

    F = torch.nn.functional
    u8 = torch.from_numpy(np.resize(imgs, (BATCH,) + imgs.shape[1:])).cuda()
    errs, errs_bf16 = {}, {}
    # The width buckets at the full batch, then ragged cases (a batch that is
    # no bucket size, widths that are no multiple of a tile).
    cases = [(BATCH, w) for w in WIDTHS] + [(5, 52), (3, 636)]
    edges = (("top row", (slice(None), 0)),
             ("bottom row", (slice(None), -1)),
             ("left column", (slice(None), slice(None), 0)),
             ("right column", (slice(None), slice(None), -1)))

    def bf16_check(got, want, scale, what):
        """Holds ``got`` to both bf16 tolerances; returns its max error."""
        diff = (got - want).abs()
        err = float(diff.max())
        # The worst element's error as a share of its own limit.
        share = float((diff / (TOL_STEM_BF16_ELEM * (want.abs() + 1.0))).max())
        check(err <= TOL_STEM_BF16_REL * max(1.0, scale) and share <= 1.0
              and bool(got.isfinite().all()),
              f"stem bf16 {what}: max |kernel-plain| {err:.3e} (tol "
              f"{TOL_STEM_BF16_REL:g} x max(1, scale {scale:.3f})); worst "
              f"element at {share:.3f} of its own {TOL_STEM_BF16_ELEM:g} x "
              f"(|plain| + 1)")
        return err

    def f32_check(got, want, what):
        """Holds ``got`` to TOL_STEM_F32; returns its max error."""
        err = float((got - want).abs().max())
        check(err <= TOL_STEM_F32 and bool(got.isfinite().all()),
              f"stem f32 {what}: max |kernel-plain| {err:.3e} (tol "
              f"{TOL_STEM_F32:g}, scale {float(want.abs().max()):.3f})")
        return err

    with torch.inference_mode():
        folded32 = model.stem.folded(torch.float32)
        folded16 = model.stem.folded(torch.bfloat16)
        for n, w in cases:
            x = normalize_u8(u8[:n, :, :w].contiguous(), torch.float32)
            got = stem_fused_f32(x, folded32)
            want = stem_plain(x, folded32)
            assert got.shape == want.shape == (n, 6, (w - 1) // 4 + 1, 256)
            errs[(n, w)] = f32_check(got, want, f"B={n} W={w}")
            for name, sel in edges:
                f32_check(got[sel], want[sel], f"B={n} W={w} {name}")
        for n, w in cases:
            x = normalize_u8(u8[:n, :, :w].contiguous(), torch.bfloat16)
            got = stem_fused(x, folded16).float()
            want = stem_plain(x, folded16).float()
            assert got.shape == want.shape == (n, 6, (w - 1) // 4 + 1, 256)
            scale = float(want.abs().max())
            errs_bf16[(n, w)] = bf16_check(got, want, scale, f"B={n} W={w}")
            # The edges alone, so that an edge fault is named as one.
            for name, sel in edges:
                bf16_check(got[sel], want[sel], scale, f"B={n} W={w} {name}")

        def library_convs(x, folded, dtype):
            """Yardstick: per conv, the cuDNN convolution with bias and SiLU
            (NCHW) on that conv's own input."""
            convs, h = [], x.unsqueeze(1)
            for i, s in enumerate(STRIDES):
                wk, b = folded[2 * i], folded[2 * i + 1].to(dtype)
                cin, cout = wk.shape[0] // 9, wk.shape[1]
                wk = (wk.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
                      .to(dtype).contiguous())

                def conv(h=h, wk=wk, b=b, s=s):
                    return F.silu(F.conv2d(h, wk, b, stride=s, padding=1))
                convs.append(conv)
                h = conv()
            return convs

        def run_all(fns):
            return lambda: [fn() for fn in fns]

        def per_launch(x, folded, lib, size, peak, passes):
            """Launch by launch: conv0+conv1, conv2, conv3, each on its own
            input: kernel ms, cuDNN ms of the same convs, bound ms."""
            convs, out, h = _stem_convs(folded, BATCH, 48, 640), {}, x
            for layer, which in ((1, (0, 1)), (2, (2,)), (3, (3,))):
                ops, byt = _bound_ms([convs[i] for i in which], size, peak,
                                     passes)
                out["conv" + "+".join(map(str, which))] = {
                    "ms": time_ms(torch,
                                  lambda: stem_mma_layer(layer, h, folded)),
                    "library_ms": time_ms(torch,
                                          run_all([lib[i] for i in which])),
                    "bound_ms": max(ops, byt)}
                h = stem_mma_layer(layer, h, folded)
            return out

        x16 = normalize_u8(u8, torch.bfloat16)
        lib16 = library_convs(x16, folded16, torch.bfloat16)
        ms = time_ms(torch, lambda: stem_fused(x16, folded16))
        plain_ms = time_ms(torch, lambda: stem_plain(x16, folded16), iters=5)
        library_ms = time_ms(torch, run_all(lib16))
        launches16 = per_launch(x16, folded16, lib16, 2, PEAK_BF16, 1)
        del lib16
        x32 = normalize_u8(u8, torch.float32)
        lib32 = library_convs(x32, folded32, torch.float32)
        ms32 = time_ms(torch, lambda: stem_fused_f32(x32, folded32))
        plain_ms32 = time_ms(torch, lambda: stem_plain(x32, folded32), iters=5)
        library_ms32 = time_ms(torch, run_all(lib32), iters=5)
        launches32 = per_launch(x32, folded32, lib32, 4, PEAK_TF32,
                                F32X3_PASSES)
        del lib32
    convs16 = _stem_convs(folded16, BATCH, 48, 640)
    convs32 = _stem_convs(folded32, BATCH, 48, 640)
    ops_ms, bytes_ms = _bound_ms(convs16, 2, PEAK_BF16)
    ops_ms32, bytes_ms32 = _bound_ms(convs32, 4, PEAK_TF32, F32X3_PASSES)
    cores_ms32 = max(_bound_ms(convs32, 4, PEAK_F32))
    print(f"stem work: {convs16[0]['flop'] / 1e9:.2f} GFLOP conv0 + "
          f"{sum(c['flop'] for c in convs16[1:]) / 1e9:.1f} GFLOP convs 1-3",
          flush=True)
    for name, launches in (("bf16", launches16), ("f32", launches32)):
        print(f"stem {name} launch by launch (ms, cuDNN ms, bound ms): "
              + "; ".join(f"{k} {v['ms']:.3f} {v['library_ms']:.3f} "
                          f"{v['bound_ms']:.3f}" for k, v in launches.items()),
              flush=True)
    print(f"stem f32 bound: {max(ops_ms32, bytes_ms32):.3f} ms with "
          f"{F32X3_PASSES} TF32 passes on the tensor cores, "
          f"{cores_ms32:.3f} ms at the CUDA cores' float32 rate; largest "
          f"error {max(errs.values()):.3e} (tol {TOL_STEM_F32:g})",
          flush=True)
    common = {"route": "cuda", "replaces": "kiri_tpu/kernels/stem.py:233",
              "launches": 0}
    return [{
        "name": "stem_fused", **common,
        "source": "kiri_tpu_torch/kernels/csrc/stem_mma.cu",
        "max_abs_err": max(errs_bf16.values()),
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms, "per_launch": launches16,
        "shape": f"x bf16 [{BATCH},48,640] -> [{BATCH},6,160,256]",
        "tolerance": f"{TOL_STEM_BF16_REL:g} x max(1, max |plain|) and, per "
                     f"element, {TOL_STEM_BF16_ELEM:g} x (|plain| + 1), at "
                     f"{cases} and on the edge rows and columns alone",
    }, {
        "name": "stem_fused_f32", **common,
        "source": "kiri_tpu_torch/kernels/csrc/stem_f32x3.cu",
        "max_abs_err": max(errs.values()),
        "ms": ms32, "plain_ms": plain_ms32,
        "bound_ms": max(ops_ms32, bytes_ms32),
        "bound_by": "operations" if ops_ms32 >= bytes_ms32 else "bytes",
        "library_ms": library_ms32, "per_launch": launches32,
        "shape": f"x f32 [{BATCH},48,640] -> [{BATCH},6,160,256]",
        "tolerance": f"{TOL_STEM_F32:g} (TF32 off in the plain version and "
                     f"cuDNN), at {cases} and on the edge rows and columns "
                     f"alone",
    }]


def preprocess_phase(torch, np, crops):
    """Preprocess kernel vs plain on (a) the main path's input, the smoke
    crops repeated to 128 lines as ``recognize_crops`` packs them, timed;
    (b) 128 edge cases: dark, small (cubic upscale), wide (clipped) and
    linear-flagged variants of the smoke crops; (c) extreme shapes."""
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
    # Extreme shapes: one row, one column, one pixel, taller than 256 px,
    # wider than the kernel's shared-memory strip (its direct path), dark.
    rng = np.random.default_rng(0)
    extreme = [rng.integers(0, 256, hw, dtype=np.uint8) for hw in
               ((1, 200), (40, 1), (1, 1), (300, 900), (400, 60), (20, 3300),
                (257, 3100), (2, 2), (48, 640), (5, 1000))]
    extreme += [np.ascontiguousarray(c // 3) for c in extreme[:7]]   # dark
    inputs = {}

    def run(name, buf, sizes3, out_h=48, out_w=640):
        dbuf = torch.from_numpy(buf).cuda()
        dsizes = torch.from_numpy(sizes3).cuda()
        got = preprocess_lines(dbuf, dsizes, out_h, out_w)
        want = preprocess_lines_plain(dbuf, dsizes, out_h, out_w)
        err = float((got - want).abs().max())
        nw = np.clip(np.rint(sizes3[:, 1] * out_h
                             / np.maximum(1, sizes3[:, 0])), 1, out_w)
        check(err <= TOL_PRE and bool(got.isfinite().all()),
              f"preprocess ({name}): max |kernel-plain| {err:.3e} (tol "
              f"{TOL_PRE:g}) on {len(buf)} crops in [{buf.shape[1]},"
              f"{buf.shape[2]}] -> [{out_h},{out_w}], "
              f"{int((sizes3[:, 0] < out_h).sum())} upscaled, "
              f"{int((nw >= out_w).sum())} clipped, "
              f"{int(sizes3[:, 2].sum())} linear")
        inputs[name] = (dbuf, dsizes, sizes3, err)

    for name, batch in (("main path", main), ("edge cases", edge),
                        ("extreme shapes", extreme)):
        buf, sizes = pack_crops(batch)
        sizes3 = np.zeros((len(batch), 3), np.int32)
        sizes3[:, :2] = sizes
        if name != "main path":
            sizes3[::4, 2] = 1                                   # linear flag
        run(name, buf, sizes3)
        if name == "extreme shapes":
            # An output no multiple of the row tile or of 4 columns, and a
            # buffer whose rows are not 16-byte aligned, with sizes of 0.
            run(name + ", out 20x50", buf, sizes3, 20, 50)
            odd = np.ascontiguousarray(buf[:, :301, :1001])
            sizes_odd = np.minimum(sizes3, [[301, 1001, 1]]).astype(np.int32)
            sizes_odd[-1, :2] = (0, 7)
            sizes_odd[-2, :2] = (9, 0)
            run(name + ", unaligned rows", odd, sizes_odd)
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
        "max_abs_err_other_inputs": {k: v[3] for k, v in inputs.items()
                                     if k != "main path"},
        "tolerance": f"{TOL_PRE:g}",
    }


def drive_run(total, by_run, name, fn, needs):
    """Run ``fn`` with the launch counters at 0, read them just after into
    ``by_run[name]`` and add them to ``total``, and hold each kernel of
    ``needs`` to at least one launch in it (the stems' in threes: 3 of
    ``stem_fused`` or ``stem_fused_f32``, or 1 of ``q8_stem01`` and 2 of
    ``q8_conv3x3``, a forward)."""
    from kiri_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    by_run[name] = {k: v for k, v in counts.items() if v}
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    # Every stem launches 3 kernels an encode.
    threes = all(counts[k] % 3 == 0 for k in needs if k.startswith("stem"))
    if "q8_stem01" in needs:
        threes &= counts["q8_conv3x3"] == 2 * counts["q8_stem01"]
    check(all(counts[k] > 0 for k in needs) and threes,
          f"{name}: {len(res)} results in {dt:.3f} s, launches "
          f"{by_run[name]} (needs {', '.join(needs)}; the stem's in "
          f"threes)")
    return res


def main_path_phase(torch, np, model, cfg, tok, d, crops):
    """Every path of the engine over the smoke lines, in bf16 against the
    ground truth and in float32 against kiri_tpu's stored answers, each run
    with the launch counters set to 0 just before it and read just after.
    Returns each kernel's launches, in all and by run."""
    from kiri_tpu_torch.engine import RecognizerEngine

    imgs, widths = d["imgs"], d["widths"]
    texts = [str(t) for t in d["texts"]]
    is_kh = [any(0x1780 <= ord(c) <= 0x17FF for c in t) for t in texts]
    total, by_run = {}, {}
    drive = functools.partial(drive_run, total, by_run)

    def runs_of(eng, stem):
        """(key in the fixture, CER limit, thunk, kernels it must launch)."""
        esc = RecognizerEngine(model, eng.cfg.replace(
            AUTO_CONF_THRESHOLD=float(d["auto_escalate_threshold"])), tok,
            device="cuda")
        pre = (stem, "preprocess_lines")
        return [
            ("batch", CER_MAX, lambda: eng.recognize_batch(
                imgs, "ctc", widths), (stem,)),
            ("crops", CER_MAX, lambda: eng.recognize_crops(crops, "ctc"), pre),
            ("batch_decoder", CER_MAX_DECODER, lambda: eng.recognize_batch(
                imgs, "decoder", widths), (stem,)),
            ("batch_beam", CER_MAX, lambda: eng.recognize_batch(
                imgs, "beam", widths), (stem,)),
            ("batch_auto", CER_MAX, lambda: eng.recognize_batch(
                imgs, "auto", widths), (stem,)),
            ("batch_auto_escalated", CER_MAX, lambda: esc.recognize_batch(
                imgs, "auto", widths), (stem,)),
            ("crops_decoder", CER_MAX_DECODER, lambda: eng.recognize_crops(
                crops, "decoder"), pre),
        ]

    eng = RecognizerEngine(model, cfg.replace(COMPUTE_DTYPE="bfloat16"), tok,
                           device="cuda")
    for key, cer_max, fn, needs in runs_of(eng, "stem_fused"):
        res = drive(f"bf16 {key}", fn, needs)
        hyp = [t for t, _ in res]
        kh = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if k])
        en = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if not k])
        agree = sum(a == str(b) for a, b in zip(hyp, d[f"{key}_texts_bf16"]))
        conf = np.asarray([c for _, c in res])
        check(kh <= cer_max and en <= cer_max and np.isfinite(conf).all()
              and conf.min() >= 0.0 and conf.max() <= 1.0,
              f"bf16 {key}: Khmer CER {kh:.4f}, English CER {en:.4f} "
              f"(max {cer_max}); confidences in [{conf.min():.3f}, "
              f"{conf.max():.3f}]; {agree}/{len(hyp)} texts equal kiri_tpu's "
              f"bf16 texts; max |conf diff| "
              f"{np.abs(conf - d[f'{key}_conf_bf16']).max():.2e}")
    print(f"bf16: {eng.fallback_rows} rows went from spec_decode to the step "
          f"loop at SPEC_MAX_ROUNDS={cfg.SPEC_MAX_ROUNDS}", flush=True)

    with torch.inference_mode():
        memp, ctc, ids, conf, est, n = eng.encode_batch(imgs[:8])
    check(tuple(ctc.shape) == (8, cfg.IMG_W // 4, tok.ctc_classes)
          and tuple(memp.shape) == (8, cfg.IMG_W // 4, cfg.DEC_DIM)
          and bool(ctc.isfinite().all()) and bool(memp.float().isfinite().all()),
          f"encode_batch: ctc {tuple(ctc.shape)}, memp {tuple(memp.shape)}, "
          "finite")

    def hold_f32(key, res):
        want = [str(t) for t in d[f"{key}_texts_f32"]]
        hyp = [t for t, _ in res]
        diff = [(i, h, w) for i, (h, w) in enumerate(zip(hyp, want)) if h != w]
        dconf = np.abs(np.asarray([c for _, c in res])
                       - d[f"{key}_conf_f32"]).max()
        check(not diff and dconf <= TOL_CONF_F32,
              f"f32 {key}: {len(hyp) - len(diff)}/{len(hyp)} texts equal "
              f"kiri_tpu's f32 texts, max |conf diff| {dconf:.2e} (tol "
              f"{TOL_CONF_F32:g})"
              + (f"; first differences {diff[:3]}" if diff else ""))
        return hyp

    cfg32 = cfg.replace(COMPUTE_DTYPE="float32")
    eng32 = RecognizerEngine(model, cfg32, tok, device="cuda")
    hyp32 = {key: hold_f32(key, drive(f"f32 {key}", fn, needs))
             for key, _, fn, needs in runs_of(eng32, "stem_fused_f32")}
    # The fallback: one round only, so every line whose draft needs more than
    # one correction is decoded again by the step loop.
    eng1 = RecognizerEngine(model, cfg32.replace(SPEC_MAX_ROUNDS=1), tok,
                            device="cuda")
    hyp1 = hold_f32("batch_decoder_rounds1", drive(
        "f32 batch_decoder, SPEC_MAX_ROUNDS=1",
        lambda: eng1.recognize_batch(imgs, "decoder", widths),
        ("stem_fused_f32",)))
    same = sum(a == b for a, b in zip(hyp1, hyp32["batch_decoder"]))
    check(eng1.fallback_rows > 0,
          f"f32 fallback: {eng1.fallback_rows} of {len(imgs)} rows went "
          f"through the step loop at SPEC_MAX_ROUNDS=1 "
          f"({eng32.fallback_rows} over all runs at "
          f"{cfg.SPEC_MAX_ROUNDS}); {same}/{len(imgs)} texts equal the "
          f"drafted loop's")

    # Throughput at batch 128 (the smoke lines twice), width-bucketed.
    idx = np.arange(BATCH) % len(imgs)
    big, bw = imgs[idx], widths[idx]
    for method, reps in (("ctc", 10), ("decoder", 5), ("beam", 3),
                         ("auto", 5)):
        for _ in range(2):
            eng.recognize_batch(big, method, bw)
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.recognize_batch(big, method, bw)
        dt = (time.perf_counter() - t0) / reps
        print(f"throughput {method} (bf16, batch {BATCH}, width-bucketed, "
              f"host clock, texts fetched): {BATCH / dt:.1f} lines/s "
              f"({dt * 1e3:.2f} ms per call)", flush=True)

    streams_phase(np, d, texts, is_kh, eng, eng32, drive)
    enhance_phase(torch, np, d, texts, eng, eng32, drive)
    spec_beam_phase(d, model, cfg32, tok, eng32, drive)
    return total, by_run


def _lcp_tokens(records):
    """A line's beam records with ``token`` under the port's rule: what the
    text adds past its longest common prefix with the previous text."""
    out, prev = [], ""
    for r in records:
        n = 0
        while n < min(len(prev), len(r["text"])) and prev[n] == r["text"][n]:
            n += 1
        out.append(dict(r, token=r["text"][n:]))
        prev = r["text"]
    return out


def _records_differ(ours, ref, tol):
    """(lines whose records differ: a key other than ``confidence``, or a
    confidence by more than ``tol``; the largest confidence difference of
    the records compared)."""
    bad, worst = [], 0.0
    for i, (o, r) in enumerate(zip(ours, ref)):
        strip = [[{k: v for k, v in x.items() if k != "confidence"}
                  for x in recs] for recs in (o, r)]
        diff = max((abs(a["confidence"] - b["confidence"])
                    for a, b in zip(o, r)), default=0.0)
        worst = max(worst, diff)
        if strip[0] != strip[1] or diff > tol:
            bad.append(i)
    return bad + list(range(min(len(ours), len(ref)),
                            max(len(ours), len(ref)))), worst


def streams_phase(np, d, texts, is_kh, eng, eng32, drive):
    """Streaming, one-shot and windowed, in bf16 and float32: float32
    records against kiri_tpu's stored ones, windowed against one-shot in
    the same run, bf16 final texts against the ground truth; then the time
    to the first record at batch 64 in bf16."""
    import json

    imgs = d["imgs"]
    stored = json.loads(str(d["stream_records_f32"]))
    cer_max = {"ctc": CER_MAX, "decoder": CER_MAX_DECODER, "beam": CER_MAX}
    for tag, e in (("bf16", eng), ("f32", eng32)):
        stem = "stem_fused" if tag == "bf16" else "stem_fused_f32"
        one = {}
        for m in ("ctc", "decoder", "beam", "auto"):
            one[m] = drive(f"{tag} stream {m}", lambda: [list(r) for r in
                           e.stream_records_batch(imgs, m)], (stem,))
        check(one["auto"] == one["ctc"],
              f"{tag} stream auto: the ctc stream's records")
        for m in ("ctc", "decoder", "beam"):
            win = drive(f"{tag} stream {m} window={STREAM_WINDOW}",
                        lambda: [list(r) for r in e.stream_records_batch(
                            imgs, m, window=STREAM_WINDOW)], (stem,))
            # A decoder line's one-shot probabilities come from
            # spec_decode's whole-sequence pass, the window's from the
            # cached step.
            tol = 1e-3 if m == "decoder" else 0.0
            bad, worst = _records_differ(win, one[m], tol)
            check(not bad, f"{tag} stream {m}: window={STREAM_WINDOW} "
                  f"records equal the one-shot records on "
                  f"{len(imgs) - len(bad)}/{len(imgs)} lines, max |conf "
                  f"diff| {worst:.2e} (tol {tol:g})"
                  + (f"; first {bad[:3]}" if bad else ""))
            final = [r[-1]["text"] for r in one[m]]
            if tag == "f32":
                ref = stored[m]
                n_rule = 0
                if m == "beam":
                    n_rule = sum(_lcp_tokens(r) != r for r in ref)
                    ref = [_lcp_tokens(r) for r in ref]
                bad, worst = _records_differ(one[m], ref, TOL_CONF_F32)
                check(not bad,
                      f"f32 stream {m}: records equal kiri_tpu's stored "
                      f"records on {len(imgs) - len(bad)}/{len(imgs)} lines "
                      f"({sum(map(len, one[m]))} records, max |conf diff| "
                      f"{worst:.2e}, tol {TOL_CONF_F32:g})"
                      + (f"; {n_rule} lines where kiri_tpu's token rule "
                         f"differs" if m == "beam" else "")
                      + (f"; first {bad[:3]}" if bad else ""))
            else:
                kh = cer([(t, o) for t, o, k in zip(texts, final, is_kh)
                          if k])
                en = cer([(t, o) for t, o, k in zip(texts, final, is_kh)
                          if not k])
                agree = sum(a == str(b) for a, b in zip(
                    final, d[f"stream_{m}_texts_bf16"]))
                check(kh <= cer_max[m] and en <= cer_max[m],
                      f"bf16 stream {m}: final texts Khmer CER {kh:.4f}, "
                      f"English CER {en:.4f} (max {cer_max[m]}); "
                      f"{agree}/{len(final)} equal kiri_tpu's bf16 stream "
                      f"texts")
    # Time to the first record of line 0, bf16, batch 64, host clock: the
    # median of 3 calls each, after 2 to warm up.
    def timed(m, w):
        """(ms to line 0's first record, ms to all records, records,
        windows run) of one call."""
        t0 = time.perf_counter()
        gens = eng.stream_records_batch(imgs, m, window=w)
        it = iter(gens[0])
        first = [next(it)]
        t_first = time.perf_counter() - t0
        # "ctc" has no window: its records come with the encode.
        runner = it.gi_frame.f_locals["self"] if w and m != "ctc" else None
        n_rec = sum(map(len, [first + list(it)] + [list(g) for g in gens[1:]]))
        return (t_first * 1e3, (time.perf_counter() - t0) * 1e3, n_rec,
                runner.windows if runner is not None else 0)

    def median_of(m, w, reps=3):
        for _ in range(2):
            timed(m, w)
        runs = sorted(timed(m, w) for _ in range(reps))
        return runs[reps // 2]

    for m in ("ctc", "decoder", "beam"):
        one = median_of(m, None)
        win = {w: median_of(m, w) for w in (
            (STREAM_WINDOW,) if m == "ctc" else STREAM_WINDOWS_TIMED)}
        first, total, n_rec, windows = win[STREAM_WINDOW]
        print(f"stream {m} (bf16, batch {len(imgs)}, host clock, median of "
              f"3): first record one-shot {one[0]:.2f} ms (all {one[2]} "
              f"records); window={STREAM_WINDOW}: first record {first:.2f} "
              f"ms, all {n_rec} records {total:.2f} ms in {windows} windows"
              + ("; by window (first ms / all ms / windows): " + ", ".join(
                  f"{w}: {v[0]:.2f} / {v[1]:.2f} / {v[3]}"
                  for w, v in win.items()) if len(win) > 1 else ""),
              flush=True)


def enhance_phase(torch, np, d, texts, eng, eng32, drive):
    """``recognize_crops(..., enhance=True)`` on the 16 noisy crops in bf16
    and float32, and ``enhance_lines`` on the card against the CPU."""
    from kiri_tpu_torch.kernels.resize import enhance_lines, pack_crops
    from kiri_tpu_torch.smoke import noisy_crops

    crops, sharpen = noisy_crops(d)
    buf, sizes = pack_crops(crops)
    outs = [enhance_lines(torch.from_numpy(buf).to(dev),
                          torch.from_numpy(sizes).to(dev),
                          torch.from_numpy(sharpen).to(dev))
            for dev in ("cuda", "cpu")]
    (gpu, sn_gpu), (cpu, sn_cpu) = [(o.cpu().numpy(), f.cpu().numpy())
                                    for o, f in outs]
    flat = np.concatenate([o[:h, :w].ravel() for o, (h, w) in zip(gpu, sizes)])
    check(np.array_equal(gpu, cpu) and np.array_equal(sn_gpu, sn_cpu)
          and np.array_equal(flat, d["noisy_enhanced_flat"])
          and np.array_equal(sn_gpu, d["noisy_small_noisy"]) and sn_gpu.any(),
          f"enhance_lines on the card: the CPU's u8 bytes and flags and "
          f"kiri_tpu's stored ones on {len(crops)} crops "
          f"({int((gpu != buf).sum())} pixels changed, {int(sn_gpu.sum())} "
          f"lines flagged for the linear resize)")
    truth = [texts[i] for i in d["noisy_src"]]
    for tag, e in (("bf16", eng), ("f32", eng32)):
        stem = "stem_fused" if tag == "bf16" else "stem_fused_f32"
        for m in ("ctc", "decoder"):
            res = drive(f"{tag} crops_enhance {m}", lambda: e.recognize_crops(
                crops, m, enhance=True, sharpen=sharpen),
                (stem, "preprocess_lines"))
            hyp = [t for t, _ in res]
            key = f"crops_enhance_{m}_texts_{tag}"
            agree = sum(a == str(b) for a, b in zip(hyp, d[key]))
            conf = np.asarray([c for _, c in res])
            dconf = np.abs(conf - d[f"crops_enhance_{m}_conf_{tag}"]).max()
            ok = np.isfinite(conf).all() and 0 <= conf.min() <= conf.max() <= 1
            if tag == "f32":
                ok &= agree == len(hyp) and dconf <= TOL_CONF_F32
            check(ok, f"{tag} crops_enhance {m}: {agree}/{len(hyp)} texts "
                  f"equal kiri_tpu's {tag} texts, max |conf diff| "
                  f"{dconf:.2e}; CER against the clean lines' truth "
                  f"{cer(list(zip(truth, hyp))):.4f}")


def spec_beam_phase(d, model, cfg32, tok, eng32, drive):
    """"beam" under ``SPEC_BEAM=True`` in float32: with LM fusion on (no
    line certifies) against kiri_tpu's stored step-loop texts, and with it
    off (most lines certify) against the port's step loop in this run."""
    from kiri_tpu_torch.engine import RecognizerEngine

    imgs, widths = d["imgs"], d["widths"]
    spec = RecognizerEngine(model, cfg32.replace(SPEC_BEAM=True), tok,
                            device="cuda")
    for key, fn in (("batch_beam", lambda: spec.recognize_batch(
            imgs, "beam", widths)), ("batch_spec_beam",
                                     lambda: spec.recognize_batch(
                                         imgs, "beam"))):
        before = spec.certified_rows
        res = drive(f"f32 SPEC_BEAM {key}", fn, ("stem_fused_f32",))
        same = sum(t == str(w) for (t, _), w in zip(
            res, d[f"{key}_texts_f32"]))
        check(same == len(imgs), f"f32 SPEC_BEAM {key}: {same}/{len(imgs)} "
              f"texts equal kiri_tpu's stored texts; "
              f"{spec.certified_rows - before} lines certified")
    off = cfg32.replace(USE_LM_FUSION_EVAL=False)
    step = RecognizerEngine(model, off, tok, device="cuda")
    spec = RecognizerEngine(model, off.replace(SPEC_BEAM=True), tok,
                            device="cuda")
    want = [t for t, _ in step.recognize_batch(imgs, "beam", widths)]
    got = [t for t, _ in drive("f32 SPEC_BEAM, fusion off", lambda:
                               spec.recognize_batch(imgs, "beam", widths),
                               ("stem_fused_f32",))]
    same = sum(a == b for a, b in zip(got, want))
    check(same == len(imgs) and spec.certified_rows > 0,
          f"f32 SPEC_BEAM, USE_LM_FUSION_EVAL=False: {same}/{len(imgs)} texts"
          f" equal the step-loop beam's; {spec.certified_rows} lines "
          f"certified")


def _ulps(torch, got, want):
    """Each element's distance from ``want`` in steps of ``want``'s dtype
    (float32: 2^-23, bfloat16: 2^-7 of the power of two below |want|)."""
    bits = 7 if want.dtype == torch.bfloat16 else 23
    w = want.float().abs()
    _, e = torch.frexp(torch.where(w > 0, w, torch.full_like(w, 2.0 ** -126)))
    return (got.float() - want.float()).abs() / torch.ldexp(
        torch.ones_like(w), e - 1 - bits)


def _hold_q8(torch, got, want, what):
    """Holds a q8 kernel's output to its plain version's: identical (the
    sums are exact, the epilogues take no FMA, SiLU is PyTorch's). Returns
    (max |diff|, identical)."""
    same = got.shape == want.shape and bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        and got.shape == want.shape else 0.0
    how = "identical to the plain version" if same else (
        f"differs from the plain version: shape {tuple(got.shape)} vs "
        f"{tuple(want.shape)}" + (f", {int((got != want).sum())} values, max "
                                  f"{float(_ulps(torch, got, want).max()):.2f}"
                                  f" ulps of {want.dtype}"
                                  if got.shape == want.shape else ""))
    check(same and bool(got.float().isfinite().all()),
          f"{what}: {how}, max |diff| {err:.3e}")
    return err, same


def quant8_phase(torch, np, model, cfg, tok, d, drive, card):
    """The int8 fast path (``ops/quant8.Q8Encoder``): (a) each kernel against
    its plain version on the card (the stem's three launches, conv0 + conv1,
    conv2 and conv3, at batch 128 x 48 x 640, 3 x 48 x 160 and the ragged
    2 x 48 x 636 and 1 x 48 x 52; the four encoder matmuls at M = 20,480 and
    37; float32 and bfloat16), timed with the plain version, the bound, the
    mma.sync kernels' times and the library yardsticks, beside the bf16
    wgmma stem, and the peak memory of an int8 forward; (b) float32 texts
    on kiri_tpu's stored scales against its stored texts, and the port's
    own calibration against those scales; (c) bf16 on the port's own calibration: CER
    against the ground truth and the text CER against its own reference
    path; (d) encode + CTC at batch 128 for the reference path and the three
    sets; (e) each int8 run through ``drive``. Returns the three kernels'
    entries."""
    from kiri_tpu_torch.convert import q8_scales_from_jax
    from kiri_tpu_torch.kernels.quant8 import (q8_conv3x3, q8_conv3x3_plain,
                                               q8_linear, q8_linear_plain,
                                               q8_stem01, q8_stem01_plain,
                                               quantize)
    from kiri_tpu_torch.kernels.stem import STRIDES, stem_fused
    from kiri_tpu_torch.ops.preprocess import normalize_u8
    from kiri_tpu_torch.ops.quant8 import Q8Encoder
    from kiri_tpu_torch.smoke import load_smoke_q8, q8_scales

    F = torch.nn.functional
    t_phase = time.perf_counter()
    stored = load_smoke_q8()
    imgs = d["imgs"]
    texts = [str(t) for t in d["texts"]]
    is_kh = [any(0x1780 <= ord(c) <= 0x17FF for c in t) for t in texts]
    cfg32 = cfg.replace(COMPUTE_DTYPE="float32")
    cfg16 = cfg.replace(COMPUTE_DTYPE="bfloat16")
    sets = (("stem",), ("stem", "attn", "ffn"), ("attn", "ffn"))

    def needs(parts):                # 3 stem launches: q8_stem01, conv2-3
        return (("q8_stem01", "q8_conv3x3") if "stem" in parts else ()) + (
            ("q8_linear",) if {"attn", "ffn"} & set(parts) else ())

    def read(ctc):
        return tok.decode_ctc_batch(ctc.argmax(-1).cpu().numpy())

    # (b) float32 on kiri_tpu's stored scales.
    for parts in sets:
        key = "_".join(parts)
        q = Q8Encoder(model, cfg32, parts=parts, device="cuda")
        q.scales = q8_scales_from_jax(q8_scales(stored, parts))
        hyp = drive(f"q8 f32 {key}", lambda: read(q(imgs)[1]), needs(parts))
        want = [str(t) for t in stored[f"{key}_texts_f32"]]
        diff = [(i, h, w) for i, (h, w) in enumerate(zip(hyp, want))
                if h != w]
        check(not diff, f"q8 f32 {key} on kiri_tpu's scales: "
              f"{len(hyp) - len(diff)}/{len(hyp)} texts equal kiri_tpu's"
              + (f"; first differences {diff[:3]}" if diff else ""))
    # The port's own float32 calibration against the stored scales.
    for parts in sets:
        key = "_".join(parts)
        q = Q8Encoder(model, cfg32, parts=parts, device="cuda")
        q.calibrate(imgs[:32])
        js = q8_scales_from_jax(q8_scales(stored, parts))
        pairs = [(js["enc"], q.scales["enc"])] if js["enc"] else []
        pairs += [(j[n], t[n]) for j, t in zip(js["stem"], q.scales["stem"])
                  for n in ("inv", "ws")]
        rel = [float(np.max(np.abs(np.asarray(a, np.float64)
                                   - np.asarray(b, np.float64))
                            / np.abs(np.asarray(a, np.float64))))
               for a, b in pairs]
        moved = sum(int((j["wq"] != t["wq"]).sum())
                    for j, t in zip(js["stem"], q.scales["stem"]))
        check(len(q.scales["enc"]) == len(js["enc"])
              and len(q.scales["stem"]) == len(js["stem"])
              and max(rel) <= TOL_Q8_CALIB,
              f"q8 f32 {key}: calibrate on lines 0-31 within {max(rel):.3e} "
              f"relative of kiri_tpu's stored scales (tol {TOL_Q8_CALIB:g}); "
              f"{moved} folded int8 stem weights moved")

    # (c) bf16 on the port's own calibration.
    q16 = {}
    for parts in sets:
        key = "_".join(parts)
        q = q16[parts] = Q8Encoder(model, cfg16, parts=parts, device="cuda")
        q.calibrate(imgs[:32])
        hyp = drive(f"q8 bf16 {key}", lambda: read(q(imgs)[1]), needs(parts))
        ref = read(q.bf16(imgs)[1])
        kh = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if k])
        en = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if not k])
        vs_ref = (sum(lev(a, b) for a, b in zip(hyp, ref))
                  / sum(max(1, len(b)) for b in ref))
        bound = max(Q8_TEXT_CER, float(stored[f"{key}_cer_bf16"])
                    + Q8_TEXT_CER)
        check(kh <= CER_MAX and en <= CER_MAX and vs_ref <= bound,
              f"q8 bf16 {key}: Khmer CER {kh:.4f}, English CER {en:.4f} "
              f"(max {CER_MAX}); text CER against the port's bf16 path "
              f"{vs_ref:.5f} (max {bound:.5f}: kiri_tpu's own "
              f"{float(stored[f'{key}_cer_bf16']):.5f} + {Q8_TEXT_CER}); "
              f"{sum(a == b for a, b in zip(hyp, ref))}/{len(ref)} texts "
              f"equal")

    # (a) kernels against their plain versions, on the calibrated scales.
    u8 = torch.from_numpy(np.resize(imgs, (BATCH,) + imgs.shape[1:])).cuda()
    q32 = Q8Encoder(model, cfg32, device="cuda")
    q32.calibrate(imgs[:32])
    errs = {"q8_stem01": [], "q8_conv3x3": [], "q8_linear": []}
    same = {name: [] for name in errs}
    rows = {}

    def stem_args(q, x):
        """(args of q8_stem01, conv2's and conv3's (args, inv)) of ``q``."""
        run, p = q._runtime(), q.pack["stem"]
        s1 = run["stem"][0]
        a01 = (x, p[0]["w"], run["conv0"], p[0]["b"],
               q._correction(*x.shape[1:]), s1["wq"], s1["ws"], p[1]["b"],
               s1["inv"], q.dtype)
        convs = [((run["stem"][i - 1]["wq"], run["stem"][i - 1]["ws"],
                   p[i]["b"], STRIDES[i]), run["stem"][i - 1]["inv"])
                 for i in (2, 3)]
        return a01, convs

    def hold(name, got, want, what):
        e, s = _hold_q8(torch, got, want, what)
        errs[name].append(e)
        same[name].append(s)

    with torch.inference_mode():
        for q in (q16[sets[1]], q32):
            name = "bf16" if q.dtype == torch.bfloat16 else "f32"
            for n, w in ((BATCH, 640), (3, 160), (2, 636), (1, 52)):
                x = u8[:n, :, :w].contiguous()
                a01, convs = stem_args(q, x)
                got = q8_stem01(*a01)
                hold("q8_stem01", got, q8_stem01_plain(*a01),
                     f"q8_stem01 {name} conv0+conv1 B={n} W={w}")
                if n == BATCH and name == "bf16":
                    rows["stem01"] = (a01, got)
                for i, (args, inv) in zip((2, 3), convs):
                    out = q8_conv3x3(got, *args, inv=inv)
                    hold("q8_conv3x3", out,
                         q8_conv3x3_plain(got, *args, inv=inv),
                         f"q8_conv3x3 {name} conv{i} B={n} W={w}")
                    if n == BATCH and name == "bf16":
                        rows[f"conv{i}"] = (got, args, inv, out)
                    got = out
            # SiLU at the edges of its range (csrc/q8_wgmma.cuh: past
            # x = -87 the division's operands are scaled, past -88.7 the
            # divisor is infinite, past 17 it is 1): two bands of conv0's
            # pixels (corr +-200) and every channel of convs 1-3 (scale
            # x 1000) reach pre-activations of some hundreds.
            x = u8[:3, :, :160].contiguous()
            a01, convs = stem_args(q, x)
            corr = a01[4].clone()
            corr[:, 40:80] += 200.0
            corr[:, 80:120] -= 200.0
            a01 = a01[:4] + (corr, a01[5], a01[6] * 1000.0) + a01[7:]
            got = q8_stem01(*a01)
            hold("q8_stem01", got, q8_stem01_plain(*a01),
                 f"q8_stem01 {name} at the edges of SiLU's range")
            for i, (args, inv) in zip((2, 3), convs):
                args = (args[0], args[1] * 1000.0) + args[2:]
                out = q8_conv3x3(got, *args, inv=inv)
                hold("q8_conv3x3", out,
                     q8_conv3x3_plain(got, *args, inv=inv),
                     f"q8_conv3x3 {name} conv{i} at the edges of SiLU's "
                     f"range")
                got = out
            rng = np.random.default_rng(0)
            layer = q.pack["enc"][0]
            run = q._runtime()["enc"][0]
            for gname, k in (("qkv", 256), ("wo", 256), ("lin1", 256),
                             ("lin2", 1024)):
                for m in (BATCH * 160, 37):
                    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(
                        np.float32)).cuda().to(q.dtype)
                    inv, sc = run[gname]
                    args = (x, inv, layer[gname]["w"], sc, layer[gname]["b"])
                    got = q8_linear(*args)
                    hold("q8_linear", got, q8_linear_plain(*args),
                         f"q8_linear {name} {gname} M={m} K={k}")
                    if m == BATCH * 160 and name == "bf16":
                        rows[gname] = args
        print("q8 kernels: outputs identical to the plain versions' (the "
              "epilogues take no FMA): " + ", ".join(
                  f"{k} {sum(v)}/{len(v)}" for k, v in same.items()),
              flush=True)

        # (d) timing, launch by launch at the main path's shapes (bf16).
        q = q16[sets[1]]

        def bound(ops, nbytes):
            return {"bound_ms": max(ops / PEAK_INT8, nbytes / PEAK_BYTES)
                    * 1e3,
                    "bound_by": ("operations" if ops / PEAK_INT8
                                 >= nbytes / PEAK_BYTES else "bytes")}

        def cudnn_conv(i, xf, stride):
            """cuDNN's bf16 convolution + bias + SiLU of stem conv i."""
            wf = q.pack["stem"][i]["wf"]
            cin, cout = wf.shape[0] // 9, wf.shape[1]
            oihw = wf.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).to(
                torch.bfloat16).contiguous()
            b16 = q.pack["stem"][i]["b"].to(torch.bfloat16)
            return lambda h: F.silu(F.conv2d(h, oihw, b16, stride=stride,
                                             padding=1))

        def int_mm_conv(xq, wq, stride, scale, bias, corr=None):
            """im2col + ``torch._int_mm`` of a stem conv on int8 NHWC
            ``xq``, then the dequant, bias and SiLU: [B, Ho, Wo, Cout]
            bf16."""
            b, h, w, cin = xq.shape
            sh, sw = stride
            ho, wo = (h - 1) // sh + 1, (w - 1) // sw + 1
            kpad = -(-9 * cin // 8) * 8
            xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
            cols = torch.cat([xp[:, dy:dy + sh * (ho - 1) + 1:sh,
                                 dx:dx + sw * (wo - 1) + 1:sw]
                              for dy in range(3) for dx in range(3)], -1)
            cols = F.pad(cols.reshape(-1, 9 * cin), (0, kpad - 9 * cin))
            y = torch._int_mm(cols, wq.t()).float() * scale
            if corr is not None:
                y = y + corr.reshape(-1, wq.shape[0]).repeat(b, 1)
            return F.silu(y + bias).to(torch.bfloat16).reshape(
                b, ho, wo, -1)

        def kpad8(wq):
            return F.pad(wq, (0, -wq.shape[1] % 8)).contiguous()

        def stem01_row():
            a01, out = rows["stem01"]
            x, w0, s0, b0, corr, w1, s1, b1, inv1, _ = a01
            b, h, w = x.shape
            ops = 2.0 * b * h * w * 48 * 9 + 2.0 * out.numel() * 9 * 48
            nbytes = (x.numel() + out.numel() * out.element_size()
                      + corr.numel() * 4 + w0.numel() + w1.numel()
                      + 4 * (3 * 48 + 2 * 96))
            xf = normalize_u8(x, torch.bfloat16).unsqueeze(1)
            c0, c1 = cudnn_conv(0, xf, STRIDES[0]), cudnn_conv(1, xf,
                                                               STRIDES[1])
            w0p, w1p = kpad8(w0), kpad8(w1)

            def int_mm():
                xi = (x.to(torch.int16) - 128).to(torch.int8).unsqueeze(-1)
                h0 = int_mm_conv(xi, w0p, STRIDES[0], s0, b0, corr)
                return int_mm_conv(quantize(h0, inv1), w1p, STRIDES[1], s1,
                                   b1)
            return {"ms": time_ms(torch, lambda: q8_stem01(*a01)),
                    "plain_ms": time_ms(torch, lambda: q8_stem01_plain(*a01),
                                        iters=5),
                    **bound(ops, nbytes),
                    "library_ms": time_ms(torch, lambda: c1(c0(xf))),
                    "int_mm_ms": time_ms(torch, int_mm, iters=5),
                    "shape": f"u8 {tuple(x.shape)} -> {tuple(out.shape)} "
                             f"bf16, K=9 and 432"}

        def conv_row(i):
            x, args, inv, out = rows[f"conv{i}"]
            wq, sc, bias, stride = args
            b, h, w, cin = x.shape
            cout = wq.shape[0]
            ops = 2.0 * out.numel() * 9 * cin
            nbytes = (x.numel() * x.element_size()
                      + out.numel() * out.element_size() + wq.numel()
                      + 4 * (cin + 2 * cout))
            xf = x.permute(0, 3, 1, 2)
            lib = cudnn_conv(i, xf, stride)
            wp = kpad8(wq)
            return {"ms": time_ms(torch, lambda: q8_conv3x3(x, *args,
                                                            inv=inv)),
                    "plain_ms": time_ms(torch, lambda: q8_conv3x3_plain(
                        x, *args, inv=inv), iters=5),
                    **bound(ops, nbytes),
                    "library_ms": time_ms(torch, lambda: lib(xf)),
                    "int_mm_ms": time_ms(torch, lambda: int_mm_conv(
                        quantize(x, inv), wp, stride, sc, bias), iters=5),
                    "shape": f"{tuple(x.shape)} bf16 -> {tuple(out.shape)}, "
                             f"K={9 * cin}"}

        def gemm_row(gname):
            x, inv, wq, sc, bias = rows[gname]
            m, k = x.shape
            n = wq.shape[0]

            def lib():
                acc = torch._int_mm(quantize(x, inv), wq.t())
                return (acc.float() * sc + bias).to(x.dtype)
            return {"ms": time_ms(torch, lambda: q8_linear(*rows[gname])),
                    "plain_ms": time_ms(torch, lambda: q8_linear_plain(
                        *rows[gname]), iters=5),
                    **bound(2.0 * m * n * k,
                            2 * (m * k + m * n) + n * k + 8 * n),
                    "library_ms": time_ms(torch, lib),
                    "shape": f"bf16 [{m},{k}] x int8 [{n},{k}]"}

        stem_rows = {"stem01": stem01_row(), "conv2": conv_row(2),
                     "conv3": conv_row(3)}
        gemm_rows = {g: gemm_row(g) for g in ("qkv", "wo", "lin1", "lin2")}
        # The port's bf16 wgmma stem on the same lines, in the same run.
        folded = model.stem.folded(torch.bfloat16)
        lines16 = normalize_u8(u8, torch.bfloat16)
        bf16_stem_ms = time_ms(torch, lambda: stem_fused(lines16, folded))
        before = {**MMA_SYNC_Q8_MS, "stem01": MMA_SYNC_Q8_MS["conv0"]
                  + MMA_SYNC_Q8_MS["conv1"]}
        for name, r in {**stem_rows, **gemm_rows}.items():
            print(f"q8 {name} ({r['shape']}): kernel {r['ms']:.4f} ms "
                  f"(mma.sync: {before[name]:.4f}), plain "
                  f"{r['plain_ms']:.3f} "
                  f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{r['ms'] / r['bound_ms']:.1f}x), library "
                  f"{r['library_ms']:.4f} ms"
                  + (f", im2col + _int_mm {r['int_mm_ms']:.4f} ms"
                     if "int_mm_ms" in r else "") + f"; {card}", flush=True)
        stem_ms = sum(r["ms"] for r in stem_rows.values())
        print(f"q8 the int8 stem, 3 launches: {stem_ms:.4f} ms (mma.sync, 4 "
              f"launches: {MMA_SYNC_Q8_MS['stem']:.4f}); the bf16 wgmma stem "
              f"(stem_fused) {bf16_stem_ms:.4f} ms in this run: "
              f"{bf16_stem_ms / stem_ms:.2f}x; {card}", flush=True)

        # Peak memory: conv0's output never exists in device memory.
        def peak_mib(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

        a01, out01 = rows.pop("stem01")
        del rows
        conv0_mib = BATCH * 48 * 640 * 48 * 2 / 2 ** 20
        out_mib = out01.numel() * out01.element_size() / 2 ** 20
        stem_mib = peak_mib(lambda: q8_stem01(*a01))
        full_mib = peak_mib(lambda: q16[sets[1]](u8))
        check(stem_mib <= out_mib + 2,
              f"q8 peak memory at batch {BATCH}: q8_stem01 {stem_mib:.1f} MiB"
              f" above what was resident, its output alone ({out_mib:.1f}); "
              f"conv0's bf16 output would be {conv0_mib:.1f} MiB; a full "
              f"int8 forward {full_mib:.1f} MiB")
        del a01, out01

        # encode + CTC at batch 128, device-resident: ms a batch, lines/s,
        # the reference path and the three sets interleaved over ROUNDS
        # rounds (host clock: a path whose launches outrun the device reads
        # the host's pace, which moves with the load on the host's cores).
        def per_batch(fn, reps=10):
            """(ms a batch, the host's ms to queue a batch)."""
            for _ in range(2):
                fn(u8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [fn(u8)[1].argmax(-1) for _ in range(reps)]
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            del out
            return ((time.perf_counter() - t0) / reps * 1e3,
                    (t1 - t0) / reps * 1e3)

        def busy(fn, match, reps=5):
            """The device's busy ms a batch under the profiler, the ms of
            the kernels whose name holds ``match``, and the three longest
            kernels' (name, ms)."""
            from torch.profiler import ProfilerActivity, profile
            fn(u8)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn(u8)
                torch.cuda.synchronize()
            by = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by[e.name] = (by.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3 / reps)
            top = sorted(by.items(), key=lambda kv: -kv[1])[:3]
            return (sum(by.values()), sum(v for k, v in by.items()
                                          if match in k.lower()), top)

        paths = {"reference path": (q16[sets[0]].bf16, "stem")}
        paths.update({f"int8 {'_'.join(parts)}": (q16[parts], "q8_")
                      for parts in sets})
        host = {k: [] for k in paths}
        dev = {k: [] for k in paths}
        for rnd in range(ROUNDS):
            for k, (fn, match) in paths.items():
                host[k].append(per_batch(fn))
                if rnd in (0, ROUNDS - 1):
                    dev[k].append(busy(fn, match))

        def med(v):
            return float(np.median(v))
        ms_ref = med([h[0] for h in host["reference path"]])
        print(f"q8 encode + CTC (bf16, batch {BATCH}, 48 x 640, "
              f"device-resident, host clock, {ROUNDS} interleaved rounds of "
              f"10 batches; {card}):", flush=True)
        for k in paths:
            ms = [h[0] for h in host[k]]
            issue = [h[1] for h in host[k]]
            busy_ms = [d[0] for d in dev[k]]
            part = [d[1] for d in dev[k]]
            top = ", ".join(f"{n[:48]} {v:.2f}" for n, v in dev[k][-1][2])
            print(f"q8   {k}: {med(ms):.2f} ms median (rounds "
                  f"{', '.join(f'{v:.2f}' for v in ms)}; "
                  f"{BATCH / med(ms) * 1e3:.1f} lines/s, "
                  f"{ms_ref / med(ms):.2f}x the reference path); the host "
                  f"queues a batch in {med(issue):.2f} ms median "
                  f"({min(issue):.2f}-{max(issue):.2f}); device busy "
                  f"{' and '.join(f'{v:.2f}' for v in busy_ms)} ms, "
                  f"{paths[k][1]} kernels "
                  f"{' and '.join(f'{v:.2f}' for v in part)} ms; longest: "
                  f"{top}", flush=True)
    # The plain versions' float64 im2col buffers (GBs at batch 128) stay in
    # the caching allocator otherwise, where later phases cannot reuse them
    # and the parallel phase's ranks on this card then find no memory.
    del q16, q32, u8, lines16
    torch.cuda.empty_cache()
    print(f"q8 phase: {time.perf_counter() - t_phase:.1f} s", flush=True)

    def entry(name, source, replaces, rs, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0,
                "max_abs_err": max(errs[name]),
                "ms": sum(r["ms"] for r in rs.values()),
                "plain_ms": sum(r["plain_ms"] for r in rs.values()),
                "bound_ms": sum(r["bound_ms"] for r in rs.values()),
                "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                           for r in rs.values())
                else "operations",
                "library_ms": sum(r["library_ms"] for r in rs.values()),
                "per_launch": rs, "shape": shape,
                "identical_to_plain": f"{sum(same[name])}/{len(same[name])}"
                                      f" outputs",
                "tolerance": "identical"}

    src = "kiri_tpu_torch/kernels/csrc/"
    return [
        entry("q8_stem01", src + "q8_stem.cu",
              "kiri_tpu/ops/quant8.py:149-153,167-170",
              {"stem01": stem_rows["stem01"]},
              f"conv0 + conv1, u8 [{BATCH},48,640] -> bf16 "
              f"[{BATCH},24,320,96]"),
        entry("q8_conv3x3", src + "q8_stem.cu", "kiri_tpu/ops/quant8.py:167-170",
              {k: stem_rows[k] for k in ("conv2", "conv3")},
              f"conv2 and conv3, bf16 [{BATCH},24,320,96] -> "
              f"[{BATCH},6,160,256]"),
        entry("q8_linear", src + "q8_gemm.cu", "kiri_tpu/ops/quant8.py:65-66",
              gemm_rows,
              f"one encoder layer's 4 matmuls at M={BATCH * 160}, bf16"),
    ]


def _stored_agree(got_pages, stored_pages):
    """(results compared, texts equal, largest confidence difference, the
    (page, line) of differing texts) over the results whose box and line
    number equal a stored result's."""
    n = same = 0
    worst, bad = 0.0, []
    for i, (got, want) in enumerate(zip(got_pages, stored_pages)):
        by_key = {(r["line_number"], tuple(r["box"])): r for r in want}
        for r in got:
            w = by_key.get((r["line_number"], tuple(r["box"])))
            if w is None:
                continue
            n += 1
            worst = max(worst, abs(r["confidence"] - w["confidence"]))
            if r["text"] == w["text"]:
                same += 1
            else:
                bad.append((i, r["line_number"]))
    return n, same, worst, bad


def pages_phase(torch, np, drive, card):
    """``OCR`` on the card over the committed pages at full width with both
    committed checkpoints: the DB map, the boxes, float32 texts against
    kiri_tpu's stored ones, bf16 CER against the ground truth, the pooled
    ``process_documents``, device preprocessing and enhancement, and the
    host preprocessing of the smoke lines without cv2; then pages/s, the
    p50 of ``extract_text``, ms per stage, the DB forward per canvas and
    the device's busy share of a page."""
    from kiri_tpu_torch.evalpage import is_khmer, score_pages
    from kiri_tpu_torch.ops.preprocess import (invert_if_dark,
                                               preprocess_crops, to_gray)
    from kiri_tpu_torch.pipeline import OCR
    from kiri_tpu_torch.smoke import load_smoke_lines, load_smoke_pages

    fx = load_smoke_pages()
    pages, stored = fx["pages"], fx["results"]
    imgs = [p["image"] for p in pages]
    ckpt = str(REPO / "models" / "model.safetensors")
    det_path = str(REPO / "models" / "detector.safetensors")

    def ocr(**kw):
        return OCR(ckpt, det_model_path=det_path, device="cuda", **kw)

    bf16 = {m: ocr(decode_method=m, use_fp16=True)
            for m in ("fast", "accurate")}
    f32 = {m: ocr(decode_method=m, use_fp16=False)
           for m in ("fast", "accurate")}
    check(f32["fast"].engine.dtype == torch.float32
          and bf16["fast"].engine.dtype == torch.bfloat16,
          "pages: OCR(use_fp16=False) after OCR(use_fp16=True) on one "
          "checkpoint runs float32 (the model cache is keyed on the dtype)")
    det = f32["fast"].detector
    db = det.db_detector

    # The detector's u16 map on the stored page.
    canvas, _, _ = db._resize_image(invert_if_dark(to_gray(
        imgs[fx["prob_page"]])))
    wire = db.forward_wire(canvas[None]).cpu().numpy()[0]
    dmap = np.abs(wire.astype(np.int64) - fx["prob_u16"])
    check(wire.shape == fx["prob_u16"].shape and dmap.max() <= PAGE_MAP_TOL,
          f"pages: DB u16 map of page {fx['prob_page']} (canvas "
          f"{canvas.shape}) within {int(dmap.max())} counts of kiri_tpu's "
          f"(tol {PAGE_MAP_TOL}); {int((dmap > 0).sum())} of {dmap.size} "
          f"values differ")

    # Boxes against the stored ones.
    ok, n_boxes, n_diff, quads_same = True, 0, 0, 0
    for p in pages:
        got = [b.bbox for b in det.detect_lines_objects(p["image"])]
        ok &= len(got) == len(p["boxes"])
        n_boxes += len(got)
        for g, w in zip(got, p["boxes"]):
            ok &= max(abs(a - b) for a, b in zip(g, w)) <= PAGE_BOX_TOL
            n_diff += tuple(g) != tuple(w)
        quads = db.detect_text(p["image"])
        quads_same += len(quads) == len(p["det_quads"]) and all(
            np.array_equal(q, w) for (q, _), w in zip(quads, p["det_quads"]))
    check(ok, f"pages: {n_boxes} line boxes on {len(pages)} pages, each "
          f"page the stored count, every box within {PAGE_BOX_TOL} px of "
          f"kiri_tpu's; {n_diff} boxes not identical; DB quads identical on "
          f"{quads_same}/{len(pages)} pages")

    # float32 against kiri_tpu's stored results, on identical boxes.
    def hold_f32(run, res):
        n, same, worst, bad = _stored_agree(res, stored[run])
        check(n > 0 and not bad and worst <= TOL_CONF_F32,
              f"pages f32 {run}: {same}/{n} texts on identical boxes equal "
              f"kiri_tpu's stored texts ({sum(map(len, res))} lines in all), "
              f"max |conf diff| {worst:.2e} (tol {TOL_CONF_F32:g})"
              + (f"; first differences {bad[:3]}" if bad else ""))

    per_page = {}
    for m, o in f32.items():
        per_page[m] = drive(f"pages f32 {m}", lambda: [
            o.process_document(im) for im in imgs], ("stem_fused_f32",))
        hold_f32(f"{m}_f32", per_page[m])
    dev = ocr(decode_method="fast", use_fp16=False, preprocess="device")
    hold_f32("fast_f32_device", drive(
        "pages f32 fast preprocess=device", lambda: [
            dev.process_document(im) for im in imgs],
        ("stem_fused_f32", "preprocess_lines")))
    noisy = next(i for i, p in enumerate(pages) if p["spec"][3] == "noisy")
    enh = ocr(decode_method="fast", use_fp16=False, enhance=True)
    hold_f32("fast_f32_enhance", drive(
        "pages f32 fast enhance", lambda: [
            enh.process_document(im) if i == noisy else []
            for i, im in enumerate(imgs)], ("stem_fused_f32",)))
    pooled = drive("pages f32 fast process_documents",
                   lambda: f32["fast"].process_documents(imgs),
                   ("stem_fused_f32",))
    n, same, worst, bad = _stored_agree(pooled, per_page["fast"])
    check(n == sum(map(len, per_page["fast"])) == sum(map(len, pooled))
          and not bad and worst <= TOL_CONF_F32,
          f"pages f32 fast: process_documents over {len(imgs)} pages gives "
          f"the per-page boxes and texts on {same}/{n} lines, max |conf "
          f"diff| {worst:.2e}")

    # bf16 against the ground truth: each script's line CER within the gate,
    # or, where kiri_tpu's stored answers read the pages worse than the
    # gate, within PAGE_CER_SLACK of kiri_tpu's.
    gates = {"fast": CER_MAX, "accurate": CER_MAX_DECODER}
    scripts = {"Khmer": is_khmer, "English": lambda t: not is_khmer(t)}
    for m, o in bf16.items():
        res = drive(f"pages bf16 {m}", lambda: [
            o.process_document(im) for im in imgs], ("stem_fused",))
        every = score_pages(pages, res)
        ours = {k: score_pages(pages, res, f) for k, f in scripts.items()}
        ref = {k: score_pages(pages, stored[f"{m}_bf16"], f)
               for k, f in scripts.items()}
        limit = {k: max(gates[m], ref[k]["matched_cer"] + PAGE_CER_SLACK)
                 for k in scripts}
        n, same, _, _ = _stored_agree(res, stored[f"{m}_bf16"])
        check(all(ours[k]["matched_cer"] <= limit[k] for k in scripts),
              f"pages bf16 {m}: line CER "
              + ", ".join(f"{k} {ours[k]['matched_cer']:.4f} (max "
                          f"{limit[k]:.4f}; kiri_tpu "
                          f"{ref[k]['matched_cer']:.4f}), end2end "
                          f"{ours[k]['end2end_cer']:.4f}" for k in scripts)
              + f"; end2end_cer {every['end2end_cer']:.4f}, doc_cer "
              f"{every['doc_cer']:.4f} (kiri_tpu "
              f"{score_pages(pages, stored[f'{m}_bf16'])['doc_cer']:.4f}), "
              f"line recall {every['line_recall']:.4f} over "
              f"{every['gt_lines']} lines; {same}/{n} texts equal kiri_tpu's "
              f"bf16 texts")

    # Host preprocessing without cv2 on the smoke lines.
    d, crops = load_smoke_lines()
    eng32 = f32["fast"].engine
    pimgs, pw = preprocess_crops(eng32.cfg, crops)
    diff = np.abs(pimgs.astype(np.int64) - d["imgs"])
    agree = {}
    for m, key in (("ctc", "batch_texts_f32"),
                   ("decoder", "batch_decoder_texts_f32")):
        res = drive(f"pages f32 smoke lines host-preprocessed {m}",
                    lambda: eng32.recognize_batch(pimgs, m, pw),
                    ("stem_fused_f32",))
        agree[m] = sum(t == str(w) for (t, _), w in zip(res, d[key]))
    check(diff.max() <= 1 and np.array_equal(pw, d["widths"])
          and all(v == len(crops) for v in agree.values()),
          f"host preprocessing without cv2: the {len(crops)} smoke crops give "
          f"the committed imgs but {int((diff > 0).sum())} pixels in "
          f"{int(diff.any(axis=(1, 2)).sum())} lines, by at most "
          f"{int(diff.max())} level (cv2's IPP cubic); float32 texts equal "
          f"kiri_tpu's stored ones: ctc {agree['ctc']}/{len(crops)}, decoder "
          f"{agree['decoder']}/{len(crops)}")

    # Times, bf16 (the checkpoint's dtype), host clock unless named.
    many = [imgs[i % len(imgs)] for i in range(PAGES_TIMED)]
    for m, o in bf16.items():
        o.process_documents(imgs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.process_documents(many)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        one = []
        for _ in range(9):
            t0 = time.perf_counter()
            o.extract_text(imgs[0])
            one.append((time.perf_counter() - t0) * 1e3)
        stages = {}
        for im in imgs:
            o.process_document(im)
            for k, v in o.last_timer.totals.items():
                stages[k] = stages.get(k, 0.0) + v * 1e3 / len(imgs)
        print(f"pages {m} (bf16; {card}): process_documents of "
              f"{PAGES_TIMED} pages {PAGES_TIMED / dt:.2f} pages/s "
              f"({dt * 1e3 / PAGES_TIMED:.2f} ms a page); extract_text of "
              f"page 0 p50 {sorted(one[2:])[3]:.2f} ms (7 calls after 2); "
              f"stages, mean ms a page over {len(imgs)} pages: "
              + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()),
              flush=True)
    # Detection split: the map (resize, upload, forward, fetch) against the
    # host postprocessing; then the forward per canvas bucket and a whole
    # page, host clock against the device's busy time.
    fwd = post = 0.0
    canvases = {}
    for im in imgs:
        gray = invert_if_dark(to_gray(im))
        t0 = time.perf_counter()
        pred, (_, _, oh, ow) = db.predict_maps(gray)
        t1 = time.perf_counter()
        det._split_column_merges(im, det._process_boxes_objects(
            db._padded_sorted(*db._finish_page(pred, ow, oh)), merge=False,
            skip_sort=True))
        t2 = time.perf_counter()
        fwd, post = fwd + (t1 - t0), post + (t2 - t1)
        c = db._resize_image(gray)[0]
        canvases.setdefault(c.shape, c)
    print(f"pages detect split (host clock, mean ms a page over {len(imgs)} "
          f"pages; {card}): map {fwd * 1e3 / len(imgs):.2f} (resize, upload, "
          f"DB forward, fetch), host postprocessing "
          f"{post * 1e3 / len(imgs):.2f} (boxes, padding, order, column "
          f"split)", flush=True)
    for shape, c in sorted(canvases.items()):
        timed = {nb: host_and_device_ms(torch, lambda: db.forward_wire(
            np.stack([c] * nb)).cpu()) for nb in (1, 8)}
        print(f"DB forward_wire {shape[0]}x{shape[1]} (float32, TF32 off; "
              f"host ms a call with the upload and fetch / device busy ms "
              f"under torch.profiler; {card}): "
              + ", ".join(f"batch {nb} {h:.3f} / {d:.3f}"
                          for nb, (h, d) in timed.items()), flush=True)
    for m, o in bf16.items():
        h, d = host_and_device_ms(torch, lambda: o.process_documents(imgs),
                                  reps=2)
        print(f"pages {m} (bf16) process_documents of {len(imgs)} pages: "
              f"{h:.2f} ms host, device busy {d:.2f} ms ({100 * d / h:.1f}%; "
              f"{card})", flush=True)


def _f16_steps(np, a, b):
    """|a - b| in float16 steps (both float16 values)."""
    ia = np.asarray(a, np.float16).view(np.int16).astype(np.int32)
    ib = np.asarray(b, np.float16).view(np.int16).astype(np.int32)
    return np.abs(ia - ib)


def rotated_pages_phase(torch, np, drive, card):
    """Rotated pages and the CRAFT detector on the card at full width with
    the committed checkpoints, against kiri_tpu's stored answers: CRAFT's
    maps, quads, boxes and polygons; DB and CRAFT with deskew (angles and
    boxes); float32 texts with the single resample on and off, device
    preprocessing, enhancement and pooling; bf16 CER; the rotated pages'
    recall with deskew off and on. Then the CRAFT forward per canvas, the
    deskew stages' host ms, pages/s and the device's busy share."""
    from kiri_tpu_torch.detect import TextDetector
    from kiri_tpu_torch.detect.craft import resize_aspect_ratio
    from kiri_tpu_torch.detect.deskew import (estimate_skew,
                                              extract_crop_single_resample,
                                              rotate_image)
    from kiri_tpu_torch.evalpage import is_khmer, score_pages
    from kiri_tpu_torch.ops.preprocess import invert_if_dark
    from kiri_tpu_torch.pipeline import OCR
    from kiri_tpu_torch.smoke import load_smoke_pages

    fx = load_smoke_pages()
    pages = fx["pages"] + fx["rot_pages"]
    imgs = [p["image"] for p in pages]
    rot = list(range(len(fx["pages"]), len(pages)))
    stored = fx["results_rot"]
    ckpt = str(REPO / "models" / "model.safetensors")
    paths = {"db": str(REPO / "models" / "detector.safetensors"),
             "craft": str(REPO / "models" / "craft.safetensors")}

    def ocr(det="db", **kw):
        return OCR(ckpt, det_model_path=paths[det], det_method=det,
                   device="cuda", **kw)

    def on(which, o):
        return lambda: [o.process_document(im) if i in which else []
                        for i, im in enumerate(imgs)]

    # CRAFT against the stored maps, quads, boxes and polygons.
    craft_td = TextDetector("craft", paths["craft"], device="cuda")
    craft = craft_td.craft_detector
    worst, n_diff, n_all = 0, 0, 0
    for i, want in fx["craft_maps"].items():
        region, affinity, _ = craft.predict_maps(imgs[i])
        for got, w in zip((region, affinity), want):
            steps = _f16_steps(np, got, w)
            worst = max(worst, int(steps.max()))
            n_diff += int((steps > 0).sum())
            n_all += steps.size
    check(worst <= CRAFT_MAP_STEPS,
          f"rotated: CRAFT float16 region and affinity maps of pages "
          f"{sorted(fx['craft_maps'])} within {worst} float16 steps of "
          f"kiri_tpu's (tol {CRAFT_MAP_STEPS}); {n_diff} of {n_all} values "
          f"differ")
    quads = craft.detect_text_batch(imgs)
    same_q = sum(len(q) == len(w["quads"]) and all(
        np.array_equal(a, b) for (a, _), b in zip(q, w["quads"]))
        for q, w in zip(quads, fx["craft"]))
    boxes = craft_td.detect_lines_objects_batch(imgs)
    same_b = sum([b.bbox for b in bs] == w["boxes"]
                 for bs, w in zip(boxes, fx["craft"]))
    single = [craft_td.detect_lines_objects(im) for im in imgs]
    poly_page, poly_want = fx["craft_poly"]
    poly = craft.detect_text(imgs[poly_page], poly=True)
    poly_ok = len(poly) == len(poly_want) and all(
        np.array_equal(a, b) for (a, _), b in zip(poly, poly_want))
    check(same_q == same_b == len(imgs) and single == boxes and poly_ok,
          f"rotated: CRAFT quads equal kiri_tpu's on {same_q}/{len(imgs)} "
          f"pages ({sum(map(len, quads))} quads), TextDetector boxes on "
          f"{same_b}/{len(imgs)} (batched = single-page: {single == boxes}), "
          f"poly=True outlines of page {poly_page} equal: {poly_ok}")

    # Deskew: the applied angle, the boxes and their upright twins.
    for det in ("db", "craft"):
        td = TextDetector(det, paths[det], device="cuda", deskew=True)
        ok, n = True, 0
        for p in fx["rot_pages"]:
            want = p["deskew"][det]
            got = [b.bbox for b in td.detect_lines_objects(p["image"])]
            ok &= (td.last_deskew_angle == want["angle"]
                   and got == want["boxes"]
                   and [b.bbox for b in td.last_deskew_boxes]
                   == want["twins"])
            n += len(got)
        check(ok, f"rotated: {det} + deskew on the {len(rot)} rotated pages: "
              f"angles {[p['deskew'][det]['angle'] for p in fx['rot_pages']]}"
              f" and {n} boxes (and their upright twins) equal kiri_tpu's")
    est = [estimate_skew(im) for im in imgs]
    check(est == [float(a) for a in fx["skew_angles"]],
          f"rotated: estimate_skew of the {len(imgs)} pages equals "
          f"kiri_tpu's floats ({sum(abs(a) >= 1.0 for a in est)} pages at "
          f"1 degree or more)")

    # float32 against kiri_tpu's stored texts on identical boxes.
    def hold_f32(run, res):
        n, same, worst, bad = _stored_agree(res, stored[run])
        check(n > 0 and not bad and worst <= TOL_CONF_F32,
              f"rotated f32 {run}: {same}/{n} texts on identical boxes "
              f"equal kiri_tpu's stored texts ({sum(map(len, res))} lines), "
              f"max |conf diff| {worst:.2e} (tol {TOL_CONF_F32:g})"
              + (f"; first differences {bad[:3]}" if bad else ""))
        return res

    f32 = "stem_fused_f32"
    per_page = {}
    for m in ("fast", "accurate"):
        o = ocr(decode_method=m, use_fp16=False, deskew=True)
        per_page[f"db_{m}"] = hold_f32(f"db_deskew_{m}_f32", drive(
            f"rotated f32 db deskew {m}", on(rot, o), (f32,)))
        o.deskew_single_resample = False
        hold_f32(f"db_deskew_{m}_f32_twostep", drive(
            f"rotated f32 db deskew {m} two-step", on(rot, o), (f32,)))
    dev = ocr(decode_method="fast", use_fp16=False, deskew=True,
              preprocess="device")
    hold_f32("db_deskew_fast_f32_device", drive(
        "rotated f32 db deskew fast preprocess=device", on(rot, dev),
        (f32, "preprocess_lines")))
    noisy = next(i for i, p in zip(rot, fx["rot_pages"])
                 if p["spec"][3].endswith("noisy"))
    enh = ocr(decode_method="fast", use_fp16=False, deskew=True,
              enhance=True)
    hold_f32("db_deskew_fast_f32_enhance", drive(
        "rotated f32 db deskew fast enhance (despike, linear warps)",
        on((noisy,), enh), (f32,)))
    every = range(len(imgs))
    for m in ("fast", "accurate"):
        o = ocr("craft", decode_method=m, use_fp16=False)
        per_page[f"craft_{m}"] = hold_f32(f"craft_{m}_f32", drive(
            f"rotated f32 craft {m}", on(every, o), (f32,)))
    o = ocr("craft", decode_method="fast", use_fp16=False, deskew=True)
    hold_f32("craft_deskew_fast_f32", drive(
        "rotated f32 craft deskew fast", on(rot, o), (f32,)))
    o.deskew_single_resample = False
    hold_f32("craft_deskew_fast_f32_twostep", drive(
        "rotated f32 craft deskew fast two-step", on(rot, o), (f32,)))
    # Pooled against per page.
    for det, key, kw in (("db", "db_fast", dict(deskew=True)),
                         ("craft", "craft_fast", {})):
        o = ocr(det, decode_method="fast", use_fp16=False, **kw)
        which = rot if det == "db" else every
        pooled = drive(f"rotated f32 {det} fast process_documents",
                       lambda: o.process_documents([imgs[i] for i in which]),
                       (f32,))
        want = [per_page[key][i] for i in which]
        n, same, worst, bad = _stored_agree(pooled, want)
        check(n == sum(map(len, want)) == sum(map(len, pooled)) and not bad
              and worst <= TOL_CONF_F32,
              f"rotated f32 {det} fast: process_documents over {len(which)} "
              f"pages gives the per-page boxes and texts on {same}/{n} "
              f"lines, max |conf diff| {worst:.2e}")

    # bf16 against the ground truth, and the recall with deskew off and on.
    gates = {"fast": CER_MAX, "accurate": CER_MAX_DECODER}
    scripts = {"Khmer": is_khmer, "English": lambda t: not is_khmer(t)}
    bf16_res = {}
    for det, m, which, kw in (
            ("db", "fast", rot, dict(deskew=True)),
            ("db", "accurate", rot, dict(deskew=True)),
            ("craft", "fast", every, {}),
            ("craft", "accurate", every, {})):
        run = f"{det}{'_deskew' if kw else ''}_{m}_bf16"
        o = ocr(det, decode_method=m, use_fp16=True, **kw)
        res = drive(f"rotated bf16 {run}", on(which, o), ("stem_fused",))
        bf16_res[run] = res
        sel = [pages[i] for i in which]
        got = [res[i] for i in which]
        ref_res = [stored[run][i] for i in which]
        ours = {k: score_pages(sel, got, f) for k, f in scripts.items()}
        ref = {k: score_pages(sel, ref_res, f) for k, f in scripts.items()}
        limit = {k: max(gates[m], ref[k]["matched_cer"] + PAGE_CER_SLACK)
                 for k in scripts}
        alls, refs = score_pages(sel, got), score_pages(sel, ref_res)
        check(all(ours[k]["matched_cer"] <= limit[k] for k in scripts),
              f"rotated bf16 {run} over {len(which)} pages: line CER "
              + ", ".join(f"{k} {ours[k]['matched_cer']:.4f} (max "
                          f"{limit[k]:.4f}; kiri_tpu "
                          f"{ref[k]['matched_cer']:.4f})" for k in scripts)
              + f"; line recall {alls['line_recall']:.4f} (kiri_tpu "
              f"{refs['line_recall']:.4f}) of {alls['gt_lines']} lines, "
              f"end2end_cer {alls['end2end_cer']:.4f}, doc_cer "
              f"{alls['doc_cer']:.4f}")
    # The same pages without deskew: for the recall and CER it costs (the
    # skewed crops read as badly in kiri_tpu, so no CER gate applies).
    o = ocr(decode_method="fast", use_fp16=True)
    bf16_res["db_fast_bf16"] = drive("rotated bf16 db_fast_bf16 (no deskew)",
                                     on(rot, o), ("stem_fused",))
    sel = [pages[i] for i in rot]
    recall = {k: score_pages(sel, [bf16_res[r][i] for i in rot])
              for k, r in (("off", "db_fast_bf16"),
                           ("on", "db_deskew_fast_bf16"))}
    ref_off = score_pages(sel, [stored["db_fast_bf16"][i] for i in rot])
    check(recall["on"]["line_recall"] >= recall["off"]["line_recall"]
          and recall["on"]["end2end_cer"] < recall["off"]["end2end_cer"],
          f"rotated pages, DB fast bf16 ({card}): line recall deskew off "
          f"{recall['off']['line_recall']:.4f} -> on "
          f"{recall['on']['line_recall']:.4f} over "
          f"{recall['on']['gt_lines']} lines; end2end_cer "
          f"{recall['off']['end2end_cer']:.4f} -> "
          f"{recall['on']['end2end_cer']:.4f} (kiri_tpu without deskew: "
          f"recall {ref_off['line_recall']:.4f}, end2end_cer "
          f"{ref_off['end2end_cer']:.4f})")

    # The CRAFT forward per canvas: host and device ms, peak memory, FFT.
    canvases = {}
    for im in imgs:
        c, _ = resize_aspect_ratio(invert_if_dark(im), craft.canvas_size,
                                   craft.mag_ratio)
        canvases.setdefault(c.shape, c)
    for shape, c in sorted(canvases.items()):
        parts = []
        for nb in (1, 8):
            batch = np.stack([c] * nb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            h, dv, fft = host_and_device_ms(
                torch, lambda: craft.forward_maps(batch).cpu(), reps=3,
                match="fft")
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            parts.append(f"batch {nb} {h:.3f} / {dv:.3f} ms (FFT kernels "
                         f"{fft:.3f} ms), peak {peak:.0f} MiB")
        print(f"CRAFT forward_maps {shape[0]}x{shape[1]} (float32, TF32 off; "
              f"host ms a call with the upload and fetch / device busy ms "
              f"under torch.profiler; {card}): " + ", ".join(parts),
              flush=True)
    # Host ms of the deskew stages, on the rotated pages.
    t_est = t_rot = t_crop = 0.0
    n_crops = 0
    for p in fx["rot_pages"]:
        im = p["image"]
        t0 = time.perf_counter()
        angle = estimate_skew(im)
        t1 = time.perf_counter()
        rotate_image(im, -angle)
        t2 = time.perf_counter()
        for box in p["deskew"]["db"]["twins"]:
            extract_crop_single_resample(im, angle, box, 48,
                                         fill=int(np.median(im)))
            n_crops += 1
        t3 = time.perf_counter()
        t_est, t_rot, t_crop = (t_est + t1 - t0, t_rot + t2 - t1,
                                t_crop + t3 - t2)
    k = len(fx["rot_pages"])
    print(f"deskew host ms a page (mean over {k} rotated 640x640 pages; "
          f"{card}): estimate_skew {t_est * 1e3 / k:.2f}, rotate_image "
          f"{t_rot * 1e3 / k:.2f}, single-resample crops "
          f"{t_crop * 1e3 / k:.2f} ({n_crops / k:.1f} crops a page)",
          flush=True)
    # pages/s and the device's busy share, bf16 "fast".
    for name, det, kw, src in (("CRAFT", "craft", {}, imgs),
                               ("DB + deskew", "db", dict(deskew=True),
                                [imgs[i] for i in rot])):
        o = ocr(det, decode_method="fast", use_fp16=True, **kw)
        many = [src[i % len(src)] for i in range(PAGES_TIMED)]
        o.process_documents(src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.process_documents(many)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        h, dv = host_and_device_ms(torch, lambda: o.process_documents(src),
                                   reps=2)
        print(f"pages {name} fast (bf16; {card}): process_documents of "
              f"{PAGES_TIMED} pages {PAGES_TIMED / dt:.2f} pages/s "
              f"({dt * 1e3 / PAGES_TIMED:.2f} ms a page); over {len(src)} "
              f"pages {h:.2f} ms host, device busy {dv:.2f} ms "
              f"({100 * dv / h:.1f}%)", flush=True)


def _tree(boxes):
    return [[list(b.bbox), b.level.value, _tree(b.children)] for b in boxes]


def _timed_stages(det):
    """Wrap the classic-CV detector's stages on ``det`` with host timers:
    returns {stage: seconds} that the calls add to, and {stage + " max":
    the slowest call's seconds}. The connected components of the candidate
    scoring are ``_binarize`` less the candidate sweep."""
    spent = {}
    for name in ("_binary_candidates", "_binarize", "_mser_components",
                 "_gradient_components", "_nms_boxes", "_group_into_lines"):
        fn = getattr(det, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            dt = time.perf_counter() - t0
            spent[_name] = spent.get(_name, 0.0) + dt
            spent[_name + " max"] = max(spent.get(_name + " max", 0.0), dt)
            return out
        setattr(det, name, timed)
    return spent


def legacy_pages_phase(torch, np, drive, card):
    """The classic-CV detector and word-level pages on the card at full
    width, against kiri_tpu's stored answers on the 13 pages (9 upright, 3
    rotated, the colour page): every box list of the detector's levels,
    legacy + deskew, blocks over DB lines; float32 "fast" texts of
    ``det_method="legacy"`` and of ``mode="words"``; bf16 line CER; device
    preprocessing of words; the ``predict`` command line as a subprocess;
    ``create_report``. Then host ms by stage, pages/s and the device's busy
    share."""
    from kiri_tpu_torch.detect import TextDetector
    from kiri_tpu_torch.detect.legacy import ImageProcessingTextDetector
    from kiri_tpu_torch.evalpage import is_khmer, score_pages
    from kiri_tpu_torch.native import cvops as native_cvops
    from kiri_tpu_torch.pipeline import OCR
    from kiri_tpu_torch.renderer import DocumentRenderer
    from kiri_tpu_torch.smoke import load_smoke_pages
    from kiri_tpu_torch.utils.imageio import imwrite_png, png_to_bgr, read_png

    fx = load_smoke_pages()
    leg = fx["legacy"]
    color = leg["color_page"]
    gt_pages = fx["pages"] + fx["rot_pages"] + [
        {"lines": fx["pages"][0]["lines"], "texts": fx["pages"][0]["texts"]}]
    imgs = [p["image"] for p in fx["pages"] + fx["rot_pages"]] + [color]
    stored = fx["results_legacy"]
    ckpt = str(REPO / "models" / "model.safetensors")
    det_path = str(REPO / "models" / "detector.safetensors")

    # The native library is built at first use: before any timing.
    t0 = time.perf_counter()
    native_cvops.get_lib()
    print(f"legacy: native/cvops.cpp built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # The detector's levels, page by page, and the host ms of its stages.
    det = ImageProcessingTextDetector()
    spent = _timed_stages(det)
    levels = {"lines": det.detect_lines, "words": det.detect_words,
              "blocks": det.detect_blocks, "chars": det.detect_characters}
    bad, per_page_ms = [], []
    for i, im in enumerate(imgs):
        t0 = time.perf_counter()
        got = {"lines": levels["lines"](im)}
        per_page_ms.append((time.perf_counter() - t0) * 1e3)
        for k in ("words", "blocks", "chars"):
            got[k] = levels[k](im)
        bad += [(i, k) for k in levels if got[k] != leg[k][i]]
        if _tree(det.detect_all(im)) != leg["all"][i]:
            bad.append((i, "all"))
    check(not bad, f"legacy: lines, words, blocks, characters and "
          f"detect_all equal kiri_tpu's stored answers on {len(imgs)} pages "
          f"({sum(map(len, leg['lines']))} lines, "
          f"{sum(map(len, leg['words']))} words, "
          f"{sum(map(len, leg['chars']))} characters)"
          + (f"; differing {bad[:6]}" if bad else ""))
    calls = 5 * len(imgs)   # every level computes the components again
    ms = {k: v * 1e3 / calls for k, v in spent.items()}
    scoring = ms["_binarize"] - ms["_binary_candidates"]
    print(f"legacy detector host ms a page (mean over {calls} level calls "
          f"on {len(imgs)} pages; {card}): candidate sweep "
          f"{ms['_binary_candidates']:.2f}, candidate scoring by connected "
          f"components {scoring:.2f}, MSER {ms['_mser_components']:.2f}, "
          f"gradient {ms['_gradient_components']:.2f}, NMS "
          f"{ms['_nms_boxes']:.2f}, grouping {ms['_group_into_lines']:.2f} "
          f"(its slowest call "
          f"{spent['_group_into_lines max'] * 1e3:.1f} ms); "
          f"detect_lines of the 1280x1280 page (12,058 components) "
          f"{per_page_ms[5]:.1f} ms, of all {len(imgs)} pages "
          + ", ".join(f"{v:.0f}" for v in per_page_ms)
          + " ms (kiri_tpu's detect_lines took 108-85,320 ms a page on "
          "another host's CPU, 85,320 on the 1280x1280 page)", flush=True)

    desk = TextDetector("legacy", deskew=True, device="cuda")
    ok = True
    for p in fx["rot_pages"]:
        want = p["deskew"]["legacy"]
        boxes = [b.bbox for b in desk.detect_lines_objects(p["image"])]
        ok &= (boxes == want["boxes"]
               and [b.bbox for b in desk.last_deskew_boxes] == want["twins"]
               and desk.last_deskew_angle == want["angle"])
    check(ok, f"legacy + deskew: angles, boxes and upright boxes of the "
          f"{len(fx['rot_pages'])} rotated pages equal kiri_tpu's")
    db = TextDetector("db", det_path, device="cuda")
    blocks = [db.detect_blocks(im) for im in imgs[:12]]
    check(blocks == fx["db_blocks"],
          f"blocks over DB lines equal kiri_tpu's on 12 pages "
          f"({sum(map(len, blocks))} blocks)")

    def ocr(**kw):
        return OCR(ckpt, det_model_path=det_path, device="cuda", **kw)

    def hold(run, res, what):
        want = stored[run]
        boxes_same = all([r["box"] for r in g] == [r["box"] for r in w]
                         for g, w in zip(res, want))
        n, same, worst, diff = _stored_agree(res, want)
        check(boxes_same and n == sum(map(len, want)) and not diff
              and worst <= TOL_CONF_F32,
              f"{what}: boxes of {len(res)} pages equal kiri_tpu's; {same}/{n}"
              f" texts equal its stored float32 texts, max |conf diff| "
              f"{worst:.2e} (tol {TOL_CONF_F32:g})"
              + (f"; first differences {diff[:3]}" if diff else ""))
        return res

    f32_leg = ocr(det_method="legacy", decode_method="fast", use_fp16=False)
    res_leg = hold("legacy_fast_f32", drive(
        "legacy f32 fast", lambda: [f32_leg.process_document(im)
                                    for im in imgs], ("stem_fused_f32",)),
        "legacy f32 fast")
    assert all(r["det_confidence"] == 1.0 for rs in res_leg for r in rs)
    f32_words = ocr(decode_method="fast", use_fp16=False)
    res_words = hold("words_fast_f32", drive(
        "words f32 fast", lambda: [f32_words.process_document(im,
                                                             mode="words")
                                   for im in imgs], ("stem_fused_f32",)),
        "words f32 fast")
    pooled = drive("legacy f32 fast process_documents",
                   lambda: f32_leg.process_documents(imgs),
                   ("stem_fused_f32",))
    n, same, worst, diff = _stored_agree(pooled, res_leg)
    check(n == sum(map(len, res_leg)) and not diff and worst <= TOL_CONF_F32,
          f"legacy f32 fast: process_documents over {len(imgs)} pages gives "
          f"the per-page results on {same}/{n} lines")
    # recognize_crops takes a page's crops in one batch, as kiri_tpu's
    # does: the pages of at most WORDS_DEVICE_MAX words.
    few = [i for i, w in enumerate(res_words) if len(w) <= WORDS_DEVICE_MAX]
    dev = ocr(decode_method="fast", use_fp16=False, preprocess="device")
    res_dev = drive("words f32 fast preprocess=device", lambda: [
        dev.process_document(imgs[i], mode="words") for i in few],
        ("stem_fused_f32", "preprocess_lines"))
    host = [res_words[i] for i in few]
    n, same, worst, _ = _stored_agree(res_dev, host)
    check(n == sum(map(len, host)),
          f"words f32 fast preprocess=device on pages {few}: the {n} word "
          f"boxes of the host run; {same}/{n} texts equal the "
          f"host-preprocessed ones (the kernel resizes in float32), max "
          f"|conf diff| {worst:.2e}")

    gates = {"Khmer": CER_MAX, "English": CER_MAX}
    scripts = {"Khmer": is_khmer, "English": lambda t: not is_khmer(t)}
    bf16 = ocr(det_method="legacy", decode_method="fast", use_fp16=True)
    res = drive("legacy bf16 fast", lambda: [bf16.process_document(im)
                                             for im in imgs], ("stem_fused",))
    ours = {k: score_pages(gt_pages, res, f) for k, f in scripts.items()}
    ref = {k: score_pages(gt_pages, stored["legacy_fast_bf16"], f)
           for k, f in scripts.items()}
    limit = {k: max(gates[k], ref[k]["matched_cer"] + PAGE_CER_SLACK)
             for k in scripts}
    check(all(ours[k]["matched_cer"] <= limit[k] for k in scripts),
          "legacy bf16 fast: line CER " + ", ".join(
              f"{k} {ours[k]['matched_cer']:.4f} (max {limit[k]:.4f}; "
              f"kiri_tpu {ref[k]['matched_cer']:.4f}), line recall "
              f"{ours[k]['line_recall']:.4f}" for k in scripts))

    # The command line as a user runs it, and the report.
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        page = Path(tmp) / "color_page.png"
        imwrite_png(page, color)
        out = Path(tmp) / "out"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kiri_tpu_torch.cli", "predict", str(page),
             "--no-render", "--mode", "words", "--det-method", "legacy",
             "-o", str(out)], cwd=REPO, capture_output=True, text=True,
            timeout=600)
        dt = time.perf_counter() - t0
        cli_ok = proc.returncode == 0
        if cli_ok:
            cli_res = json.loads((out / "ocr_results.json").read_text())
            cli_text = (out / "extracted_text.txt").read_text()
            text, want = OCR(ckpt, det_method="legacy",
                             device="cuda").extract_text(str(page),
                                                         mode="words")
            strip = [[{k: v for k, v in r.items() if k != "confidence"}
                      for r in rs] for rs in (cli_res, want)]
            worst = max((abs(a["confidence"] - b["confidence"])
                         for a, b in zip(cli_res, want)), default=0.0)
            cli_ok = strip[0] == strip[1] and cli_text == text \
                and worst <= 1e-5
        check(cli_ok, f"python -m kiri_tpu_torch.cli predict --no-render "
              f"--mode words --det-method legacy on the colour page (a PNG "
              f"the port wrote) in {dt:.1f} s: ocr_results.json and "
              f"extracted_text.txt equal the in-process extract_text"
              + ("" if proc.returncode == 0 else
                 f"; exit {proc.returncode}: {proc.stderr[-2000:]}"))
        report = Path(tmp) / "report.html"
        DocumentRenderer().create_report(str(page), res_leg[12], str(report))
        html = report.read_text()
        b64 = html.split("data:image/png;base64,", 1)[1].split('"', 1)[0]
        back = png_to_bgr(read_png(base64.b64decode(b64)))
        check(np.array_equal(back, color) and f"{len(res_leg[12])} regions"
              in html, f"create_report: the report's embedded PNG decodes "
              f"to the page, {len(res_leg[12])} regions listed")

    # pages/s and the device's busy share, bf16 "fast".
    for name, kw, mode in (("legacy", dict(det_method="legacy"), "lines"),
                           ("words", {}, "words")):
        o = ocr(decode_method="fast", use_fp16=True, **kw)
        o.process_documents(imgs[:2], mode=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.process_documents(imgs, mode=mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        h, dv = host_and_device_ms(
            torch, lambda: o.process_documents(imgs[:1], mode=mode), reps=3)
        print(f"pages {name} fast (bf16; {card}): process_documents of "
              f"{len(imgs)} pages {len(imgs) / dt:.3f} pages/s "
              f"({dt * 1e3 / len(imgs):.1f} ms a page); page 0 {h:.2f} ms "
              f"host, device busy {dv:.2f} ms ({100 * dv / h:.1f}%)",
              flush=True)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _falls(losses) -> bool:
    return bool(sum(losses[-5:]) / 5 < sum(losses[:5]) / 5)


def training_phase(torch, np, drive, card):
    """The trainers on the card against kiri_tpu's stored step-0 numbers,
    each run with the launch counters at 0 (see the module's docstring,
    item 8)."""
    import shutil

    from kiri_tpu_torch.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu_torch.detect import TextDetector
    from kiri_tpu_torch.detect.craft import load_craft_checkpoint
    from kiri_tpu_torch.detect.craft.net import build_craft_net
    from kiri_tpu_torch.detect.craft.train import CRAFTTrainConfig, train_craft
    from kiri_tpu_torch.detect.db import load_db_checkpoint
    from kiri_tpu_torch.detect.db.net import build_db_net
    from kiri_tpu_torch.detect.db.train import DBTrainConfig, train_db
    from kiri_tpu_torch.engine import RecognizerEngine
    from kiri_tpu_torch.smoke import (load_smoke_lines, load_smoke_train,
                                      write_detector_dataset)
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train import trainer as T

    ckpt = REPO / "models" / "model.safetensors"
    d, _ = load_smoke_lines()
    st = load_smoke_train()
    imgs, widths = d["imgs"], d["widths"]
    texts = [str(t) for t in d["texts"]]
    is_kh = [any(0x1780 <= ord(c) <= 0x17FF for c in t) for t in texts]
    samples = [{"image": im, "text": t} for im, t in zip(imgs, texts)]
    tmp = Path(tempfile.mkdtemp(prefix="kiri_train_"))
    # PyTorch's default TF32 flags (cuDNN's on), not main()'s: the trainers
    # keep TF32 out of their float32 steps themselves.
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    tf32 = [f.allow_tf32 for f in flags]
    flags[0].allow_tf32, flags[1].allow_tf32 = True, False
    try:
        def fresh(**kw):
            model, cfg, meta = load_checkpoint(ckpt, device="cuda")
            cfg = cfg.replace(**kw)
            vocab = find_vocab_file(meta.get("vocab_path", ""), str(ckpt))
            return model, cfg, CharTokenizer(vocab, cfg), vocab

        # (a) float32 step 0, and the same step in float64 (the train
        # forward is generic in its dtype), against kiri_tpu's float64 run
        # of it; kiri_tpu's float32 numbers are printed beside.
        model, cfg32, tok, vocab = fresh(COMPUTE_DTYPE="float32", DROPOUT=0.0)
        batch32 = T.collate([samples[i] for i in st["rec_idx"]], tok, 512,
                            img_hw=(cfg32.IMG_H, cfg32.IMG_W))
        tr = T.Trainer(cfg32, tok, T.TrainConfig(), model=model,
                       device="cuda")
        model64, _, _, _ = fresh()
        tr64 = T.Trainer(cfg32, tok, T.TrainConfig(), model=model64.double(),
                         device="cuda")
        tr64.dtype = torch.float64
        m, m64 = drive("train f32 and f64 step 0", lambda: [
            tr.run_step(batch32), tr64.run_step(batch32)], ())
        keys = ("loss", "ctc_loss", "dec_loss", "grad_norm")
        ref = {k: float(st[f"rec_step0_f64_{k}"]) for k in keys}
        ref32 = {k: float(st[f"rec_step0_{k}"]) for k in keys}
        e32 = {k: _rel(m[k], ref[k]) for k in keys}
        e64 = {k: _rel(m64[k], ref[k]) for k in keys}
        check(all(v <= (TOL_TRAIN_GRAD_NORM if k == "grad_norm"
                        else TOL_TRAIN_STEP0) for k, v in e32.items())
              and max(e64.values()) <= TOL_TRAIN_F64,
              f"train step 0 ({len(batch32['image'])} lines, width "
              f"{cfg32.IMG_W}) against kiri_tpu's float64 run: " + "; ".join(
                  f"{k} {ref[k]!r}: f32 {m[k]!r} (rel {e32[k]:.1e}), f64 "
                  f"{m64[k]!r} (rel {e64[k]:.1e}); kiri_tpu f32 "
                  f"{ref32[k]!r} (the port's f32 rel {_rel(m[k], ref32[k]):.1e})"
                  for k in keys)
              + f"; tol f32 {TOL_TRAIN_STEP0:g} (grad_norm "
              f"{TOL_TRAIN_GRAD_NORM:g}), f64 {TOL_TRAIN_F64:g}")
        del tr, model, tr64, model64

        # (b) train_loop, bf16, dropout 0.15, warm start; every step recorded.
        _, cfg, tok, vocab = fresh()
        steps, step_ms = [], []
        run_step = T.Trainer.run_step

        def recorded(self, batch):
            t0 = time.perf_counter()
            out = run_step(self, batch)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(out)
            return out

        tc = T.TrainConfig(epochs=TRAIN_EPOCHS, batch_size=TRAIN_BATCH,
                           lr=TRAIN_LR, out_dir=str(tmp / "rec"), seed=0,
                           log_every=0)
        torch.cuda.reset_peak_memory_stats()
        T.Trainer.run_step = recorded
        try:
            trainer = drive("train bf16 train_loop", lambda: [T.train_loop(
                cfg, tok, tc, samples * TRAIN_REPEAT, samples,
                vocab_path=vocab, from_model=str(ckpt), verbose=False,
                device="cuda")], ("stem_fused",))[0]
        finally:
            T.Trainer.run_step = run_step
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [s["loss"] for s in steps]
        hist = trainer.history
        check(len(losses) == TRAIN_EPOCHS * TRAIN_REPEAT
              and all(np.isfinite(losses)) and _falls(losses),
              f"train bf16 train_loop: {len(losses)} steps, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (first five mean "
              f"{sum(losses[:5]) / 5:.4f}, last five {sum(losses[-5:]) / 5:.4f})"
              f"; val CTC exact {hist[-1].get('val_ctc_acc', 0):.3f}, AR "
              f"{hist[-1].get('val_ar_acc', 0):.3f}; files "
              f"{sorted(p.name for p in (tmp / 'rec').iterdir())[:4]}...")
        chunk = (samples * TRAIN_REPEAT)[:TRAIN_BATCH]
        t0 = time.perf_counter()
        for _ in range(10):
            batch64 = T.collate(chunk, tok, tc.max_seq_len,
                                img_hw=(cfg.IMG_H, cfg.IMG_W))
        collate_ms = (time.perf_counter() - t0) * 1e2
        host, busy = host_and_device_ms(
            torch, lambda: trainer.run_step(batch64), reps=5)
        steady = float(np.median(step_ms[2:]))
        print(f"train recognizer (bf16, batch {TRAIN_BATCH}, 48x640, "
              f"{card}): {1e3 / (steady + collate_ms):.2f} steps/s, "
              f"{TRAIN_BATCH * 1e3 / (steady + collate_ms):.1f} lines/s; "
              f"host ms a step: collate {collate_ms:.2f}, step {steady:.2f} "
              f"(median of train_loop's steps 3-{len(step_ms)}); profiled "
              f"step {host:.2f} ms host, device busy {busy:.2f} ms "
              f"({100 * busy / host:.1f}%); peak memory {peak:.2f} GiB",
              flush=True)
        del trainer

        # (c) the saved checkpoint through the engine, within the CER gates.
        eng = RecognizerEngine.from_checkpoint(
            str(tmp / "rec" / "latest.safetensors"), device="cuda")
        for method, cer_max in (("ctc", CER_MAX), ("decoder",
                                                   CER_MAX_DECODER)):
            res = drive(f"train: saved checkpoint {method}",
                        lambda: eng.recognize_batch(imgs, method, widths),
                        ("stem_fused",))
            hyp = [t for t, _ in res]
            kh = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if k])
            en = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if not k])
            check(kh <= cer_max and en <= cer_max,
                  f"train: the saved checkpoint reads the smoke lines "
                  f"({method}, bf16) at Khmer CER {kh:.4f}, English CER "
                  f"{en:.4f} (max {cer_max})")
        del eng

        # (d) decoder-only steps leave the CTC head's logits bit-identical.
        model, cfg, tok, _ = fresh()
        tr = T.Trainer(cfg, tok, T.TrainConfig(train_only="decoder",
                                               lr=TRAIN_LR, seed=0),
                       model=model, total_steps=10, device="cuda")
        x = torch.from_numpy(imgs).cuda()
        dec_w = model.dec_head.weight.detach().clone()

        def ctc_logits():
            with torch.no_grad():
                return model.ctc_logits(model.encode(x, tr.dtype))

        def decoder_steps():
            before = ctc_logits()
            batch = T.collate(samples, tok, 512, img_hw=(cfg.IMG_H,
                                                         cfg.IMG_W))
            out = [tr.run_step(batch) for _ in range(10)]
            return out, before, ctc_logits()

        out, before, after = drive("train decoder-only", decoder_steps,
                                   ("stem_fused",))
        check(torch.equal(before, after)
              and not torch.equal(dec_w, model.dec_head.weight),
              f"train decoder-only: 10 steps (dec loss "
              f"{out[0]['dec_loss']:.4f} -> {out[-1]['dec_loss']:.4f}) leave "
              f"the CTC logits bit-identical, the decoder head moved")
        del tr, model

        # (e) a float32 run resumed at epoch 1 ends where the whole run ends.
        _, cfg32, tok, vocab = fresh(COMPUTE_DTYPE="float32")

        def run(name, resume):
            tc = T.TrainConfig(epochs=2, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                               out_dir=str(tmp / name), seed=0, log_every=0)
            return T.train_loop(cfg32, tok, tc, samples * 2, samples[:8],
                                vocab_path=vocab, from_model=str(ckpt),
                                verbose=False, resume=resume, device="cuda")

        def resumed():
            whole = run("whole", False)
            (tmp / "cut").mkdir()
            for suffix in (".safetensors", "_meta.json", "_optim_torch.npz"):
                shutil.copy(tmp / "whole" / f"model_epoch_1{suffix}",
                            tmp / "cut" / f"latest{suffix}")
            return [whole, run("cut", True)]

        whole, cut = drive("train f32 resume", resumed, ("stem_fused_f32",))
        scale = max(float(p.detach().abs().max())
                    for p in whole.model.parameters())
        diff = max(float((p - q).abs().max()) for p, q in
                   zip(whole.model.parameters(), cut.model.parameters()))
        la, lb = whole.history[-1]["loss"], cut.history[-1]["loss"]
        check(cut.step == whole.step > 0 and diff <= TOL_TRAIN_RESUME * scale
              and _rel(lb, la) <= TOL_TRAIN_RESUME,
              f"train f32 resume: resumed at epoch 1, step {cut.step} as the "
              f"whole run's {whole.step}; max |weight diff| {diff:.2e} (scale "
              f"{scale:.2f}, tol {TOL_TRAIN_RESUME:g} of it), epoch-2 loss "
              f"{lb:.6f} vs {la:.6f}")
        del whole, cut

        # (f) the detector trainers on the fixture's documents.
        root = write_detector_dataset(tmp / "det", st["det_images"],
                                      st["det_annotations"])
        page = st["det_images"][0]
        for kind in ("db", "craft"):
            hist = []
            if kind == "db":
                net = build_db_net(load_db_checkpoint(
                    REPO / "models" / "detector.safetensors"))
                tc = DBTrainConfig(steps=DET_STEPS, batch_size=4, lr=TRAIN_LR,
                                   data_dir=root, out_dir=str(tmp / kind),
                                   log_every=0)
                saved = tmp / kind / "detector.safetensors"
                fn, ref = train_db, "detector.safetensors"
                parts = ("loss", "prob_loss", "bin_loss", "thresh_loss")
            else:
                net = build_craft_net(load_craft_checkpoint(
                    REPO / "models" / "craft.safetensors"))
                tc = CRAFTTrainConfig(steps=DET_STEPS, batch_size=4,
                                      lr=TRAIN_LR, data_dir=root,
                                      out_dir=str(tmp / kind), log_every=0)
                saved = tmp / kind / "last.safetensors"
                fn, ref = train_craft, "craft.safetensors"
                parts = ("loss",)
            drive(f"train {kind}", lambda: [fn(tc, verbose=False, net=net,
                                               device="cuda", history=hist)],
                  ())
            losses = [h["loss"] for h in hist]
            errs = {k: _rel(hist[0][k], float(st[f"{kind}_step0_{k}"]))
                    for k in parts}
            n_new = len(TextDetector(kind, str(saved),
                                     device="cuda").detect_lines(page))
            n_ref = len(TextDetector(kind, str(REPO / "models" / ref),
                                     device="cuda").detect_lines(page))
            check(max(errs.values()) <= TOL_TRAIN_STEP0
                  and all(np.isfinite(losses)) and _falls(losses)
                  and n_new >= max(1, n_ref // 2),
                  f"train {kind}: f32 step 0 " + ", ".join(
                      f"{k} {hist[0][k]:.6f} vs kiri_tpu "
                      f"{float(st[f'{kind}_step0_{k}']):.6f} (rel "
                      f"{errs[k]:.1e})" for k in parts)
                  + f"; loss {losses[0]:.5f} -> {losses[-1]:.5f} over "
                  f"{len(losses)} steps; the saved file finds {n_new} lines "
                  f"on a fixture page ({n_ref} with {ref})")
            tc.out_dir = str(tmp / f"{kind}_timed")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(tc, verbose=False, net=net, device="cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"train {kind} (f32, TF32 off, batch 4, "
                  f"{page.shape[0]}x{page.shape[1]}, {card}): "
                  f"{DET_STEPS / dt:.2f} steps/s over {DET_STEPS} steps "
                  "(data load and one checkpoint write included)",
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for f, on in zip(flags, tf32):
            f.allow_tf32 = on


class _Recorder:
    """An OCR whose ``process_document`` results are kept as [box, text]."""

    def __init__(self, ocr):
        self.ocr, self.pages = ocr, []

    def process_document(self, img):
        res = self.ocr.process_document(img)
        self.pages.append([[list(map(int, r["box"])), r["text"]]
                           for r in res])
        return res


def _plain(x):
    """Tuples as lists, as a JSON round trip gives them."""
    return json.loads(json.dumps(x, ensure_ascii=False))


def generators_phase(torch, np, drive, card):
    """The synthetic-data generators on the host and their device paths,
    against ``kiri_tpu``'s answers in ``assets/smoke_gen.npz`` (see the
    module's docstring, item 9)."""
    import random
    import shutil

    from kiri_tpu_torch import cli, evalpage
    from kiri_tpu_torch.data import docsynth as D
    from kiri_tpu_torch.data import synth as S
    from kiri_tpu_torch.detect.craft import load_craft_checkpoint
    from kiri_tpu_torch.detect.craft.net import build_craft_net
    from kiri_tpu_torch.detect.craft.train import (CRAFTTrainConfig,
                                                   scale_generators,
                                                   train_craft)
    from kiri_tpu_torch.detect.craft.train import make_batch as craft_batch
    from kiri_tpu_torch.detect.db import load_db_checkpoint
    from kiri_tpu_torch.detect.db.net import build_db_net
    from kiri_tpu_torch.detect.db.train import DBTrainConfig, train_db
    from kiri_tpu_torch.detect.db.train import make_batch as db_batch
    from kiri_tpu_torch.pipeline import OCR
    from kiri_tpu_torch.smoke import (GEN_AUG, GEN_BATCH, GEN_CHAIN,
                                      GEN_DOC_SIZE, GEN_DOC_SIZES,
                                      GEN_EVAL_CONDITIONS, GEN_EVAL_PAGES,
                                      GEN_GENERATE, GEN_LINES, GEN_POOL,
                                      GEN_RESCALE, GEN_SCALE_AUG, GEN_SEED,
                                      cond_seed, digest, load_smoke_gen,
                                      tree_digests)
    from kiri_tpu_torch.utils.imageio import imread_gray

    # The fixture was drawn with the pseudo-glyph pool: discovery off here
    # too, whatever fonts this machine holds.
    S._FONT_DIRS[:] = []
    fx = load_smoke_gen()
    print(f"gen: fixture made with {fx['versions']}; here numpy "
          f"{np.__version__}, Pillow "
          f"{'present' if S.pillow_modules() else 'absent'}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="kiri_smoke_gen_"))
    ckpt = REPO / "models" / "model.safetensors"
    det_path = str(REPO / "models" / "detector.safetensors")
    try:
        # (a) lines through generate_dataset.
        t0 = time.perf_counter()
        gen = S.MultilingualDatasetGenerator(
            str(tmp / "lines"), khmer_ratio=0.5, sign_boost=0.3,
            seed=GEN_SEED, fonts=S.FontManager(font_dirs=[]))
        gen.generate_dataset(GEN_LINES)
        dt = time.perf_counter() - t0
        labels = (tmp / "lines" / "labels.txt").read_text(encoding="utf-8")
        got = [digest(imread_gray(tmp / "lines" / "images"
                                  / row.split("\t")[0]))
               for row in labels.splitlines()]
        same = sum(a == b for a, b in zip(got, fx["lines_digests"]))
        check(labels == fx["lines_labels"] and same == GEN_LINES == len(got),
              f"gen lines: {same}/{GEN_LINES} images equal kiri_tpu's, "
              f"labels.txt {'identical' if labels == fx['lines_labels'] else 'DIFFERENT'}")
        print(f"gen lines (host, pseudo-glyph pool, augmented, {card}): "
              f"{GEN_LINES / dt:.1f} lines/s, {1e3 * dt / GEN_LINES:.2f} ms "
              "a line, PNG writing included", flush=True)

        # (b) one document per layout, every condition, a chain, a rescale.
        docs = fx["docs"]
        dg = D.DocumentGenerator(GEN_DOC_SIZE, GEN_DOC_SIZE, khmer_ratio=0.4,
                                 fonts=S.FontManager(font_dirs=[],
                                                     sizes=GEN_DOC_SIZES))
        bad, n, t_doc, t_cond = [], 0, 0.0, {}

        def hold(key, d):
            want = docs[key]
            ok = (digest(d["image"]) == want["digest"]
                  and _plain([d["lines"], d["texts"], d["chars"]])
                  == [want["lines"], want["texts"], want["chars"]])
            if not ok:
                bad.append(key)

        for layout in D.LAYOUTS:
            t0 = time.perf_counter()
            doc = dg.generate(layout)
            t_doc += time.perf_counter() - t0
            hold(layout, doc)
            n += 1
            for cond in (*D.CONDITIONS, GEN_CHAIN):
                rng = random.Random(cond_seed(layout, cond))
                t0 = time.perf_counter()
                d = doc
                for c in cond.split("+"):
                    d = D.apply_condition(d, c, rng)
                t_cond[cond] = t_cond.get(cond, 0.0) + (
                    time.perf_counter() - t0)
                hold(f"{layout}/{cond}", d)
                n += 1
            if layout == D.LAYOUTS[0]:
                hold("rescale", D.rescale_doc(doc, GEN_RESCALE, GEN_RESCALE))
                n += 1
        check(not bad, f"gen documents: {n - len(bad)}/{n} documents (6 "
              f"layouts, each under {len(D.CONDITIONS)} conditions and "
              f"{GEN_CHAIN}, a {GEN_RESCALE}^2 rescale) equal kiri_tpu's "
              f"images, lines, texts and chars"
              + (f"; differ: {bad[:6]}" if bad else ""))
        n_lay = len(D.LAYOUTS)
        print(f"gen documents (host, {GEN_DOC_SIZE}^2, {card}): "
              f"{n_lay / t_doc:.2f} docs/s ({1e3 * t_doc / n_lay:.1f} ms a "
              "document); ms a condition: " + ", ".join(
                  f"{c} {1e3 * t / n_lay:.1f}" for c, t in t_cond.items()),
              flush=True)

        # (c) generate-detector through the command line.
        t0 = time.perf_counter()
        rc = cli.main(["generate-detector", "--num-train", "8", "--num-val",
                       "2", "--kind", "both", "--output", str(tmp / "det")])
        dt = time.perf_counter() - t0
        files = tree_digests(tmp / "det")
        diff = sorted(k for k in set(files) | set(fx["detector_files"])
                      if files.get(k) != fx["detector_files"].get(k))
        check(rc == 0 and not diff,
              f"gen generate-detector: {len(files)} files (images, "
              f"annotations.json, GT .npy) equal kiri_tpu's"
              + (f"; differ: {diff[:5]}" if diff else ""))
        print(f"gen generate-detector (host, 10 documents of "
              f"{GEN_DOC_SIZE}^2 with both detectors' GT, {card}): "
              f"{10 / dt:.2f} docs/s", flush=True)

        # (d) the detector trainers' live pools, then training from them.
        n_pool = GEN_POOL // GEN_BATCH
        for kind in ("db", "craft"):
            gen = D.DocumentGenerator(GEN_DOC_SIZE, GEN_DOC_SIZE,
                                      seed=GEN_SEED, khmer_ratio=0.3)
            if kind == "db":
                def make():
                    return db_batch(gen, GEN_BATCH, GEN_DOC_SIZE, GEN_AUG)
            else:
                small = scale_generators(CRAFTTrainConfig(
                    image_size=GEN_DOC_SIZE, seed=GEN_SEED, khmer_ratio=0.3,
                    scale_aug=GEN_SCALE_AUG), gen)

                def make():
                    return craft_batch(gen, GEN_BATCH, GEN_DOC_SIZE, GEN_AUG,
                                       None, GEN_SCALE_AUG, small)
            pool = [make() for _ in range(n_pool)]
            got = [{k: digest(v) for k, v in b.items()} for b in pool]
            check(got == fx[f"{kind}_batches"],
                  f"gen {kind} make_batch: {n_pool} live batches of "
                  f"{GEN_BATCH} ({', '.join(pool[0])}) equal kiri_tpu's")
            del pool
            common = dict(steps=DET_STEPS, batch_size=GEN_BATCH,
                          lr=TRAIN_LR, image_size=GEN_DOC_SIZE,
                          pool_size=GEN_POOL, aug_conditions=GEN_AUG,
                          seed=GEN_SEED, khmer_ratio=0.3, log_every=0,
                          out_dir=str(tmp / kind))
            if kind == "db":
                tc, fn = DBTrainConfig(**common), train_db
                parts = ("loss", "prob_loss", "bin_loss", "thresh_loss")

                def net():
                    return build_db_net(load_db_checkpoint(det_path))
            else:
                tc = CRAFTTrainConfig(**common, scale_aug=GEN_SCALE_AUG)
                fn, parts = train_craft, ("loss",)

                def net():
                    return build_craft_net(load_craft_checkpoint(
                        REPO / "models" / "craft.safetensors"))
            hist = []
            drive(f"gen {kind} live pool", lambda: [fn(
                tc, verbose=False, net=net(), device="cuda", history=hist)],
                ())
            want = fx[f"{kind}_step0"]
            errs = {k: _rel(hist[0][k], want[k]) for k in parts}
            losses = [h["loss"] for h in hist]
            check(len(hist) == DET_STEPS and max(errs.values())
                  <= TOL_TRAIN_STEP0 and all(np.isfinite(losses)),
                  f"gen train {kind} live (pool_size {GEN_POOL}): f32 step 0 "
                  + ", ".join(f"{k} {hist[0][k]:.6f} vs kiri_tpu "
                              f"{want[k]:.6f} (rel {errs[k]:.1e})"
                              for k in parts)
                  + f" (tol {TOL_TRAIN_STEP0:g}); loss {losses[0]:.5f} -> "
                  f"{losses[-1]:.5f} over {len(losses)} steps")
            # Speeds: two runs that differ only in their steps, so the set-up,
            # the pool and the checkpoint write cancel out.
            def timed(pool_size, steps):
                tc.pool_size, tc.steps = pool_size, steps
                tc.out_dir = str(tmp / f"{kind}_{pool_size}_{steps}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(tc, verbose=False, net=net(), device="cuda")
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            t_pool = max(1e-6, (timed(GEN_POOL, 2 * GEN_TIMED_STEPS)
                                - timed(GEN_POOL, GEN_TIMED_STEPS))
                         / GEN_TIMED_STEPS)
            t_fresh = max(1e-6, (timed(0, 6) - timed(0, 2)) / 4)
            t0 = time.perf_counter()
            for _ in range(4):
                make()
            t_make = (time.perf_counter() - t0) / 4
            print(f"gen train {kind} live ({card}; f32, TF32 off, batch "
                  f"{GEN_BATCH}, {GEN_DOC_SIZE}^2): from the pool "
                  f"{1 / t_pool:.2f} steps/s; pool_size 0 {1 / t_fresh:.2f} "
                  f"steps/s, of which {100 * (1 - t_pool / t_fresh):.1f}% "
                  f"is making the batch on the host; make_batch alone "
                  f"{1e3 * t_make:.0f} ms a batch (mean of 4; conditions "
                  "vary the cost)", flush=True)

        # (e) generate, then train the recognizer on it through the CLI.
        t0 = time.perf_counter()
        rc = cli.main(["generate", "-n", str(GEN_GENERATE), "-o",
                       str(tmp / "gen")])
        dt = time.perf_counter() - t0
        lab = (tmp / "gen" / "labels.txt").read_text(encoding="utf-8")
        files = tree_digests(tmp / "gen")
        dig = hashlib.sha256("".join(
            v for k, v in files.items() if k.endswith(".png"))
            .encode()).hexdigest()
        check(rc == 0 and lab == fx["generate_labels"]
              and dig == fx["generate_digest"],
              f"gen generate -n {GEN_GENERATE}: labels.txt and every image "
              f"equal kiri_tpu's ({GEN_GENERATE / dt:.1f} lines/s on the "
              "host)")
        labels_file = str(tmp / "gen" / "labels.txt")
        out_dir = tmp / "rec"
        rc = drive("gen train recognizer (CLI, bf16)", lambda: [cli.main([
            "train", "--train-labels", labels_file, "--val-labels",
            labels_file, "--epochs", "5", "--batch-size", "64",
            "--from-model", str(ckpt), "--vocab",
            str(REPO / "models" / "vocab.json"), "--output-dir",
            str(out_dir), "--device", "cuda"])], ("stem_fused",))
        hist = json.loads((out_dir / "history.json").read_text())
        check(rc == [0] and len(hist) == 5
              and all(np.isfinite(h["loss"]) and "val_ctc_acc" in h
                      for h in hist)
              and (out_dir / "latest.safetensors").exists(),
              f"gen train recognizer: 5 epochs of 2 steps on the generated "
              f"lines (loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
              f"val acc {hist[-1].get('val_ctc_acc', float('nan')):.4f}), "
              "checkpoints written")

        # (f) eval_condition on the card, float32 and bf16.
        rows = fx["eval_rows"]
        for name, kw, needs in (
                ("f32", dict(use_fp16=False), ("stem_fused_f32",)),
                ("bf16", dict(use_fp16=True, preprocess="device"),
                 ("stem_fused", "preprocess_lines"))):
            ocr = OCR(str(ckpt), det_model_path=det_path, device="cuda", **kw)
            t_all, pages = 0.0, 0
            for cond in GEN_EVAL_CONDITIONS:
                rec = _Recorder(ocr)
                t0 = time.perf_counter()
                row = drive(f"gen eval {name} {cond}", lambda: [
                    evalpage.eval_condition(rec, cond, GEN_EVAL_PAGES,
                                            page=GEN_DOC_SIZE)], needs)[0]
                t_all += time.perf_counter() - t0
                pages += row["docs"]
                want = rows[name][cond]
                if name == "f32":
                    n, same, _, diff = _same_texts(rec.pages, want["texts"])
                    check(row == want["row"] and not diff,
                          f"gen eval f32 {cond}: row {row} "
                          + ("equals" if row == want["row"] else "DIFFERS from")
                          + f" kiri_tpu's; {same}/{n} texts on identical "
                          "boxes equal" + (f"; differ: {diff[:2]}"
                                           if diff else ""))
                else:
                    w = want["row"]
                    check(row["line_recall"] == w["line_recall"]
                          and row["matched_cer"] <= w["matched_cer"]
                          + PAGE_CER_SLACK and row["end2end_cer"]
                          <= w["end2end_cer"] + PAGE_CER_SLACK,
                          f"gen eval bf16 {cond}: recall "
                          f"{row['line_recall']} (kiri_tpu {w['line_recall']}"
                          f"), matched CER {row['matched_cer']} (kiri_tpu "
                          f"{w['matched_cer']} + {PAGE_CER_SLACK}), end2end "
                          f"{row['end2end_cer']} ({w['end2end_cer']}), doc "
                          f"{row['doc_cer']}")
            print(f"gen eval_condition {name} ({card}): {pages} pages of "
                  f"{GEN_DOC_SIZE}^2 in {t_all:.1f} s = "
                  f"{pages / t_all:.2f} pages/s (generation and conditions "
                  "on the host included)", flush=True)
            del ocr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _norm_cfg(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _same_results(got, want):
    """(lines compared, boxes identical, texts differing on identical boxes,
    largest confidence difference there, every box within PAGE_BOX_TOL px
    and the counts equal) of two runs' pages of result dicts."""
    n = ident = 0
    worst, bad, near = 0.0, [], True
    for g, w in zip(got, want):
        near &= len(g) == len(w)
        n += len(w)
        for r, s in zip(g, w):
            near &= max(abs(a - b) for a, b in zip(r["box"], s["box"])) \
                <= PAGE_BOX_TOL
            if list(r["box"]) != list(s["box"]) or \
                    r["line_number"] != s["line_number"]:
                continue
            ident += 1
            worst = max(worst, abs(r["confidence"] - s["confidence"]))
            if r["text"] != s["text"]:
                bad.append((r["text"], s["text"]))
    return n, ident, bad, worst, near


def model_files_phase(torch, np, drive, card):
    """The model files the port serves from, against kiri_tpu's answers in
    ``smoke_models.npz``: (a) four other formats of the committed
    recognizer through ``RecognizerEngine.from_checkpoint`` and ``OCR``;
    (b) ``KiriOCR``; (c) the PP-OCR DB graph through the ONNX interpreter:
    maps, quads, the batched path, pages, and the forward per canvas; (d)
    Khmer cluster CER. Each device run with the counters at 0."""
    from kiri_tpu_torch import smoke as S
    from kiri_tpu_torch.checkpoints import find_vocab_file
    from kiri_tpu_torch.config import CFG
    from kiri_tpu_torch.detect import TextDetector
    from kiri_tpu_torch.detect.db import DBDetector
    from kiri_tpu_torch.engine import RecognizerEngine
    from kiri_tpu_torch.models.recognizer import KiriOCR
    from kiri_tpu_torch.ops.preprocess import invert_if_dark, to_gray
    from kiri_tpu_torch.pipeline import OCR
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.utils.khmer import corpus_cluster_cer

    import shutil

    t_phase = time.perf_counter()
    fx = S.load_smoke_models()
    d, _ = S.load_smoke_lines()
    imgs, widths = d["imgs"], d["widths"]
    texts = [str(t) for t in d["texts"]]
    is_kh = [any(0x1780 <= ord(c) <= 0x17FF for c in t) for t in texts]
    pages = [p["image"] for p in S.load_smoke_pages()["pages"]]
    ckpt = REPO / "models" / "model.safetensors"
    det_path = str(REPO / "models" / "detector.safetensors")
    tmp = Path(tempfile.mkdtemp(prefix="kiri_models_"))
    try:
        # (a) Every format through RecognizerEngine.from_checkpoint.
        files = S.write_model_formats(ckpt, tmp)
        for fmt, path in files.items():
            eng = RecognizerEngine.from_checkpoint(path, device="cuda")
            check(_norm_cfg(eng.cfg.to_dict()) == _norm_cfg(fx["cfgs"][fmt]),
                  f"models {fmt}: config equal to kiri_tpu's (ENC_HEADS "
                  f"{eng.cfg.ENC_HEADS}, KHMER_VISUAL_ORDER "
                  f"{eng.cfg.KHMER_VISUAL_ORDER}, {eng.cfg.COMPUTE_DTYPE})")
            eng32 = RecognizerEngine(eng.model, eng.cfg.replace(
                COMPUTE_DTYPE="float32"), eng.tok, device="cuda")
            for m in ("ctc", "decoder"):
                res = drive(f"models {fmt} f32 {m}",
                            lambda: eng32.recognize_batch(imgs, m, widths),
                            ("stem_fused_f32",))
                want = [str(t) for t in fx[f"{fmt}_{m}_texts_f32"]]
                diff = [i for i, ((t, _), w) in enumerate(zip(res, want))
                        if t != w]
                dconf = np.abs(np.asarray([c for _, c in res])
                               - fx[f"{fmt}_{m}_conf_f32"]).max()
                check(not diff and dconf <= TOL_CONF_F32,
                      f"models {fmt} f32 {m}: {len(res) - len(diff)}/"
                      f"{len(res)} texts equal kiri_tpu's for this file, max "
                      f"|conf diff| {dconf:.2e} (tol {TOL_CONF_F32:g})"
                      + (f"; first differences {diff[:3]}" if diff else ""))
            if fmt == "f16_meta":
                res = drive("models f16_meta bf16 ctc",
                            lambda: eng.recognize_batch(imgs, "ctc", widths),
                            ("stem_fused",))
                hyp = [t for t, _ in res]
                kh = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if k])
                en = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh)
                          if not k])
                check(eng.dtype == torch.bfloat16 and kh <= CER_MAX
                      and en <= CER_MAX,
                      f"models f16_meta bf16 ctc: Khmer CER {kh:.4f}, "
                      f"English CER {en:.4f} (max {CER_MAX})")
            del eng, eng32
        OCR._model_cache.clear()
        ocr = OCR(files["pt_config"], det_model_path=det_path,
                  decode_method="fast", use_fp16=False, preprocess="device",
                  device="cuda")
        got = drive("models pt_config OCR f32 fast preprocess=device",
                    lambda: [ocr.process_document(pages[i])
                             for i in S.PT_OCR_PAGES],
                    ("stem_fused_f32", "preprocess_lines"))
        n, ident, bad, worst, near = _same_results(got, fx["pt_ocr"])
        check(near and ident > 0 and not bad and worst <= TOL_CONF_F32,
              f"models pt_config OCR: {n} lines on {len(got)} pages, "
              f"{ident} boxes identical to kiri_tpu's (every box within "
              f"{PAGE_BOX_TOL} px: {near}), texts equal on all of them, max "
              f"|conf diff| {worst:.2e}"
              + (f"; differences {bad[:3]}" if bad else ""))
        del ocr

        # (b) KiriOCR on the committed checkpoint in float32.
        meta = json.loads((REPO / "models" / "model_meta.json").read_text())
        cfg32 = CFG.from_dict(meta["config"]).replace(
            COMPUTE_DTYPE="float32")
        kiri = KiriOCR.from_checkpoint(str(ckpt), cfg=cfg32, device="cuda")
        x = np.ascontiguousarray(imgs[:S.KIRI_LINES, :, :S.KIRI_WIDTH])
        logits = drive("models KiriOCR f32 ctc_logits(encode)",
                       lambda: kiri.ctc_logits(kiri.encode(x)),
                       ("stem_fused_f32",))
        err = float(np.abs(logits.cpu().numpy()
                           - fx["kiri_logits_f32"]).max())
        check(err <= TOL_CONF_F32 and kiri.num_params() == int(
            fx["kiri_num_params"]),
              f"models KiriOCR: logits {tuple(logits.shape)} within "
              f"{err:.2e} of kiri_tpu's (tol {TOL_CONF_F32:g}); "
              f"num_params {kiri.num_params()} (kiri_tpu "
              f"{int(fx['kiri_num_params'])})")
        del kiri

        # (c) The PP-OCR DB graph, rebuilt from its seed.
        data = S.build_ppocr_det(seed=S.ONNX_SEED, conditioned=True,
                                 head_gain=S.ONNX_HEAD_GAIN,
                                 head_bias=S.ONNX_HEAD_BIAS)
        sha = hashlib.sha256(data).hexdigest()
        check(sha == str(fx["onnx_sha256"]),
              f"models onnx: graph rebuilt ({len(data)} bytes) with sha256 "
              f"{sha[:16]}... equal to the fixture's")
        onnx_path = tmp / "det.onnx"
        onnx_path.write_bytes(data)
        det = DBDetector(str(onnx_path), device="cuda")
        per_page = {}
        for i in S.ONNX_PAGES:
            canvas, (nh, nw), _ = det._resize_image(invert_if_dark(to_gray(
                pages[i])))
            wire = det.forward_wire(canvas[None]).cpu().numpy()[0]
            dmap = np.abs(wire.astype(np.int64) - fx[f"onnx_map_{i}"])
            check(wire.shape == fx[f"onnx_map_{i}"].shape
                  and dmap.max() <= PAGE_MAP_TOL,
                  f"models onnx page {i}: u16 map (canvas {canvas.shape}) "
                  f"within {int(dmap.max())} counts of kiri_tpu's (tol "
                  f"{PAGE_MAP_TOL}); {int((dmap > 0).sum())} of {dmap.size} "
                  "values differ")
            res = per_page[i] = det.detect_text(pages[i])
            want = fx["onnx_quads"][str(i)]
            margin = fx[f"onnx_margin_{i}"]
            if margin[0] > PAGE_MAP_TOL and margin[1] > PAGE_MAP_TOL / 65535:
                ok = len(res) == len(want) and all(
                    q.tolist() == wq and abs(s - ws) <= PAGE_MAP_TOL / 65535
                    for (q, s), (wq, ws) in zip(res, want))
                rule = "identical"
            else:
                ok = len(res) == len(want) and all(
                    np.abs(q - np.asarray(wq)).max() <= PAGE_BOX_TOL
                    for (q, _), (wq, _) in zip(res, want))
                rule = f"within {PAGE_BOX_TOL} px"
            check(ok, f"models onnx page {i}: {len(res)} quads {rule} to "
                      f"kiri_tpu's (stored margin {margin[0]:g} counts from "
                      f"the threshold, {margin[1]:.2e} of a box score)")
        batched = det.detect_text_batch([pages[i] for i in S.ONNX_PAGES])
        check(all(len(b) == len(per_page[i]) and all(
            np.array_equal(q, bq) and s == bs
            for (q, s), (bq, bs) in zip(per_page[i], b))
            for i, b in zip(S.ONNX_PAGES, batched)),
              "models onnx: detect_text_batch equals the per-page results")
        tdet = TextDetector("db", str(onnx_path), device="cuda")
        objs = tdet.detect_lines_objects_batch([pages[i]
                                                for i in S.ONNX_PAGES])
        check(all([b.bbox for b in o] == tdet.detect_lines(pages[i])
                  for i, o in zip(S.ONNX_PAGES, objs)),
              "models onnx: TextDetector.detect_lines_objects_batch equals "
              "the per-page lines")
        del tdet
        OCR._model_cache.clear()
        ocr = OCR(str(ckpt), det_model_path=str(onnx_path),
                  decode_method="fast", use_fp16=False, device="cuda")
        got = drive("models onnx OCR f32 fast",
                    lambda: [ocr.process_document(pages[i])
                             for i in S.ONNX_OCR_PAGES], ("stem_fused_f32",))
        n, ident, bad, worst, near = _same_results(got, fx["onnx_ocr"])
        check(near and ident == n > 0 and not bad and worst <= TOL_CONF_F32,
              f"models onnx OCR: {n} lines on {len(got)} pages, {ident} "
              f"boxes identical to kiri_tpu's, texts equal on all, max "
              f"|conf diff| {worst:.2e}"
              + (f"; differences {bad[:3]}" if bad else ""))
        del ocr
        for i in S.ONNX_PAGES:
            canvas, _, _ = det._resize_image(invert_if_dark(to_gray(
                pages[i])))
            for nb in (1, 8):
                batch = np.repeat(canvas[None], nb, axis=0)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                host, busy = host_and_device_ms(
                    torch, lambda: det.forward_wire(batch).cpu())
                peak = torch.cuda.max_memory_allocated() / 2 ** 20
                print(f"onnx DB forward_wire {canvas.shape[0]}x"
                      f"{canvas.shape[1]} batch {nb} (PP-OCR MobileNetV3 "
                      f"x0.5 + DBFPN(96), float32, TF32 off; upload and "
                      f"u16 map fetched): {host / nb:.3f} ms per canvas on "
                      f"the host clock, device busy {busy / nb:.3f} ms per "
                      f"canvas (profiler), peak {peak:.0f} MiB [{card}]",
                      flush=True)
        del det

        # (d) Khmer cluster CER.
        ours = corpus_cluster_cer(texts, [str(t) for t in
                                          d["batch_texts_f32"]])
        check(ours == float(fx["khmer_cluster_cer"]),
              f"models khmer: corpus cluster CER of kiri_tpu's stored f32 "
              f"ctc texts {ours!r} equals kiri_tpu's "
              f"{float(fx['khmer_cluster_cer'])!r}")
        eng = RecognizerEngine.from_checkpoint(str(ckpt), device="cuda")
        kh_refs = [t for t, k in zip(texts, is_kh) if k]
        for m in ("ctc", "decoder", "beam"):
            res = drive(f"models bf16 {m} (cluster CER)",
                        lambda: eng.recognize_batch(imgs, m, widths),
                        ("stem_fused",))
            hyp = [t for (t, _), k in zip(res, is_kh) if k]
            cp = (sum(lev(unicodedata.normalize("NFC", r),
                          unicodedata.normalize("NFC", h))
                      for r, h in zip(kh_refs, hyp))
                  / max(1, sum(len(unicodedata.normalize("NFC", r))
                               for r in kh_refs)))
            print(f"khmer bf16 {m}: cluster CER "
                  f"{corpus_cluster_cer(kh_refs, hyp):.4f}, codepoint CER "
                  f"{cp:.4f} (corpus, {len(kh_refs)} Khmer smoke lines)",
                  flush=True)
        del eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"model-files phase: {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)


def _weights_close(np, got, want):
    """(max error, elements beyond atol 1e-5 + rtol 1e-4, elements): the
    parameters' tolerance of tests/test_sharding.py, every element held."""
    worst, beyond, total = 0.0, 0, 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = w.astype(np.float64)
        err = np.abs(got[k].astype(np.float64) - w)
        worst = max(worst, float(err.max()))
        beyond += int((err > 1e-5 + 1e-4 * np.abs(w)).sum())
        total += w.size
    return worst, beyond, total


def parallel_phase(torch, np, drive, card):
    """More than one device on one card (see the module's docstring, item
    11). Returns each rank's launch counts of its engine runs."""
    import shutil
    import torch.distributed as dist

    from kiri_tpu_torch import parallel as P
    from kiri_tpu_torch.checkpoints import find_vocab_file, load_checkpoint
    from kiri_tpu_torch.detect.db import load_db_checkpoint
    from kiri_tpu_torch.detect.db.net import build_db_net
    from kiri_tpu_torch.detect.db.train import DBTrainConfig, train_db
    from kiri_tpu_torch.engine import RecognizerEngine
    from kiri_tpu_torch.parallel.launch import spawn
    from kiri_tpu_torch.smoke import (PAR_DP_STEPS, PAR_TP_STEPS,
                                      load_smoke_lines, load_smoke_train,
                                      parallel_train_batch,
                                      write_detector_dataset)
    from kiri_tpu_torch.tokenizer import CharTokenizer
    from kiri_tpu_torch.train import trainer as T

    t_phase = time.perf_counter()
    ckpt = REPO / "models" / "model.safetensors"
    d, crops = load_smoke_lines()
    imgs, widths = d["imgs"], d["widths"]
    texts = [str(t) for t in d["texts"]]
    is_kh = [any(0x1780 <= ord(c) <= 0x17FF for c in t) for t in texts]
    model, cfg, meta = load_checkpoint(ckpt, device="cuda")
    vocab = find_vocab_file(meta.get("vocab_path", ""), str(ckpt))
    tok = CharTokenizer(vocab, cfg)
    tmp = Path(tempfile.mkdtemp(prefix="kiri_parallel_"))

    def cer_ok(res, cer_max):
        hyp = [t for t, _ in res]
        kh = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if k])
        en = cer([(t, o) for t, o, k in zip(texts, hyp, is_kh) if not k])
        return kh <= cer_max and en <= cer_max, kh, en

    # (a) NCCL at world size 1, in this process, through a store on a port
    # the OS picks (a port chosen first and bound later may be taken).
    P.initialize(num_processes=1, process_id=0, store=dist.TCPStore(
        "127.0.0.1", 0, None, is_master=True, wait_for_workers=False))
    try:
        one = torch.ones(4, device="cuda")
        dist.all_reduce(one)
        mesh = P.make_mesh(1, 1)
        for dtype in ("bfloat16", "float32"):
            c = cfg.replace(COMPUTE_DTYPE=dtype)
            single = RecognizerEngine(model, c, tok, device="cuda")
            meshed = RecognizerEngine(model, c, tok, device="cuda", mesh=mesh)
            for method in ("ctc", "decoder"):
                want = single.recognize_batch(imgs, method, widths)
                got = drive(f"parallel NCCL world 1 {dtype} {method}",
                            lambda: meshed.recognize_batch(imgs, method,
                                                           widths),
                            ("stem_fused" if dtype == "bfloat16"
                             else "stem_fused_f32",))
                same = sum(a[0] == b[0] for a, b in zip(got, want))
                dconf = max(abs(a[1] - b[1]) for a, b in zip(got, want))
                check(same == len(want) and dconf <= TOL_PAR_CONF
                      and float(one[0]) == 1.0,
                      f"parallel (a): NCCL backend {dist.get_backend()}, "
                      f"world {dist.get_world_size()}, mesh {mesh.shape}: "
                      f"{dtype} {method}: {same}/{len(want)} texts equal the "
                      f"single-device engine's, max |conf diff| {dconf:.2e}")
    finally:
        P.shutdown()

    # The single card's answers for (b), before the ranks start.
    refs = {}
    for dtype in ("float32", "bfloat16"):
        eng = RecognizerEngine(model, cfg.replace(COMPUTE_DTYPE=dtype), tok,
                               device="cuda")
        refs[dtype] = {
            "batch": eng.recognize_batch(imgs, "ctc", widths),
            "batch_decoder": eng.recognize_batch(imgs, "decoder", widths),
            "crops": eng.recognize_crops(crops, "ctc")}
    eng.recognize_batch(imgs, "ctc", widths)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        eng.recognize_batch(imgs, "ctc", widths)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / 5
    del eng
    cfg32 = cfg.replace(COMPUTE_DTYPE="float32", DROPOUT=0.0)
    batch = parallel_train_batch(tok, cfg32)

    def trainer():
        fresh, _, _ = load_checkpoint(ckpt, device="cuda")
        return T.Trainer(cfg32, tok, T.TrainConfig(), model=fresh,
                         device="cuda")

    tr = trainer()
    ref_dp = [tr.run_step(batch) for _ in range(PAR_DP_STEPS)]
    ref_dp_state = {k: v.detach().cpu().numpy()
                    for k, v in tr.model.state_dict().items()}
    del tr
    tr = trainer()
    ref_tp = [tr.run_step(batch) for _ in range(PAR_TP_STEPS)]
    ref_tp_state = {k: v.detach().cpu().numpy()
                    for k, v in tr.model.state_dict().items()}
    del tr
    st = load_smoke_train()
    det_dir = write_detector_dataset(tmp / "det", st["det_images"],
                                     st["det_annotations"])
    ref_db = []
    train_db(DBTrainConfig(data_dir=det_dir, steps=1, batch_size=4,
                           log_every=0, out_dir=str(tmp / "db_ref")),
             verbose=False, net=build_db_net(load_db_checkpoint(
                 str(REPO / "models" / "detector.safetensors"))),
             device="cuda", history=ref_db)

    # (b) two gloo ranks on card 0.
    t0 = time.perf_counter()
    ranks = spawn("kiri_tpu_torch.smoke:parallel_rank", 2,
                  {"tmp": str(tmp), "det_dir": det_dir}, device="cuda:0",
                  backend="gloo", timeout=600, threads=4)
    spawn_s = time.perf_counter() - t0
    for r in ranks:
        for dtype in ("float32", "bfloat16"):
            for key in ("batch", "batch_decoder", "crops"):
                got, want = r[dtype][key], refs[dtype][key]
                if dtype == "float32":
                    same = sum(a[0] == b[0] for a, b in zip(got, want))
                    dconf = max(abs(a[1] - b[1]) for a, b in zip(got, want))
                    check(same == len(want) and dconf <= TOL_PAR_CONF,
                          f"parallel (b) rank {r['rank']}, TP 2, f32 {key}: "
                          f"{same}/{len(want)} texts equal the single card's,"
                          f" max |conf diff| {dconf:.2e} (tol "
                          f"{TOL_PAR_CONF:g})")
                else:
                    cap = CER_MAX_DECODER if "decoder" in key else CER_MAX
                    ok, kh, en = cer_ok(got, cap)
                    same = sum(a[0] == b[0] for a, b in zip(got, want))
                    check(ok, f"parallel (b) rank {r['rank']}, TP 2, bf16 "
                              f"{key}: Khmer CER {kh:.4f}, English CER "
                              f"{en:.4f} (max {cap}); {same}/{len(want)} "
                              "texts equal the single card's")
        dl = [abs(a["loss"] - b["loss"]) for a, b in zip(r["dp"], ref_dp)]
        check(len(dl) == PAR_DP_STEPS and max(dl) <= TOL_PAR_DP,
              f"parallel (b) rank {r['rank']}, DP 2: {PAR_DP_STEPS} f32 "
              f"steps, losses {[round(m['loss'], 6) for m in r['dp']]} "
              f"against the single card's "
              f"{[round(m['loss'], 6) for m in ref_dp]}, max diff "
              f"{max(dl):.2e} (tol {TOL_PAR_DP:g})")
        dt = abs(r["tp"][0]["loss"] - ref_tp[0]["loss"])
        check(dt <= TOL_PAR_TP,
              f"parallel (b) rank {r['rank']}, TP 2: step loss "
              f"{r['tp'][0]['loss']:.6f} against {ref_tp[0]['loss']:.6f}, "
              f"diff {dt:.2e} (tol {TOL_PAR_TP:g})")
        ddb = abs(r["db"][0]["loss"] - ref_db[0]["loss"]) / abs(
            ref_db[0]["loss"])
        check(ddb <= TOL_PAR_DB,
              f"parallel (b) rank {r['rank']}, DB trainer DP 2: step loss "
              f"{r['db'][0]['loss']:.6f} against {ref_db[0]['loss']:.6f} "
              f"(rel {ddb:.1e}, tol {TOL_PAR_DB:g})")
        check(r["restored_shards_equal"] and r["restored_moments_equal"]
              and r["files"] == [".metadata", "__0_0.distcp",
                                 "__1_0.distcp"],
              f"parallel (b) rank {r['rank']}: save_sharded wrote "
              f"{r['files']}; restore_sharded onto the mesh gives this "
              f"rank's shards and moments back: "
              f"{r['restored_shards_equal'] and r['restored_moments_equal']}")
        launches = {k: v for k, v in r["launches"].items() if v}
        check(r["launches"]["stem_fused"] > 0
              and r["launches"]["stem_fused_f32"] > 0
              and r["launches"]["preprocess_lines"] > 0,
              f"parallel (c) rank {r['rank']}: the engine runs launched "
              f"{launches}")
    for key, steps, want in (("dp", PAR_DP_STEPS, ref_dp_state),
                             ("tp", PAR_TP_STEPS, ref_tp_state)):
        for r in ranks:
            worst, beyond, total = _weights_close(np, r[f"{key}_state"], want)
            check(beyond == 0,
                  f"parallel (b) rank {r['rank']}, {key.upper()} 2: weights "
                  f"after {steps} f32 step(s) against the single card's: max "
                  f"|diff| {worst:.2e}, {beyond} of {total} beyond atol 1e-5,"
                  f" rtol 1e-4")
        worst, beyond, total = _weights_close(np, ranks[1][f"{key}_state"],
                                              ranks[0][f"{key}_state"])
        check(beyond == 0,
              f"parallel (b) {key.upper()} 2: rank 1's weights against rank "
              f"0's: max |diff| {worst:.2e}, {beyond} of {total} beyond atol "
              f"1e-5, rtol 1e-4")
    refmodel, _, _ = load_checkpoint(tmp / "reference.safetensors",
                                     device="cpu")
    tp_state = ranks[0]["tp_state"]
    same = all(np.array_equal(v.numpy(), tp_state[k]) for k, v in
               refmodel.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    check(same, f"parallel (b): to_reference of the two ranks' sharded "
                f"checkpoint loads with the TP trainer's whole weights: "
                f"{same}")

    # (d) a local Hugging Face dataset of the smoke lines.
    try:
        import datasets  # noqa: F401
    except ImportError as e:
        print(f"parallel (d): the datasets package does not import here "
              f"({type(e).__name__}: {e}); the Hugging Face dataset run is "
              "left out (a missing host package, not a device)", flush=True)
    else:
        hf_phase(np, tmp, d, cfg32, tok, ckpt)

    rank_ms = [r["tp_batch_ms"] for r in ranks]
    print(f"parallel ({card}): phase {time.perf_counter() - t_phase:.1f} s "
          f"(the two ranks {spawn_s:.1f} s with their start); bf16 \"ctc\" "
          f"recognize_batch of {len(imgs)} lines: TP 2 over gloo on one "
          f"card {', '.join(f'{m:.2f}' for m in rank_ms)} ms per rank, "
          f"single card {single_ms:.2f} ms", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return [r["launches"] for r in ranks]


def hf_phase(np, tmp, d, cfg32, tok, ckpt):
    """The smoke lines as a local image-folder dataset, loaded offline
    through ``load_hf_dataset`` (samples equal the committed lines) and one
    float32 train step from it on the card."""
    import os

    os.environ["HF_DATASETS_OFFLINE"] = "1"
    os.environ["HF_HUB_OFFLINE"] = "1"
    import datasets

    datasets.config.HF_DATASETS_OFFLINE = True
    datasets.config.HF_HUB_OFFLINE = True
    datasets.config.HF_DATASETS_CACHE = tmp / "hf_cache"
    from kiri_tpu_torch.checkpoints import load_checkpoint
    from kiri_tpu_torch.data.datasets import load_hf_dataset
    from kiri_tpu_torch.train import trainer as T
    from kiri_tpu_torch.utils.imageio import encode_png

    import csv

    root = tmp / "hf" / "train"
    root.mkdir(parents=True)
    with open(root / "metadata.csv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["file_name", "text"])
        for i, (img, text) in enumerate(zip(d["imgs"], d["texts"])):
            (root / f"{i}.png").write_bytes(encode_png(img))
            w.writerow([f"{i}.png", str(text)])
    train, val = load_hf_dataset([str(tmp / "hf")], img_h=cfg32.IMG_H,
                                 img_w=cfg32.IMG_W, val_ratio=0.25)
    samples = [train[i] for i in range(len(train))]
    same = 0
    for (src, text), s in zip(train.records, samples):
        i = int(Path(src["path"]).stem)
        same += (np.array_equal(s["image"], d["imgs"][i])
                 and text == str(d["texts"][i]))
    fresh, _, _ = load_checkpoint(ckpt, device="cuda")
    tr = T.Trainer(cfg32, tok, T.TrainConfig(batch_size=32), model=fresh,
                   device="cuda")
    m = tr.run_step(T.collate(samples[:32], tok, 512,
                              img_hw=(cfg32.IMG_H, cfg32.IMG_W)))
    check(len(train) == 48 and len(val) == 16 and same == len(samples)
          and np.isfinite(m["loss"]),
          f"parallel (d): datasets {datasets.__version__}: a local dataset "
          f"of the {len(d['imgs'])} smoke lines loads as {len(train)} train "
          f"/ {len(val)} val samples (seeded split), {same} of them the "
          f"committed lines' bytes; one f32 step from it, loss "
          f"{m['loss']:.4f}")


def _same_texts(got_pages, want_pages):
    """(lines, texts equal on identical boxes, boxes not identical, the
    differing texts) of two runs' [box, text] pages."""
    n = same = other = 0
    diff = []
    for g, w in zip(got_pages, want_pages):
        n += len(w)
        want = {tuple(b): t for b, t in w}
        for b, t in g:
            if tuple(b) not in want:
                other += 1
            elif want[tuple(b)] == t:
                same += 1
            else:
                diff.append((t, want[tuple(b)]))
    return n, same, other, diff


def host_and_device_ms(torch, fn, reps: int = 5, match: str = ""):
    """(host ms a call, synchronized; the device's busy ms a call: the sum
    of device-side events under torch.profiler), after one warm-up call.
    With ``match``, also the device ms a call of the events whose name
    holds it (case-insensitive)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps
    if not match:
        return host, busy
    hit = sum(e.time_range.elapsed_us() for e in dev
              if match.lower() in e.name.lower()) / 1e3 / reps
    return host, busy, hit


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
                else f"nvidia-smi failed: {smi.stderr.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


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

    card = card_name_power()
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

    kernels = [*stem_phase(torch, np, model, d["imgs"]),
               preprocess_phase(torch, np, crops)]
    counts, by_run = main_path_phase(torch, np, model, cfg, tok, d, crops)
    kernels += quant8_phase(torch, np, model, cfg, tok, d,
                            functools.partial(drive_run, counts, by_run), card)
    pages_phase(torch, np, functools.partial(drive_run, counts, by_run), card)
    rotated_pages_phase(torch, np, functools.partial(drive_run, counts,
                                                     by_run), card)
    legacy_pages_phase(torch, np, functools.partial(drive_run, counts,
                                                    by_run), card)
    training_phase(torch, np, functools.partial(drive_run, counts, by_run),
                   card)
    generators_phase(torch, np, functools.partial(drive_run, counts, by_run),
                     card)
    model_files_phase(torch, np, functools.partial(drive_run, counts, by_run),
                      card)
    for r, launches in enumerate(parallel_phase(
            torch, np, functools.partial(drive_run, counts, by_run), card)):
        by_run[f"parallel rank {r}"] = {k: v for k, v in launches.items()
                                        if v}
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["launches_by_run"] = {run: c[k["name"]] for run, c in by_run.items()
                                if k["name"] in c}

    print(card)
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
