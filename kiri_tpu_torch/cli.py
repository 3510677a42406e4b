"""The command line of the port (``kiri-tpu-torch``, or ``python -m
kiri_tpu_torch.cli``): the port of ``kiri_tpu/cli.py``.

``predict`` takes every flag of the JAX package's (a bare image path means
``predict``), ``--version`` and ``init-config`` too. What differs:

- ``--device`` is the card by default (``cuda``); ``cpu`` runs on the host;
  ``tpu`` is refused;
- an error exits with status 1 (the JAX package prints it and exits 0);
- unless ``--no-render`` is given, ``predict`` checks that Pillow imports
  (the result images draw glyphs with it) before any OCR work;
- ``train``, ``generate``, ``generate-detector`` and ``train-detector``
  are not ported yet: they exit with status 2 and name the ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

VERSION = "kiri-tpu-torch 0.1.0"

DEFAULT_TRAIN_CONFIG = {
    "epochs": 10,
    "batch_size": 32,
    "lr": 3e-4,
    "weight_decay": 0.01,
    "height": 48,
    "width": 640,
    "max_seq_len": 512,
    "ctc_weight": 0.5,
    "dec_weight": 0.5,
    "save_steps": 0,
    "output_dir": "checkpoints",
    "enc_dim": 256,
    "enc_layers": 4,
    "enc_heads": 8,
    "enc_ff": 1024,
    "dec_dim": 256,
    "dec_layers": 3,
    "dec_heads": 8,
    "dec_ff": 1024,
    "dropout": 0.15,
}

#: Commands of the JAX package's CLI that wait for training (ROADMAP
#: queue 1 item 5).
NOT_PORTED = {
    "train": "Train the recognizer",
    "generate": "Generate synthetic line dataset",
    "generate-detector": "Generate a synthetic detector dataset",
    "train-detector": "Train a text detector",
}

_COMMANDS = ("predict", *NOT_PORTED, "init-config", "-h", "--help",
             "--version")


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kiri-tpu-torch",
        description="Kiri-TPU document OCR (PyTorch/CUDA port)")
    parser.add_argument("--version", action="version", version=VERSION)
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("predict", help="Run OCR on one or more images")
    p.add_argument("image", nargs="+", metavar="IMAGE",
                   help="Path(s) to document image(s); multiple images are "
                        "recognized in one pooled pass")
    p.add_argument("--mode", choices=["lines", "words"], default="lines")
    p.add_argument("--model", default="models/model.safetensors")
    p.add_argument("--det-model", default=None)
    p.add_argument("--det-method", choices=["db", "craft", "legacy"],
                   default="db")
    p.add_argument("--decode-method",
                   choices=["fast", "accurate", "beam", "auto"],
                   default="accurate")
    p.add_argument("--padding", type=int, default=10)
    p.add_argument("--output", "-o", default="output")
    p.add_argument("--no-render", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, the default), cuda:N or cpu")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--stream", action="store_true",
                   help="LLM-style character streaming output")
    p.add_argument("--deskew", action="store_true",
                   help="Straighten skewed pages before detection")
    p.add_argument("--upload-bits", type=int, choices=(4, 8), default=8,
                   help="4: pack two pixels a byte for recognition "
                        "uploads (16 gray levels)")
    p.add_argument("--det-map-downsample", type=int, default=1,
                   help="DB detection maps at 1/N resolution (N must "
                        "divide 32)")
    p.add_argument("--enhance", action="store_true",
                   help="Adaptive crop cleanup for degraded captures")

    for name, text in NOT_PORTED.items():
        sub.add_parser(name, help=f"{text} (not ported yet)")

    ic = sub.add_parser("init-config", help="Create a training config file")
    ic.add_argument("--output", "-o", default="train_config.yaml")
    return parser


def _device(name: str) -> str:
    if name == "tpu" or not (name == "cpu" or name.startswith("cuda")):
        raise ValueError(
            f"--device {name!r}: the port runs on a CUDA card (cuda, "
            "cuda:N) or on the host (cpu); the TPU is the JAX package's "
            "(kiri-tpu)")
    return name


def _check_pillow() -> None:
    import importlib

    try:
        importlib.import_module("PIL.ImageFont")
    except ImportError:
        raise RuntimeError(
            "rendering the result images needs Pillow, which cannot be "
            "imported here; run predict with --no-render") from None


# ---------------------------------------------------------------------------
def run_inference(args) -> None:
    import numpy as np

    from .pipeline import OCR
    from .renderer import DocumentRenderer

    device = _device(args.device)
    if not args.no_render:
        _check_pillow()
    output_dir = Path(args.output)
    output_dir.mkdir(exist_ok=True, parents=True)

    if args.verbose:
        print("\n" + "=" * 70)
        print("  📄 Kiri-TPU OCR System")
        print("=" * 70)

    ocr = OCR(model_path=args.model, det_model_path=args.det_model,
              det_method=args.det_method, padding=args.padding,
              device=device, verbose=args.verbose,
              decode_method=args.decode_method, deskew=args.deskew,
              enhance=args.enhance, upload_bits=args.upload_bits,
              det_kwargs=({"det_map_downsample": args.det_map_downsample}
                          if args.det_map_downsample > 1 else None))

    images = args.image
    if args.stream:
        for image in images:
            run_streaming_inference(ocr, image, args, output_dir)
        return

    if len(images) == 1:
        if not args.verbose:
            print(f"Processing {images[0]}...")
        doc_results = [ocr.extract_text(images[0], mode=args.mode,
                                        verbose=args.verbose)]
    else:
        if not args.verbose:
            print(f"Processing {len(images)} images (pooled batch)...")
        doc_results = ocr.extract_text_batch(images, mode=args.mode,
                                             verbose=args.verbose)

    for image, (full_text, results) in zip(images, doc_results):
        # One image keeps the flat layout; many write a directory a page.
        doc_dir = (output_dir if len(images) == 1
                   else output_dir / Path(image).stem)
        doc_dir.mkdir(exist_ok=True, parents=True)
        (doc_dir / "extracted_text.txt").write_text(full_text,
                                                    encoding="utf-8")
        (doc_dir / "ocr_results.json").write_text(
            json.dumps(results, indent=2, ensure_ascii=False),
            encoding="utf-8")

        if not args.no_render:
            renderer = DocumentRenderer()
            renderer.draw_boxes(image, results,
                                output_path=str(doc_dir / "boxes.png"))
            renderer.draw_results(image, results,
                                  output_path=str(doc_dir / "ocr_result.png"))
            renderer.create_report(image, results,
                                   output_path=str(doc_dir / "report.html"))

        if args.verbose:
            print("\n" + "=" * 70)
            print("  ✅ Processing Complete!")
            print(f"  Regions detected: {len(results)}")
            if results:
                avg = np.mean([r["confidence"] for r in results]) * 100
                print(f"  Average confidence: {avg:.2f}%")
            print(f"  Output directory: {doc_dir}")
            print("=" * 70 + "\n")
        else:
            for res in results:
                print(res["text"])
            print(f"\n✓ Saved results to {doc_dir}")


def run_streaming_inference(ocr, image, args, output_dir: Path) -> None:
    """Character streaming to stdout."""
    print(f"Processing {image} (streaming)...\n")
    full_text_parts = []
    current_region = 0
    for chunk in ocr.extract_text_stream_chars(image, mode=args.mode):
        if chunk.get("region_start"):
            if current_region:
                sys.stdout.write("\n")
            current_region = chunk["region_number"]
            continue
        token = chunk.get("token", "")
        if token:
            sys.stdout.write(token)
            sys.stdout.flush()
            time.sleep(0.002)
        if chunk.get("document_finished"):
            full_text_parts.append(chunk.get("cumulative_text", ""))
    sys.stdout.write("\n")
    text = full_text_parts[-1] if full_text_parts else ""
    if len(args.image) > 1:
        output_dir = output_dir / Path(image).stem
        output_dir.mkdir(exist_ok=True, parents=True)
    (output_dir / "extracted_text.txt").write_text(text, encoding="utf-8")
    print(f"\n✓ Saved to {output_dir / 'extracted_text.txt'}")


def init_config(args) -> None:
    out = Path(args.output)
    lines = ["# Kiri-TPU training configuration",
             "# Values here override defaults; CLI flags override both.", ""]
    for k, v in DEFAULT_TRAIN_CONFIG.items():
        lines.append(f"{k}: {v}")
    out.write_text("\n".join(lines) + "\n", encoding="utf-8")
    print(f"✓ Config written to {out}")


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    """Run the command line; returns (and, as a script, exits with) the
    status: 0, 1 on an error, 2 for a command that is not ported."""
    argv = list(sys.argv[1:] if argv is None else argv)
    # A bare image path means predict.
    if argv and argv[0] not in _COMMANDS and not argv[0].startswith("-"):
        argv.insert(0, "predict")

    if argv and argv[0] in NOT_PORTED:
        print(f"kiri-tpu-torch {argv[0]}: not ported yet (ROADMAP queue 1 "
              "item 5, training); use kiri-tpu", file=sys.stderr)
        return 2
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.command == "init-config":
        init_config(args)
        return 0
    if args.command != "predict":
        parser.print_help()
        return 0
    try:
        run_inference(args)
    except Exception as e:  # the message, then a failing status
        print(f"\n❌ Error: {e}", file=sys.stderr)
        if args.verbose:
            import traceback

            traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
