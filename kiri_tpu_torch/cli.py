"""The command line of the port (``kiri-tpu-torch``, or ``python -m
kiri_tpu_torch.cli``): the port of ``kiri_tpu/cli.py``.

``predict``, ``train``, ``generate``, ``generate-detector`` and
``train-detector`` take every flag of the JAX package's (a bare image path
means ``predict``), and ``--version`` and ``init-config``. What differs:

- ``--device`` is the card by default (``cuda``); ``cpu`` runs on the host;
  ``tpu`` is refused;
- an error exits with status 1 (the JAX package prints it and exits 0);
- unless ``--no-render`` is given, ``predict`` checks that Pillow imports
  (the result images draw glyphs with it) before any OCR work;
- ``train --hf-dataset`` exits 1: HuggingFace datasets need the
  ``datasets`` package and the network (ROADMAP.md, the tail);
- ``train-detector`` trains from the live document generator unless
  ``--data-yaml`` is given; with it, the generator's flags (``--image-size``,
  ``--aug-weights`` ...) are named as ignored, as the JAX package ignores
  them;
- ``generate`` and ``generate-detector`` draw with the procedural
  pseudo-glyph fonts where Pillow is missing (the system's TrueType fonts
  need it); ``--fonts-dir`` and ``--font`` then exit 1;
- a config file is JSON, or the flat ``key: value`` YAML that
  ``init-config`` writes, read without PyYAML.
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

_COMMANDS = ("predict", "train", "generate", "generate-detector",
             "train-detector", "init-config", "-h", "--help", "--version")

# The reference's config-file spellings of the architecture knobs.
_REF_CFG_ALIASES = {
    "encoder_dim": "enc_dim", "encoder_layers": "enc_layers",
    "encoder_heads": "enc_heads", "encoder_ffn_dim": "enc_ff",
    "decoder_dim": "dec_dim", "decoder_layers": "dec_layers",
    "decoder_heads": "dec_heads", "decoder_ffn_dim": "dec_ff",
}
# Config-file keys outside DEFAULT_TRAIN_CONFIG; they fill in only where the
# flag was not given.
_CFG_PASSTHROUGH = (
    "train_labels", "val_labels", "vocab", "from_model", "resume",
    "device", "hf_dataset", "hf_subset", "hf_val_split", "hf_streaming")


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
    p.add_argument("--model", default="models/model.safetensors",
                   help="recognizer: .safetensors (with or without its "
                        "_meta.json), .pt, or a hub repo id")
    p.add_argument("--det-model", default=None,
                   help="detector: .safetensors, a PP-OCR DB .onnx, or a "
                        "hub repo id")
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

    _add_train_parser(sub)
    _add_generate_parsers(sub)
    _add_train_detector_parser(sub)

    ic = sub.add_parser("init-config", help="Create a training config file")
    ic.add_argument("--output", "-o", default="train_config.yaml")
    return parser


def _add_train_parser(sub) -> None:
    t = sub.add_parser("train", help="Train the recognizer")
    t.add_argument("--config", help="JSON or flat YAML config file")
    t.add_argument("--train-labels", help="Path to training labels.txt")
    t.add_argument("--val-labels", help="Path to validation labels.txt")
    t.add_argument("--hf-dataset", "--hf-datasets", nargs="+",
                   help="HuggingFace dataset ID(s) (not ported: needs the "
                        "datasets package and the network)")
    t.add_argument("--hf-subset", default=None)
    t.add_argument("--hf-train-split", default="train")
    t.add_argument("--hf-val-split", default=None)
    t.add_argument("--hf-streaming", action="store_true")
    t.add_argument("--hf-image-col", default="image")
    t.add_argument("--hf-text-col", default="text")
    t.add_argument("--hf-val-percent", type=float, default=0.1)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--weight-decay", type=float, default=None)
    t.add_argument("--vocab", help="Path to vocab.json (auto-built if absent)")
    t.add_argument("--height", type=int, default=None)
    t.add_argument("--width", type=int, default=None)
    t.add_argument("--max-seq-len", type=int, default=None)
    t.add_argument("--ctc-weight", type=float, default=None)
    t.add_argument("--dec-weight", type=float, default=None)
    t.add_argument("--save-steps", type=int, default=None)
    t.add_argument("--output-dir", default=None)
    t.add_argument("--from-model", help="Warm-start checkpoint")
    t.add_argument("--resume", action="store_true",
                   help="Resume from <output-dir>/latest.safetensors")
    t.add_argument("--device", default=None,
                   help="cuda (the card, the default), cuda:N or cpu")
    for short, long, dest in (
            ("--enc-dim", "--encoder-dim", "enc_dim"),
            ("--enc-layers", "--encoder-layers", "enc_layers"),
            ("--enc-heads", "--encoder-heads", "enc_heads"),
            ("--enc-ff", "--encoder-ffn-dim", "enc_ff"),
            ("--dec-dim", "--decoder-dim", "dec_dim"),
            ("--dec-layers", "--decoder-layers", "dec_layers"),
            ("--dec-heads", "--decoder-heads", "dec_heads"),
            ("--dec-ff", "--decoder-ffn-dim", "dec_ff")):
        t.add_argument(short, long, type=int, default=None, dest=dest)
    t.add_argument("--dropout", type=float, default=None)
    t.add_argument("--n-devices", type=int, default=None)
    t.add_argument("--model-parallel", type=int, default=1)
    t.add_argument("--select-metric", choices=["ctc", "ar", "mean"],
                   default="ctc", help="best-checkpoint criterion")
    t.add_argument("--train-only", choices=["decoder"], default=None,
                   help="'decoder' freezes encoder+CTC bit-exactly and "
                        "trains only the AR decode path")
    t.add_argument("--dec-input-noise", type=float, default=0.0,
                   help="P(corrupt a decoder-input token)")


def _add_generate_parsers(sub) -> None:
    g = sub.add_parser("generate", help="Generate synthetic line dataset")
    g.add_argument("--train-file", "-t", default=None,
                   help="Text file, one line per sample (random if omitted)")
    g.add_argument("--val-file", "-v", default=None,
                   help="Validation text file (else 10%% split of train-file)")
    g.add_argument("--output", "-o", default="data")
    g.add_argument("--num-samples", "-n", type=int, default=1000)
    g.add_argument("--language", "-l",
                   choices=["english", "khmer", "mixed"], default=None,
                   help="Script mix for random sampling (sets khmer-ratio)")
    g.add_argument("--augment", "-a", type=int, default=1,
                   help="Copies per train-file line (file-driven mode)")
    g.add_argument("--val-augment", type=int, default=1)
    g.add_argument("--height", type=int, default=48)
    g.add_argument("--width", type=int, default=None,
                   help="Max render width (over-wide lines are resized)")
    g.add_argument("--fonts-dir", default=None,
                   help="Extra font directory searched before system fonts "
                        "(needs Pillow)")
    g.add_argument("--font-mode", choices=["random", "all"], default="random",
                   help="'all' renders every capable font per line")
    g.add_argument("--random-augment", action="store_true",
                   help="Re-roll augmentation on/off per rendered copy")
    g.add_argument("--no-augment", action="store_true")
    g.add_argument("--append", action="store_true")
    g.add_argument("--khmer-ratio", type=float, default=0.0)

    gd = sub.add_parser("generate-detector",
                        help="Generate synthetic detector dataset")
    gd.add_argument("--text-file", default=None,
                    help="Corpus file for document lines (random if omitted); "
                         "'lang:file,lang:file' pairs are merged")
    gd.add_argument("--fonts-dir", default=None,
                    help="Extra font directory ('lang:dir,...' accepted; "
                         "needs Pillow)")
    gd.add_argument("--font", default=None,
                    help="Restrict rendering to one font file (needs Pillow)")
    gd.add_argument("--output", default="detector_dataset")
    gd.add_argument("--num-train", type=int, default=800)
    gd.add_argument("--num-val", type=int, default=200)
    gd.add_argument("--min-lines", type=int, default=None)
    gd.add_argument("--max-lines", type=int, default=None)
    gd.add_argument("--image-size", type=int, default=640)
    gd.add_argument("--image-height", type=int, default=None,
                    help="Document height (default: image-size)")
    gd.add_argument("--no-augment", action="store_true")
    gd.add_argument("--workers", type=int, default=1,
                    help="Accepted; generation runs in one process")
    gd.add_argument("--kind", choices=["db", "craft", "both"], default="both")
    gd.add_argument("--khmer-ratio", type=float, default=0.0)


#: train-detector's flags of the live generator: (flag, type, default).
_GENERATOR_FLAGS = (("--image-size", int, 640), ("--pool-size", int, 256),
                    ("--khmer-ratio", float, 0.3),
                    ("--aug-conditions", float, 0.0),
                    ("--aug-weights", None, None), ("--scale-aug", float, 0.0))


def _add_train_detector_parser(sub) -> None:
    td = sub.add_parser("train-detector", help="Train a text detector")
    td.add_argument("--detector", choices=["db", "craft"], default="db")
    td.add_argument("--data-yaml", default=None,
                    help="generate-detector output directory (or a file in "
                         "it); trains from disk instead of the live "
                         "generator pool")
    td.add_argument("--steps", type=int, default=2000)
    td.add_argument("--epochs", type=int, default=None,
                    help="With --data-yaml: passes over the dataset "
                         "(overrides --steps)")
    td.add_argument("--batch-size", type=int, default=8)
    td.add_argument("--lr", type=float, default=None)
    td.add_argument("--model-size", choices=["n", "s", "m", "l", "x"],
                    default="n", help="Accepted and ignored, as in kiri-tpu")
    td.add_argument("--name", default=None,
                    help="Run name -> runs/detect/<name>")
    td.add_argument("--output-dir", default=None)
    # The live generator's flags, ignored with --data-yaml.
    for flag, kind, default in _GENERATOR_FLAGS:
        td.add_argument(flag, type=kind, default=default,
                        help="the live generator's: ignored with --data-yaml")
    td.add_argument("--from-model", default=None,
                    help="warm-start detector weights (.safetensors)")
    td.add_argument("--device", default="cuda",
                    help="cuda (the card, the default), cuda:N or cpu")


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


def _scalar(text: str):
    """A flat YAML scalar: quoted string, bool, null, int, float, a
    [list], else the bare string."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    low = t.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("", "null", "~", "none"):
        return None
    if t.startswith("[") and t.endswith("]"):
        return [_scalar(v) for v in t[1:-1].split(",") if v.strip()]
    for cast in (int, float):
        try:
            return cast(t)
        except ValueError:
            pass
    return t


def load_config_file(path) -> dict:
    """A JSON config file, or a flat ``key: value`` YAML one (what
    ``init-config`` writes; ``#`` comments), read without PyYAML."""
    p = Path(path)
    text = p.read_text(encoding="utf-8")
    if p.suffix.lower() not in (".yaml", ".yml"):
        return json.loads(text)
    out = {}
    for n, line in enumerate(text.splitlines(), 1):
        line = line.split(" #")[0].rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        key, sep, value = line.partition(":")
        if not sep or line[0].isspace():
            raise ValueError(f"{path}:{n}: only flat 'key: value' lines are "
                             "read")
        out[key.strip()] = _scalar(value)
    return out


def merge_config(defaults, file_cfg, overrides) -> dict:
    """Defaults, then the file's known keys, then every flag that was
    given (not None)."""
    merged = dict(defaults)
    for k, v in (file_cfg or {}).items():
        if k in merged:
            merged[k] = v
    for k, v in overrides.items():
        if v is not None:
            merged[k] = v
    return merged


def run_train(args) -> None:
    from .config import CFG
    from .data.datasets import load_local_dataset
    from .tokenizer import CharTokenizer, build_vocab_from_texts
    from .train.trainer import TrainConfig, canonical_samples, train_loop

    file_cfg = load_config_file(args.config) if args.config else None
    if file_cfg:
        file_cfg = {_REF_CFG_ALIASES.get(k, k): v for k, v in file_cfg.items()}
        if isinstance(file_cfg.get("hf_dataset"), str):
            file_cfg["hf_dataset"] = [file_cfg["hf_dataset"]]
        for k in _CFG_PASSTHROUGH:
            if k in file_cfg and getattr(args, k, None) in (None, False):
                setattr(args, k, file_cfg[k])
    device = _device(args.device or "cuda")
    merged = merge_config(
        DEFAULT_TRAIN_CONFIG, file_cfg,
        {k: getattr(args, k, None) for k in DEFAULT_TRAIN_CONFIG})
    cfg = CFG(IMG_H=merged["height"], IMG_W=merged["width"],
              ENC_DIM=merged["enc_dim"], ENC_LAYERS=merged["enc_layers"],
              ENC_HEADS=merged["enc_heads"], ENC_FF=merged["enc_ff"],
              DEC_DIM=merged["dec_dim"], DEC_LAYERS=merged["dec_layers"],
              DEC_HEADS=merged["dec_heads"], DEC_FF=merged["dec_ff"],
              DROPOUT=merged["dropout"], MAX_DEC_LEN=merged["max_seq_len"])

    if args.hf_dataset:
        raise RuntimeError(
            "--hf-dataset: HuggingFace datasets are not ported (they need "
            "the datasets package and the network; ROADMAP.md, the tail); "
            "train from a labels.txt with --train-labels")
    if not args.train_labels:
        raise RuntimeError("--train-labels is required")
    train_set = load_local_dataset(args.train_labels, cfg.IMG_H, cfg.IMG_W,
                                   augment=True)
    if args.val_labels:
        val_set = load_local_dataset(args.val_labels, cfg.IMG_H, cfg.IMG_W)
    else:
        n_val = max(1, len(train_set) // 20)
        val_set = [train_set[i] for i in range(n_val)]

    out_dir = Path(merged["output_dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    vocab_path = args.vocab
    if not vocab_path:
        vocab_path = str(out_dir / "vocab.json")
        if not Path(vocab_path).exists():
            print("🔤 Building vocabulary from training texts...")
            build_vocab_from_texts(
                (train_set[i]["text"] for i in range(len(train_set))),
                vocab_path)
    tok = CharTokenizer(vocab_path, cfg)
    train_set.canonicalize(tok)

    tc = TrainConfig(
        epochs=merged["epochs"], batch_size=merged["batch_size"],
        lr=merged["lr"], weight_decay=merged["weight_decay"],
        ctc_weight=merged["ctc_weight"], dec_weight=merged["dec_weight"],
        max_seq_len=merged["max_seq_len"], save_steps=merged["save_steps"],
        out_dir=str(out_dir), n_devices=args.n_devices,
        model_parallel=args.model_parallel,
        select_metric=args.select_metric, train_only=args.train_only,
        dec_input_noise=args.dec_input_noise)
    train_samples = [train_set[i] for i in range(len(train_set))]
    if isinstance(val_set, list):
        val_samples = canonical_samples(val_set, tok)
    else:
        val_set.canonicalize(tok)
        val_samples = [val_set[i] for i in range(len(val_set))]
    train_loop(cfg, tok, tc, train_samples, val_samples,
               vocab_path=vocab_path, from_model=args.from_model,
               resume=args.resume, device=device)


def run_generate(args) -> None:
    from .data.synth import DatasetGenerator, MultilingualDatasetGenerator

    khmer_ratio = args.khmer_ratio
    if args.language and not khmer_ratio:
        khmer_ratio = {"english": 0.0, "khmer": 1.0,
                       "mixed": 0.5}[args.language]
    cls = MultilingualDatasetGenerator if khmer_ratio > 0 else DatasetGenerator
    kwargs = {"khmer_ratio": khmer_ratio} if khmer_ratio > 0 else {}
    gen = cls(args.output, height=args.height,
              augment=not args.no_augment, fonts_dir=args.fonts_dir,
              max_width=args.width, **kwargs)
    # A --train-file gives the train/ and val/ layout; random text a flat
    # images/ + labels.txt.
    if args.train_file:
        out = gen.generate_from_files(
            args.train_file, val_file=args.val_file,
            train_augment=args.augment, val_augment=args.val_augment,
            font_mode=args.font_mode, random_augment=args.random_augment)
        print(f"✓ Generated dataset -> {out}")
        return
    labels = gen.generate_dataset(args.num_samples, append=args.append)
    print(f"✓ Generated {args.num_samples} samples -> {labels}")


def _parse_lang_spec(spec):
    """'lang:path,lang:path' -> list of paths; a plain existing path passes
    through."""
    if not spec:
        return []
    if Path(spec).exists():
        return [spec]
    out = []
    for item in spec.split(","):
        _, _, path = item.rpartition(":")
        if path.strip():
            out.append(path.strip())
    return out


def run_generate_detector(args) -> None:
    from .data.docsynth import generate_detector_dataset
    from .data.synth import _FONT_DIRS, FontManager, require_pillow

    texts = None
    for tf in _parse_lang_spec(args.text_file):
        lines = [l.strip() for l in
                 Path(tf).read_text(encoding="utf-8").splitlines()
                 if l.strip()]
        texts = (texts or []) + lines

    fonts = None
    if args.font:
        require_pillow(f"--font {args.font}")
        fonts = FontManager(font_dirs=[], sizes=(18, 22, 26, 30, 34))
        fonts.font_paths = [args.font]
        fonts.english_fonts = [args.font]
        fonts.khmer_fonts = ([args.font]
                             if fonts._supports(args.font, "កខ") else [])
    elif args.fonts_dir:
        require_pillow(f"--fonts-dir {args.fonts_dir}")
        dirs = _parse_lang_spec(args.fonts_dir) + list(_FONT_DIRS)
        fonts = FontManager(font_dirs=dirs, sizes=(18, 22, 26, 30, 34))

    height = args.image_height or args.image_size
    common = dict(kind=args.kind, khmer_ratio=args.khmer_ratio, texts=texts,
                  min_lines=args.min_lines, max_lines=args.max_lines,
                  augment=not args.no_augment, fonts=fonts)
    out = Path(args.output)
    generate_detector_dataset(str(out / "train"), args.num_train,
                              args.image_size, height, **common)
    generate_detector_dataset(str(out / "val"), args.num_val,
                              args.image_size, height, seed=1337, **common)
    print(f"✓ Detector dataset -> {out}")


def _parse_aug_weights(spec):
    """'rotated=3,noisy=1.5' -> {'rotated': 3.0, 'noisy': 1.5} (None if '')."""
    if not spec:
        return None
    out = {}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        out[name.strip()] = float(val)
    return out


def run_train_detector(args) -> None:
    from .data.docsynth import dataset_root

    device = _device(args.device)
    if args.data_yaml:
        ignored = [flag for flag, _, default in _GENERATOR_FLAGS
                   if getattr(args, flag[2:].replace("-", "_")) != default]
        if ignored:
            print(f"ℹ {', '.join(ignored)}: the live generator's, ignored "
                  "with --data-yaml")
    default_out = (f"runs/detect/{args.name}" if args.name
                   else ("checkpoints_db" if args.detector == "db"
                         else "checkpoints_craft"))
    steps = args.steps
    if args.epochs and args.data_yaml:
        n_docs = len(json.loads((dataset_root(args.data_yaml)
                                 / "annotations.json").read_text()))
        n_batches = max(1, (n_docs + args.batch_size - 1) // args.batch_size)
        steps = args.epochs * n_batches
        print(f"ℹ {args.epochs} epochs x {n_batches} batches = {steps} steps")
    common = dict(steps=steps, batch_size=args.batch_size,
                  image_size=args.image_size, pool_size=args.pool_size,
                  khmer_ratio=args.khmer_ratio,
                  aug_conditions=args.aug_conditions,
                  aug_weights=_parse_aug_weights(args.aug_weights),
                  data_dir=args.data_yaml,
                  out_dir=args.output_dir or default_out)
    if args.detector == "db":
        from .detect.db import load_db_checkpoint
        from .detect.db.net import build_db_net
        from .detect.db.train import DBTrainConfig, train_db

        tc = DBTrainConfig(**common)
        if args.lr:
            tc.lr = args.lr
        net = (build_db_net(load_db_checkpoint(args.from_model))
               if args.from_model else None)
        train_db(tc, net=net, device=device)
    else:
        from .detect.craft import load_craft_checkpoint
        from .detect.craft.net import build_craft_net
        from .detect.craft.train import CRAFTTrainConfig, train_craft

        tc = CRAFTTrainConfig(**common, scale_aug=args.scale_aug)
        if args.lr:
            tc.lr = args.lr
        net = (build_craft_net(load_craft_checkpoint(args.from_model))
               if args.from_model else None)
        train_craft(tc, net=net, device=device)


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
    status: 0, or 1 on an error."""
    argv = list(sys.argv[1:] if argv is None else argv)
    # A bare image path means predict.
    if argv and argv[0] not in _COMMANDS and not argv[0].startswith("-"):
        argv.insert(0, "predict")

    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.command == "init-config":
        init_config(args)
        return 0
    run = {"predict": run_inference, "train": run_train,
           "generate": run_generate,
           "generate-detector": run_generate_detector,
           "train-detector": run_train_detector}.get(args.command)
    if run is None:
        parser.print_help()
        return 0
    try:
        run(args)
    except Exception as e:  # the message, then a failing status
        print(f"\n❌ Error: {e}", file=sys.stderr)
        if getattr(args, "verbose", False):
            import traceback

            traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
