"""The OCR page pipeline: DB, CRAFT or classic-CV detection (with optional
deskew) -> crops -> batched recognition -> text (the port of
``kiri_tpu/pipeline.py``).

``OCR`` keeps the JAX package's constructor arguments and defaults, decode
method aliases, result dicts and stream chunks key for key. ``device=None``
means the card. What differs:

- a detector that fails raises; nothing falls back to another detector or,
  in ``process_documents``, to per-page detection; an unknown
  ``det_method`` raises ValueError (the JAX package runs the classic-CV
  detector for it);
- the class-level model cache is keyed on ``use_fp16`` and the device
  too, so ``OCR(use_fp16=False)`` after ``OCR(use_fp16=True)`` on one
  checkpoint gets a float32 engine;
- a page is a u8 array or a path; PNG files are read by the port's own
  reader, other formats only where cv2 or PIL can be imported
  (``utils/imageio.py``).

On a page the detector deskewed, the crops are cut upright: with
``deskew_single_resample`` (the default) straight from the original page in
one rotate-and-scale warp (``detect/deskew.extract_crop_single_resample``),
otherwise from the rotated page. ``mode="words"`` detects words with the
classic-CV detector whatever ``det_method`` is (``det_confidence`` 1.0), and
recognizes them as it does lines.
"""
from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from .checkpoints import build_model, find_vocab_file, read_checkpoint
from .config import CFG
from .device import resolve_device
from .engine import RecognizerEngine
from .detect import METHODS
from .detect.deskew import extract_crop_single_resample, rotate_image
from .ops.preprocess import (NOISE_SIGMA_THRESH, _despike, crop_region,
                             enhance_crop, estimate_noise_sigma,
                             invert_if_dark, preprocess_crops, preprocess_np,
                             to_gray)
from .tokenizer import CharTokenizer
from .utils.imageio import imread_bgr
from .utils.profiling import StageTimer

DecodeMethod = str


class OCR:
    """Document OCR on the card.

    Example:
        >>> ocr = OCR(model_path='models/model.safetensors')
        >>> text, results = ocr.extract_text(page_u8)
    """

    _model_cache: Dict[Tuple, Dict] = {}

    def __init__(
        self,
        model_path: str = "models/model.safetensors",
        det_model_path: Optional[str] = None,
        det_method: str = "db",
        det_conf_threshold: float = 0.5,
        padding: int = 10,
        device=None,
        verbose: bool = False,
        decode_method: DecodeMethod = "accurate",
        use_beam_search: Optional[bool] = None,  # deprecated
        use_fp16: Optional[bool] = None,
        preprocess: str = "host",
        deskew: bool = False,
        enhance: bool = False,
        det_kwargs: Optional[Dict] = None,
        upload_bits: int = 8,
        deskew_single_resample: bool = True,
        stream_window: Optional[int] = None,
    ):
        if preprocess not in ("host", "device"):
            raise ValueError(
                f"Invalid preprocess '{preprocess}'. Choose 'host' (numpy "
                f"resize on the host, ships 48xW u8 lines) or 'device' (the "
                f"preprocess kernel: invert+resize+pad+normalize of raw "
                f"crops on the card).")
        if use_beam_search is not None:
            warnings.warn(
                "use_beam_search is deprecated. Use decode_method instead:\n"
                "  - decode_method='fast' (replaces use_beam_search=False)\n"
                "  - decode_method='accurate' (default, balanced)\n"
                "  - decode_method='beam' (replaces use_beam_search=True)",
                DeprecationWarning, stacklevel=2)
            decode_method = "beam" if use_beam_search else "fast"
        decode_method = self._normalize_decode_method(decode_method)
        if det_method not in METHODS:
            raise ValueError(f"det_method must be one of {METHODS}: "
                             f"{det_method!r}")

        self.device = resolve_device(device)
        self.verbose = verbose
        self.padding = padding
        self.det_model_path = det_model_path
        self.det_method = det_method
        self.det_conf_threshold = det_conf_threshold
        #: Straighten skewed pages inside the detector (detect/deskew.py);
        #: result boxes stay in the input frame.
        self.deskew = deskew
        #: Adaptive crop cleanup for degraded captures (host:
        #: ops/preprocess.enhance_crop; device: kernels/resize.enhance_lines).
        self.enhance = enhance
        #: Extra keyword arguments of TextDetector (det_db_thresh,
        #: det_map_downsample, ...).
        self.det_kwargs = dict(det_kwargs or {})
        self.upload_bits = upload_bits
        #: On a deskewed page, cut each crop from the original page in one
        #: rotate-and-scale warp instead of from the rotated page.
        self.deskew_single_resample = deskew_single_resample
        #: Window of incremental character streaming; None -> the
        #: checkpoint's cfg.STREAM_WINDOW, 0 -> one-shot decode and replay.
        self.stream_window = stream_window
        self.decode_method = decode_method
        self.use_fp16 = use_fp16
        self.use_beam_search = decode_method == "beam"
        self.preprocess = preprocess

        self.cfg: Optional[CFG] = None
        self.tokenizer: Optional[CharTokenizer] = None
        self.engine: Optional[RecognizerEngine] = None
        self._load_model(self._resolve_model_path(model_path))
        if self.stream_window is None:
            self.stream_window = self.cfg.STREAM_WINDOW
        self._detector = None
        # Set per page by _deskew_crop_view: True when the crops come from
        # the rotated page (the sharpen repair applies to them).
        self._crops_resampled = False

    # ------------------------------------------------------------ utilities
    def _stream_window_for(self, method: str) -> Optional[int]:
        """Windowed streaming for the step loops; one-shot for "decoder"
        with SPEC_DECODE (its speculative decode finishes a page in a few
        passes)."""
        if not self.stream_window:
            return None
        if method == "decoder" and self.cfg.SPEC_DECODE:
            return None
        return self.stream_window

    @staticmethod
    def _normalize_decode_method(method: str) -> str:
        method = method.lower().strip()
        aliases = {"fast": "ctc", "ctc": "ctc", "accurate": "decoder",
                   "decoder": "decoder", "beam": "beam", "auto": "auto"}
        if method not in aliases:
            raise ValueError(
                f"Invalid decode_method '{method}'. Choose from: 'fast', "
                f"'accurate', 'beam', 'auto' (or aliases: 'ctc', 'decoder')")
        return aliases[method]

    def _resolve_model_path(self, model_path: str) -> str:
        """The path itself, else the file name under the package or the
        checkout's models/, else for a repo id ("org/name", no suffix) the
        file downloaded from the Hugging Face hub; the path as given when
        none of these exists."""
        model_file = Path(model_path)
        if model_file.exists():
            return str(model_file)
        pkg_dir = Path(__file__).resolve().parent
        for candidate in (pkg_dir / model_path,
                          pkg_dir.parent / "models" / model_file.name):
            if candidate.exists():
                return str(candidate)
        if "/" in model_path and not model_file.suffix:
            downloaded = self._download_from_huggingface(model_path)
            if downloaded:
                return downloaded
        return model_path

    def _download_from_huggingface(self, repo_id: str) -> Optional[str]:
        """``model.safetensors``, else ``model.pt``, of ``repo_id`` from the
        hub, with its meta, vocab and config files beside it (each best
        effort). The local path, or None when ``huggingface_hub`` does not
        import or nothing downloads."""
        try:
            from huggingface_hub import hf_hub_download
        except Exception:
            return None
        try:
            local = None
            for fname in ("model.safetensors", "model.pt"):
                try:
                    local = hf_hub_download(repo_id=repo_id, filename=fname)
                    break
                except Exception:
                    continue
            if local is None:
                return None
            for extra in ("model_meta.json", "vocab.json", "vocab_auto.json",
                          "vocab_char.json", "config.json"):
                try:
                    hf_hub_download(repo_id=repo_id, filename=extra)
                except Exception:
                    pass
            return local
        except Exception as e:
            if self.verbose:
                print(f"HF download failed for {repo_id}: {e}")
            return None

    # --------------------------------------------------------- model loading
    def _load_model(self, model_path: str) -> None:
        cache_key = (str(model_path), str(self.device), self.upload_bits,
                     self.use_fp16)
        cached = OCR._model_cache.get(cache_key)
        if cached is not None:
            if self.verbose:
                print("⚡ Loading from memory cache")
            self.engine, self.cfg = cached["engine"], cached["cfg"]
            self.tokenizer = cached["tokenizer"]
            return
        if self.verbose:
            print(f"📦 Loading OCR model from {model_path}...")
        sd, cfg, meta = read_checkpoint(model_path)
        if self.use_fp16 is not None:
            cfg = cfg.replace(USE_FP16=self.use_fp16,
                              COMPUTE_DTYPE="bfloat16" if self.use_fp16
                              else "float32")
        self.cfg = cfg
        vocab_path = find_vocab_file(meta.get("vocab_path", ""), model_path)
        if not vocab_path:
            raise FileNotFoundError(
                f"Could not find vocabulary file. Expected near: {model_path}")
        self.tokenizer = CharTokenizer(vocab_path, cfg)
        self.engine = RecognizerEngine(build_model(sd, cfg), cfg,
                                       self.tokenizer, device=self.device,
                                       upload_bits=self.upload_bits)
        if self.verbose:
            print(f"  ✓ Loaded (Vocab: {self.tokenizer.vocab_size} chars)")
        OCR._model_cache[cache_key] = {
            "engine": self.engine, "cfg": self.cfg,
            "tokenizer": self.tokenizer}

    # -------------------------------------------------------------- detector
    @property
    def detector(self):
        if self._detector is None:
            from .detect import TextDetector

            self._detector = TextDetector(
                method=self.det_method, model_path=self.det_model_path,
                conf_threshold=self.det_conf_threshold, device=self.device,
                deskew=self.deskew, **self.det_kwargs)
        return self._detector

    # ------------------------------------------------------------ recognition
    def recognize_region(self, image_tensor) -> Tuple[str, float]:
        """Recognize one preprocessed line image (u8 [H, W] or the
        reference's normalized float [1, 1, H, W])."""
        img = self._coerce_input(image_tensor)
        return self.engine.recognize_batch(img[None], self.decode_method)[0]

    def _coerce_input(self, image_tensor) -> np.ndarray:
        arr = np.asarray(image_tensor)
        if arr.ndim == 4:  # [1, 1, H, W] normalized float
            arr = arr[0, 0]
        if arr.dtype != np.uint8:
            arr = np.clip((arr * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        return arr

    def recognize_region_streaming(self, image_tensor,
                                   decode_method: Optional[str] = None
                                   ) -> Generator[Dict, None, None]:
        img = self._coerce_input(image_tensor)
        method = (self._normalize_decode_method(decode_method)
                  if decode_method is not None else self.decode_method)
        yield from self.engine.stream_records(
            img, method, window=self._stream_window_for(method))

    def recognize_streaming(self, image_path, decode_method: Optional[str] = None
                            ) -> Generator[Dict, None, None]:
        img = invert_if_dark(self._load_gray(image_path))
        yield from self.recognize_region_streaming(
            preprocess_np(self.cfg, img), decode_method)

    def recognize_single_line_image(self, image_path) -> Tuple[str, float]:
        img = invert_if_dark(self._load_gray(image_path))
        return self.recognize_region(preprocess_np(self.cfg, img))

    def _load_gray(self, image_path) -> np.ndarray:
        if isinstance(image_path, np.ndarray):
            return to_gray(image_path)
        img = imread_bgr(image_path)
        if img is None:
            raise ValueError(f"Could not load image: {image_path}")
        return to_gray(img)

    # ------------------------------------------------------ document pipeline
    def _detect_boxes(self, image_path, mode: str):
        if mode == "lines":
            text_boxes = self.detector.detect_lines_objects(image_path)
            return ([b.bbox for b in text_boxes],
                    [b.confidence for b in text_boxes])
        boxes = self.detector.detect_words(image_path)
        return boxes, [1.0] * len(boxes)

    @staticmethod
    def _row(box, text: str, confidence: float, det_conf: float,
             line_number: int) -> Dict:
        return {"box": [int(v) for v in box], "text": text,
                "confidence": float(confidence),
                "det_confidence": float(det_conf), "line_number": line_number}

    def process_document(self, image_path, mode: str = "lines",
                         verbose: bool = False) -> List[Dict]:
        """Detect and recognize one page: result dicts (box, text,
        confidence, det_confidence, line_number) in reading order. The
        call's stage times ("detect", "preprocess", "recognize") are left
        in ``self.last_timer``."""
        timer = StageTimer()
        if verbose:
            print(f"\n📄 Processing: {image_path}")
            print(f"🔲 Box padding: {self.padding}px")
        with timer.stage("detect"):
            boxes, det_confs = self._detect_boxes(image_path, mode)
        if verbose:
            print(f"🔍 Detected {len(boxes)} regions")
        img_gray = self._load_gray(image_path)
        recognized, kept = self._recognize_regions(img_gray, boxes, timer)
        results = []
        for row, bi in enumerate(kept):
            text, confidence = recognized[row]
            results.append(self._row(boxes[bi], text, confidence,
                                     det_confs[bi], bi + 1))
            if verbose:
                print(f"  {bi + 1:2d}. {text[:50]:50s} ({confidence * 100:.1f}%)")
        if verbose:
            print("⏱ Stage timing:")
            print(timer.report())
        self.last_timer = timer
        return results

    def _deskew_crop_view(self, img_gray, boxes):
        """(page, boxes) to cut the crops from: the detector's rotated page
        and its boxes when it deskewed this page, else the page itself.
        Result boxes stay in the input frame either way."""
        det = self._detector
        if (self.deskew and det is not None and det.last_deskew_boxes
                and len(det.last_deskew_boxes) == len(boxes)):
            self._crops_resampled = True
            return (det.last_deskewed_image,
                    [b.bbox for b in det.last_deskew_boxes])
        self._crops_resampled = False
        return img_gray, boxes

    def _cut_crops(self, img_gray, boxes, extra_padding: int = 5):
        """(gray u8 crops, indices of the boxes kept, sharpen flags) of a
        page's input-frame ``boxes``; empty crops are dropped.

        On a deskewed page with ``deskew_single_resample``, each crop is
        warped from the original page at the model's height
        (``extract_crop_single_resample``; sharpen False); a crop the warp
        refuses (a strong downscale) is cut from the rotated page (sharpen
        True). With ``enhance`` on a noisy page (noise sigma above
        ``NOISE_SIGMA_THRESH``), the page is despiked once, on the first
        crop that needs it, the warps are linear, and the refused crops are
        cut from the despiked page rotated again.
        """
        crop_img, crop_boxes = self._deskew_crop_view(img_gray, boxes)
        crops: List[np.ndarray] = []
        kept: List[int] = []
        sharpen: List[bool] = []
        angle = 0.0
        fill = None
        if self._crops_resampled and self.deskew_single_resample:
            angle = float(self._detector.last_deskew_angle)
        noise_gate = bool(angle and self.enhance and estimate_noise_sigma(
            img_gray) > NOISE_SIGMA_THRESH)
        warp_interp = "linear" if noise_gate else None
        lazy: Dict[str, np.ndarray] = {}

        def warp_src() -> np.ndarray:
            if "warp" not in lazy:
                lazy["warp"] = (np.clip(_despike(img_gray.astype(np.float32)),
                                        0.0, 255.0).astype(np.uint8)
                                if noise_gate else img_gray)
            return lazy["warp"]

        def fallback_view() -> np.ndarray:
            if not noise_gate:
                return crop_img
            if "fb" not in lazy:
                lazy["fb"] = rotate_image(warp_src(), -angle)
            return lazy["fb"]

        for i, box in enumerate(crop_boxes):
            roi = None
            resampled = self._crops_resampled
            if angle:
                if fill is None:
                    fill = int(np.median(img_gray))
                roi = extract_crop_single_resample(
                    warp_src(), angle, box, self.cfg.IMG_H,
                    extra_padding=extra_padding, fill=fill,
                    interp=warp_interp)
                if roi is not None:
                    resampled = False
            if roi is None:
                roi = crop_region(fallback_view() if angle else crop_img,
                                  box, extra_padding)
            if roi is None:
                continue
            crops.append(to_gray(roi))
            kept.append(i)
            sharpen.append(resampled)
        return crops, kept, sharpen

    def _recognize_regions(self, img_gray, boxes, timer=None):
        """Crop, preprocess ("host": numpy; "device": the preprocess kernel
        inside ``recognize_crops``) and recognize the boxes of a page.
        Returns (recognized [(text, conf)], kept box indices)."""
        timer = timer or StageTimer()
        with timer.stage("preprocess"):
            crops, kept, sharpen = self._cut_crops(img_gray, boxes)
            if self.preprocess == "host":
                batch, widths = preprocess_crops(
                    self.cfg, crops, enhance=self.enhance, sharpen=sharpen)
        with timer.stage("recognize"):
            if self.preprocess == "device":
                recognized = self.engine.recognize_crops(
                    crops, self.decode_method, enhance=self.enhance,
                    sharpen=np.asarray(sharpen, bool))
            else:
                recognized = self.engine.recognize_batch(
                    batch, self.decode_method, widths=widths)
        return recognized, kept

    def process_document_streaming(self, image_path, mode: str = "lines",
                                   verbose: bool = False
                                   ) -> Generator[Dict, None, None]:
        """Result dicts one region at a time, in reading order, each with
        ``total_regions``; recognition runs batched first."""
        if verbose:
            print(f"\n📄 Processing (streaming): {image_path}")
            print(f"🔲 Box padding: {self.padding}px")
        boxes, det_confs = self._detect_boxes(image_path, mode)
        total_regions = len(boxes)
        if verbose:
            print(f"🔍 Detected {total_regions} regions")
        img_gray = self._load_gray(image_path)
        recognized, kept = self._recognize_regions(img_gray, boxes)
        by_index = dict(zip(kept, recognized))
        for i, (box, det_conf) in enumerate(zip(boxes, det_confs), 1):
            if (i - 1) not in by_index:
                continue
            text, confidence = by_index[i - 1]
            result = self._row(box, text, confidence, det_conf, i)
            result["total_regions"] = total_regions
            if verbose:
                print(f"  {i:2d}. {text[:50]:50s} ({confidence * 100:.1f}%)")
            yield result

    @staticmethod
    def _chunk(region_num: int, total_regions: int, box, det_conf,
               cumulative: List[str], rec: Optional[Dict] = None) -> Dict:
        """A stream chunk: a region's start (``rec`` None) or one of its
        records."""
        if rec is None:
            return {"token": "", "text": "",
                    "cumulative_text": "\n".join(cumulative),
                    "region_number": region_num,
                    "total_regions": total_regions, "step": 0,
                    "region_finished": False, "document_finished": False,
                    "region_start": True, "box": [int(v) for v in box],
                    "det_confidence": float(det_conf)}
        text = rec["text"]
        return {"token": rec["token"], "text": text,
                "cumulative_text": "\n".join(cumulative + ([text] if text
                                                           else [])),
                "region_number": region_num, "total_regions": total_regions,
                "step": rec["step"], "confidence": rec["confidence"],
                "region_finished": rec["finished"],
                "document_finished": rec["finished"]
                and region_num == total_regions,
                "region_start": False, "box": [int(v) for v in box],
                "det_confidence": float(det_conf)}

    def extract_text_stream_chars(self, image_path, mode: str = "lines",
                                  decode_method: Optional[str] = None,
                                  verbose: bool = False, batched: bool = True
                                  ) -> Generator[Dict, None, None]:
        """Character streaming in the reference's chunk schema.

        batched=True: every region of the page decodes in one call
        (``_stream_chars_batched``) and the chunks follow in reading order;
        batched=False streams region by region. Lines are preprocessed on
        the host on both.
        """
        if verbose:
            print(f"\n📄 Processing (char streaming): {image_path}")
        boxes, det_confs = self._detect_boxes(image_path, mode)
        total_regions = len(boxes)
        if verbose:
            print(f"🔍 Detected {total_regions} regions")
        img_gray = self._load_gray(image_path)
        if batched and total_regions > 1:
            yield from self._stream_chars_batched(
                img_gray, boxes, det_confs, decode_method, verbose)
            return
        all_region_texts: List[str] = []
        crops, kept, sharpen = self._cut_crops(img_gray, boxes)
        by_idx = {bi: (c, sh) for bi, c, sh in zip(kept, crops, sharpen)}
        for region_num, (box, det_conf) in enumerate(zip(boxes, det_confs), 1):
            try:
                entry = by_idx.get(region_num - 1)
                if entry is None:
                    continue
                roi, roi_sharpen = entry
                if self.enhance:
                    roi = enhance_crop(invert_if_dark(to_gray(roi)),
                                       sharpen=roi_sharpen)
                region_img = preprocess_np(self.cfg, roi)
                yield self._chunk(region_num, total_regions, box, det_conf,
                                  all_region_texts)
                current_region_text = ""
                for rec in self.recognize_region_streaming(region_img,
                                                           decode_method):
                    current_region_text = rec["text"]
                    yield self._chunk(region_num, total_regions, box,
                                      det_conf, all_region_texts, rec)
                    if rec["finished"]:
                        break
                if current_region_text:
                    all_region_texts.append(current_region_text)
                if verbose:
                    print(f"  {region_num:2d}. {current_region_text[:50]}")
            except Exception as e:
                # The reference's per-region error chunk.
                if verbose:
                    print(f"  {region_num:2d}. [Error: {e}]")
                yield {"token": "", "text": "",
                       "cumulative_text": "\n".join(all_region_texts),
                       "region_number": region_num,
                       "total_regions": total_regions, "step": 0,
                       "region_finished": True,
                       "document_finished": region_num == total_regions,
                       "region_start": True, "box": [int(v) for v in box],
                       "error": str(e)}

    def _stream_chars_batched(self, img_gray, boxes, det_confs,
                              decode_method: Optional[str],
                              verbose: bool) -> Generator[Dict, None, None]:
        """One decode for the whole page, then its records as chunks."""
        method = (self._normalize_decode_method(decode_method)
                  if decode_method is not None else self.decode_method)
        total_regions = len(boxes)
        crops, kept, sharpen = self._cut_crops(img_gray, boxes)
        batch, _ = preprocess_crops(self.cfg, crops, enhance=self.enhance,
                                    sharpen=sharpen)
        record_lists = self.engine.stream_records_batch(
            batch, method, window=self._stream_window_for(method))
        by_index = dict(zip(kept, record_lists))
        all_region_texts: List[str] = []
        for region_num, (box, det_conf) in enumerate(zip(boxes, det_confs), 1):
            recs = by_index.get(region_num - 1)
            if recs is None:
                continue
            yield self._chunk(region_num, total_regions, box, det_conf,
                              all_region_texts)
            current_region_text = ""
            for rec in recs:
                current_region_text = rec["text"]
                yield self._chunk(region_num, total_regions, box, det_conf,
                                  all_region_texts, rec)
                if rec["finished"]:
                    break
            if current_region_text:
                all_region_texts.append(current_region_text)
            if verbose:
                print(f"  {region_num:2d}. {current_region_text[:50]}")

    def extract_text_streaming(self, image_path, mode: str = "lines",
                               verbose: bool = False
                               ) -> Generator[Dict, None, None]:
        """``process_document_streaming`` with the document text so far in
        each result's ``cumulative_text``."""
        lines: List[str] = []
        current_line: List[str] = []
        prev_center_y = None
        prev_height = None
        for result in self.process_document_streaming(image_path, mode,
                                                      verbose):
            if "error" not in result and result["text"]:
                y, h = result["box"][1], result["box"][3]
                center_y = y + h / 2
                if prev_center_y is not None:
                    tolerance = max(h, prev_height) * 0.8
                    if abs(center_y - prev_center_y) < tolerance:
                        current_line.append(result["text"])
                    else:
                        if current_line:
                            lines.append(" ".join(current_line))
                        current_line = [result["text"]]
                else:
                    current_line = [result["text"]]
                prev_center_y = center_y
                prev_height = h
            temp_lines = lines.copy()
            if current_line:
                temp_lines.append(" ".join(current_line))
            result["cumulative_text"] = "\n".join(temp_lines)
            yield result

    @staticmethod
    def _assemble_text(results: List[Dict],
                       group_boxes: Optional[List] = None) -> str:
        """Region texts joined into the document text: regions whose
        vertical centres lie within 80% of the larger height share a line.

        ``group_boxes`` (aligned with ``results``; None entries fall back to
        the result's box) gives the geometry to group by: on a deskewed page
        the upright boxes, since the input-frame hulls grow by about width
        x sin(angle) and would merge neighbouring lines."""
        lines: List[str] = []
        current_line: List[str] = []
        prev_center_y = None
        prev_height = None
        for i, res in enumerate(results):
            if group_boxes is not None and group_boxes[i] is not None:
                y, h = group_boxes[i][1], group_boxes[i][3]
            else:
                y, h = res["box"][1], res["box"][3]
            center_y = y + h / 2
            if prev_center_y is not None:
                tolerance = max(h, prev_height) * 0.8
                if abs(center_y - prev_center_y) < tolerance:
                    current_line.append(res["text"])
                else:
                    lines.append(" ".join(current_line))
                    current_line = [res["text"]]
            else:
                current_line = [res["text"]]
            prev_center_y = center_y
            prev_height = h
        if current_line:
            lines.append(" ".join(current_line))
        return "\n".join(lines)

    def extract_text(self, image_path, mode: str = "lines",
                     verbose: bool = False) -> Tuple[str, List[Dict]]:
        """(document text, result dicts) of one page."""
        results = self.process_document(image_path, mode, verbose=verbose)
        if not results:
            return "", results
        return (self._assemble_text(results, self._group_boxes_for(results)),
                results)

    def _group_boxes_for(self, results: List[Dict]) -> Optional[List]:
        """The upright boxes of ``results`` (by line_number) when the
        detector deskewed the last page, else None."""
        det = self._detector
        if not (self.deskew and det is not None and det.last_deskew_boxes):
            return None
        return self._align_twins([b.bbox for b in det.last_deskew_boxes],
                                 results)

    @staticmethod
    def _align_twins(twins: Optional[List], results: List[Dict]
                     ) -> Optional[List]:
        """A page's upright boxes (by detected box) aligned with its result
        rows (by line_number - 1)."""
        if twins is None:
            return None
        out = []
        for res in results:
            bi = res.get("line_number", 0) - 1
            out.append(twins[bi] if 0 <= bi < len(twins) else None)
        return out

    # ------------------------------------------------- multi-document batch
    def process_documents(self, image_paths, mode: str = "lines",
                          verbose: bool = False) -> List[List[Dict]]:
        """``process_document`` of many pages, with the regions of every
        page recognized in one pooled, width-bucketed pass. Detection runs
        as grouped batched forwards, and each page is cropped and
        preprocessed as its map arrives (pages arrive in canvas-group order
        and are placed by their index). Returns one result list per page,
        in input order. The call's stage times ("detect": inside the
        detector, "preprocess": crops, "recognize": the pooled pass) are
        left in ``self.last_timer``."""
        image_paths = list(image_paths)
        timer = StageTimer()
        n_docs = len(image_paths)
        per_doc: List = [None] * n_docs     # (boxes, det_confs, kept)
        doc_pool: List = [None] * n_docs    # host: (batch, widths);
        #                                     device: (crops, sharpen)
        doc_twins: List = [None] * n_docs   # upright boxes of deskewed pages

        def prep_page(di, boxes, det_confs):
            img_gray = self._load_gray(image_paths[di])
            crops, kept, sharpen = self._cut_crops(img_gray, boxes)
            if self.preprocess == "device":
                doc_pool[di] = (crops, sharpen)
            elif kept:
                doc_pool[di] = preprocess_crops(
                    self.cfg, crops, enhance=self.enhance, sharpen=sharpen)
            per_doc[di] = (boxes, det_confs, kept)
            det = self._detector
            if self.deskew and det is not None and det.last_deskew_boxes:
                doc_twins[di] = [b.bbox for b in det.last_deskew_boxes]
            if verbose:
                print(f"🔍 {image_paths[di]}: {len(boxes)} regions")

        if mode == "lines":
            det = self.detector
            pages = det.iter_lines_objects_batch(image_paths)
            while True:
                with timer.stage("detect"):
                    page = next(pages, None)
                if page is None:
                    break
                di, tbs = page
                # This page's deskew state, for its crops.
                (det.last_deskewed_image, det.last_deskew_boxes,
                 det.last_deskew_angle) = det.last_batch_state[di]
                with timer.stage("preprocess"):
                    prep_page(di, [b.bbox for b in tbs],
                              [b.confidence for b in tbs])
        else:
            for di, image_path in enumerate(image_paths):
                with timer.stage("detect"):
                    boxes, det_confs = self._detect_boxes(image_path, mode)
                with timer.stage("preprocess"):
                    prep_page(di, boxes, det_confs)

        entries = [e for e in doc_pool if e is not None]
        with timer.stage("recognize"):
            if self.preprocess == "device":
                recognized = self.engine.recognize_crops(
                    [c for e in entries for c in e[0]], self.decode_method,
                    enhance=self.enhance,
                    sharpen=np.asarray([s for e in entries for s in e[1]],
                                       bool))
            elif entries:
                recognized = self.engine.recognize_batch(
                    np.concatenate([e[0] for e in entries]),
                    self.decode_method,
                    widths=np.concatenate([e[1] for e in entries]))
            else:
                recognized = []

        all_results: List[List[Dict]] = []
        row = 0
        for boxes, det_confs, kept in per_doc:
            results = []
            for bi in kept:
                text, confidence = recognized[row]
                row += 1
                results.append(self._row(boxes[bi], text, confidence,
                                         det_confs[bi], bi + 1))
            all_results.append(results)
        # The upright boxes of each page for extract_text_batch's grouping.
        self._last_batch_twins = doc_twins
        self.last_timer = timer
        return all_results

    def extract_text_batch(self, image_paths, mode: str = "lines",
                           verbose: bool = False
                           ) -> List[Tuple[str, List[Dict]]]:
        """``extract_text`` of many pages with one pooled recognition pass
        (``process_documents``)."""
        docs = self.process_documents(image_paths, mode, verbose=verbose)
        return [(self._assemble_text(res, self._align_twins(tw, res))
                 if res else "", res)
                for res, tw in zip(docs, self._last_batch_twins)]
