"""Text-detection facade (the port of ``kiri_tpu/detect/__init__.py``).

``TextDetector(method="db" | "craft")`` turns the detector's quads into
``TextBox`` rows in reading order (CRAFT's merged where they overlap
vertically) and splits boxes that bridge a column gutter;
``TextDetector("legacy")`` takes the lines of the classic-CV detector
(``detect/legacy.py``, no model) as they are. Whatever the method, the word,
block and character levels, ``detect_all`` and the debug images come from
the classic-CV detector, as in the JAX package (``detect_blocks`` groups the
method's own lines). With
``deskew=True`` a page whose estimated skew reaches ``deskew_min_angle``
is straightened first (``detect/deskew.py``), detected upright, and its
boxes are mapped back to the input frame; the upright page and its boxes
stay on the detector for the croppers (``last_deskewed_image``,
``last_deskew_boxes``, ``last_deskew_angle``; ``last_batch_state`` per page
of a batch).

A repo id (``"org/name"``) as ``model_path``, or no model file found on
disk, is looked up on the Hugging Face hub as in the JAX package
(``DEFAULT_HUB_REPO`` for the default model). Unlike the JAX package it
never falls back to another detector: a DB or CRAFT model that is not
found (on disk or on the hub), fails to load or fails to run raises.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.preprocess import to_gray
from ..utils.imageio import imread_bgr
from ..utils.profiling import annotate
from .base import DetectionLevel, TextBox
from .craft import CRAFTDetector
from .db import DBDetector
from .deskew import boxes_to_original, estimate_skew, rotate_image
from .legacy import ImageProcessingTextDetector

_DB_KEYS = ("det_db_thresh", "det_db_box_thresh", "det_db_unclip_ratio",
            "max_side_len", "min_size", "binary_threshold",
            "polygon_threshold", "unclip_ratio", "max_candidates",
            "padding_pct", "padding_px", "padding_y_pct", "padding_y_px",
            "line_tolerance_ratio", "debug", "det_map_downsample")
_MODEL_FILES = {"db": "detector.safetensors", "craft": "craft.safetensors"}
METHODS = ("db", "craft", "legacy")


class TextDetector:
    """Detector facade over the DB, CRAFT or classic-CV backend. ``device``
    (None means the card) goes to the net; the classic-CV detector runs on
    the host and takes the remaining keyword arguments."""

    def __init__(self, method: str = "db", model_path: Optional[str] = None,
                 device=None, **kwargs):
        self.conf_threshold = kwargs.pop("conf_threshold", 0.25)
        #: Straighten skewed pages before detection and map the boxes back.
        self.deskew = kwargs.pop("deskew", False)
        #: Smaller estimated angles are left alone.
        self.deskew_min_angle = kwargs.pop("deskew_min_angle", 1.0)
        #: The last page's estimate (also when it was not applied).
        self.last_skew_angle = 0.0
        #: Split detected boxes that bridge an aligned column gutter
        #: (``_split_column_merges``); off keeps the backend's boxes.
        self.split_columns = kwargs.pop("split_columns", True)
        # Per-page deskew state: the upright page, its boxes (one for each
        # returned box) and the applied angle, or None, None, 0.0.
        self.last_deskewed_image = None
        self.last_deskew_boxes = None
        self.last_deskew_angle = 0.0
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}: {method!r}")
        self.method = method
        self.kwargs = kwargs
        self.db_detector = self.craft_detector = None
        self.legacy_detector = ImageProcessingTextDetector(**kwargs)
        self.model_path = model_path
        if method == "legacy":
            return
        if model_path is None:
            model_path = self._find_default_model()
        elif ("/" in str(model_path) and not os.path.exists(model_path)
              and not str(model_path).startswith((".", "/"))):
            model_path = self._download_from_hub(str(model_path)) or model_path
        if not (model_path and Path(model_path).exists()):
            raise FileNotFoundError(
                f"{method.upper()} model not found: {model_path}")
        self.model_path = str(model_path)
        if method == "db":
            self.db_detector = DBDetector(
                self.model_path, device=device,
                **{k: v for k, v in kwargs.items() if k in _DB_KEYS})
        else:
            self.craft_detector = CRAFTDetector(self.model_path,
                                                device=device)

    #: The hub repo looked up when no local model file exists.
    DEFAULT_HUB_REPO = "mrrtmob/kiri-ocr"

    def _find_default_model(self) -> Optional[str]:
        """The method's checkpoint (``detector.safetensors`` or
        ``craft.safetensors``) in ./models, ., the package or the
        checkout's models/, else from ``DEFAULT_HUB_REPO``."""
        fname = _MODEL_FILES[self.method]
        pkg_dir = Path(__file__).resolve().parent
        for p in (Path("models") / fname, Path(fname), pkg_dir / fname,
                  pkg_dir.parents[1] / "models" / fname):
            if p.exists():
                return str(p)
        return self._download_from_hub(self.DEFAULT_HUB_REPO)

    def _download_from_hub(self, repo_id: str) -> Optional[str]:
        """The method's checkpoint from the hub repo ``repo_id``, tried as
        ``detector/<f>``, ``<f>`` and ``models/<f>``; None when
        ``huggingface_hub`` does not import or no file downloads."""
        fname = _MODEL_FILES.get(self.method)
        if fname is None:
            return None
        try:
            from huggingface_hub import hf_hub_download
        except Exception:
            return None
        for remote in (f"detector/{fname}", fname, f"models/{fname}"):
            try:
                local = hf_hub_download(repo_id=repo_id, filename=remote)
                if local and os.path.exists(local):
                    return local
            except Exception:
                continue
        print(f"Warning: could not find a {self.method} detector model in "
              f"HuggingFace repo: {repo_id}")
        return None

    @staticmethod
    def _load_image(image) -> Optional[np.ndarray]:
        """Path or array -> gray u8 (None when a path cannot be decoded):
        the classic-CV detector's loader, without cv2."""
        if isinstance(image, (str, Path)):
            img = imread_bgr(image)
            if img is None:
                return None
        else:
            img = np.asarray(image)
        return to_gray(img)

    # --------------------------------------------------------------- lines
    def detect_lines(self, image) -> List[Tuple[int, int, int, int]]:
        return [b.bbox for b in self.detect_lines_objects(image)]

    def detect_lines_objects(self, image) -> List[TextBox]:
        # A previous page's deskew state must never reach this page's crops.
        self.last_deskewed_image = None
        self.last_deskew_boxes = None
        self.last_deskew_angle = 0.0
        if self.deskew:
            img = self._load_image(image)
            if img is not None:
                angle = estimate_skew(img)
                self.last_skew_angle = angle
                if abs(angle) >= self.deskew_min_angle:
                    desk = rotate_image(img, -angle)
                    boxes, mapped = self._to_input_frame(
                        self._detect_lines_upright(desk), angle, img.shape)
                    self.last_deskewed_image = desk
                    self.last_deskew_boxes = boxes
                    self.last_deskew_angle = angle
                    return mapped
        return self._detect_lines_upright(image)

    @staticmethod
    def _to_input_frame(boxes: List[TextBox], angle: float, shape
                        ) -> Tuple[List[TextBox], List[TextBox]]:
        """(the upright boxes kept, their input-frame twins): boxes whose
        mapped hull is empty are dropped from both."""
        mapped = boxes_to_original(
            [(b.x, b.y, b.width, b.height) for b in boxes], angle, shape[:2])
        pairs = [(b, m) for b, m in zip(boxes, mapped)
                 if m[2] > 0 and m[3] > 0]
        return ([b for b, _ in pairs],
                [TextBox(x, y, w, h, confidence=b.confidence, level=b.level)
                 for b, (x, y, w, h) in pairs])

    def _backend(self):
        """(the backend's batched iterator, ``_process_boxes_objects``
        arguments)."""
        if self.method == "db":
            return (self.db_detector.iter_detect_text,
                    dict(merge=False, skip_sort=True))
        return self.craft_detector.iter_detect_text, dict(merge=True)

    def _detect_lines_upright(self, image) -> List[TextBox]:
        if self.method == "legacy":
            lines = self.legacy_detector.detect_lines(image)
            return [TextBox(x, y, w, h, confidence=1.0,
                            level=DetectionLevel.LINE)
                    for (x, y, w, h) in lines]
        if self.method == "db":
            detected = self.db_detector.detect_text(image)
        else:
            detected = self.craft_detector.detect_text(image)
        with annotate("detect.layout"):
            boxes = self._process_boxes_objects(detected,
                                                **self._backend()[1])
            return self._split_column_merges(image, boxes)

    def iter_lines_objects_batch(self, images):
        """Yield ``(page index, TextBox list)`` over many pages in the order
        the batched forwards finish (NOT input order); per-page results are
        those of ``detect_lines_objects``.

        ``self.last_batch_state[i]`` is filled when page ``i`` is yielded
        with ``(deskewed image, deskew boxes, applied angle)``, ``(None,
        None, 0.0)`` for a page that was not rotated.
        """
        images = list(images)
        state: List = [None] * len(images)
        self.last_batch_state = state
        self.last_deskewed_image = None
        self.last_deskew_boxes = None
        self.last_deskew_angle = 0.0
        if self.method == "legacy":
            # No net to batch: page by page, in input order.
            for i, image in enumerate(images):
                boxes = self.detect_lines_objects(image)
                state[i] = (self.last_deskewed_image, self.last_deskew_boxes,
                            self.last_deskew_angle)
                yield i, boxes
            return
        backend_iter, post_kwargs = self._backend()
        # (upright page or the input, applied angle, estimate or None,
        #  input shape)
        preps = []
        for image in images:
            img, est = None, None
            if self.deskew:
                img = self._load_image(image)
                if img is not None:
                    est = estimate_skew(img)
            if est is not None and abs(est) >= self.deskew_min_angle:
                preps.append((rotate_image(img, -est), est, est, img.shape))
            else:
                preps.append((img if img is not None else image, 0.0, est,
                              None))
        for i, detected in backend_iter([p[0] for p in preps]):
            upright, angle, est, shape = preps[i]
            with annotate("detect.layout"):
                boxes = self._process_boxes_objects(detected, **post_kwargs)
                boxes = self._split_column_merges(upright, boxes)
            if angle:
                kept, boxes = self._to_input_frame(boxes, angle, shape)
                state[i] = (upright, kept, angle)
            else:
                state[i] = (None, None, 0.0)
            if est is not None:
                self.last_skew_angle = est
            yield i, boxes

    def detect_lines_objects_batch(self, images) -> List[List[TextBox]]:
        """``detect_lines_objects`` of many pages, in input order."""
        images = list(images)
        out: List = [None] * len(images)
        for i, boxes in self.iter_lines_objects_batch(images):
            out[i] = boxes
        return out

    def _split_column_merges(self, image, tbs: List[TextBox],
                             min_gap: int = 14) -> List[TextBox]:
        """Split boxes that bridge a column gutter: an ink-free column run
        of at least ``min_gap`` px inside a box is a gutter when a band of
        at least 10 px of it is also ink-free over the rows of the other
        boxes (at least 24 such rows); the parts are tightened to their own
        ink and padded again."""
        if not self.split_columns or len(tbs) < 3:
            return tbs
        img = self._load_image(image)
        if img is None:
            return tbs
        ih, iw = img.shape[:2]
        lo, hi = np.percentile(img, (0.5, 99.5))
        thr = (float(lo) + float(hi)) / 2.0
        dark = img < thr
        ink = dark if dark.mean() <= 0.5 else ~dark
        row_of = np.zeros(ih, bool)
        spans = []
        for b in tbs:
            y0, y1 = max(0, b.y), min(ih, b.y + b.height)
            spans.append((y0, y1))
            row_of[y0:y1] = True
        out: List[TextBox] = []
        for bi, b in enumerate(tbs):
            x0, x1 = max(0, b.x), min(iw, b.x + b.width)
            y0, y1 = spans[bi]
            if x1 - x0 < 3 * min_gap or y1 <= y0:
                out.append(b)
                continue
            prof = ink[y0:y1, x0:x1].sum(axis=0)
            nz = np.nonzero(prof)[0]
            if nz.size == 0:
                out.append(b)
                continue
            own = np.zeros(ih, bool)
            own[y0:y1] = True
            support = row_of & ~own
            if support.sum() < 24:
                out.append(b)
                continue
            blocked_thr = max(2.0, 0.004 * support.sum())
            cuts = []
            run = 0
            for c in range(nz[0], nz[-1] + 1):
                if prof[c] == 0:
                    run += 1
                    continue
                if run >= min_gap:
                    g0, g1 = x0 + c - run, x0 + c
                    blocked = ink[support, g0:g1].sum(axis=0) > blocked_thr
                    clear, best = 0, None
                    for cc in range(g0, g1):
                        if not blocked[cc - g0]:
                            clear += 1
                            if best is None or clear > best[1] - best[0]:
                                best = (cc - clear + 1, cc + 1)
                        else:
                            clear = 0
                    if best is not None and best[1] - best[0] >= 10:
                        cuts.append(best)
                run = 0
            if not cuts:
                out.append(b)
                continue
            edges = [x0 + nz[0]] + [g for cut in cuts for g in cut] \
                + [x0 + nz[-1] + 1]
            for s0, s1 in zip(edges[::2], edges[1::2]):
                ys, xs = np.nonzero(ink[y0:y1, s0:s1])
                if ys.size < 10:
                    continue
                py0, py1 = y0 + ys.min(), y0 + ys.max() + 1
                px0, px1 = s0 + xs.min(), s0 + xs.max() + 1
                pad = max(2, int(round(0.1 * (py1 - py0))))
                out.append(TextBox(
                    max(0, px0 - pad), max(0, py0 - pad),
                    min(iw, px1 + pad) - max(0, px0 - pad),
                    min(ih, py1 + pad) - max(0, py0 - pad),
                    confidence=b.confidence, level=b.level))
        return out

    def _process_boxes_objects(self, detected_boxes, merge=True,
                               skip_sort=False) -> List[TextBox]:
        boxes = []
        padding = self.kwargs.get("padding", 0)
        for item in detected_boxes:
            if isinstance(item, tuple) and len(item) == 2:
                box, confidence = item
            else:
                box, confidence = item, 1.0
            shape = getattr(box, "shape", None)
            if shape is not None and len(shape) == 2 and shape[1] == 2:
                # Quad or polygon outline ([N, 2] points).
                x1, y1 = box[:, 0].min(), box[:, 1].min()
                x2, y2 = box[:, 0].max(), box[:, 1].max()
            else:
                x1, y1, x2, y2 = box
            w, h = x2 - x1, y2 - y1
            if padding:
                x1 = max(0, x1 - padding)
                y1 = max(0, y1 - padding)
                w += 2 * padding
                h += 2 * padding
            boxes.append(TextBox(int(x1), int(y1), int(w), int(h),
                                 confidence=float(confidence),
                                 level=DetectionLevel.LINE))
        if not skip_sort:
            boxes = self._sort_reading_order(boxes)
        if merge:
            boxes = self._merge_overlapping_boxes(boxes)
        return boxes

    def _sort_reading_order(self, boxes: List[TextBox]) -> List[TextBox]:
        """Rows by median height (centres within 0.7 of it), then x."""
        if not boxes:
            return []
        get_cy = lambda b: b.y + b.height / 2  # noqa: E731
        get_cx = lambda b: b.x + b.width / 2  # noqa: E731
        boxes = sorted(boxes, key=get_cy)
        median_h = float(np.median([b.height for b in boxes]))
        y_tol = median_h * 0.7
        lines, current = [], [boxes[0]]
        for b in boxes[1:]:
            avg_cy = float(np.mean([get_cy(lb) for lb in current]))
            if abs(get_cy(b) - avg_cy) < y_tol:
                current.append(b)
            else:
                lines.append(current)
                current = [b]
        lines.append(current)
        out = []
        for line in lines:
            out.extend(sorted(line, key=get_cx))
        return out

    def _merge_overlapping_boxes(self, boxes: List[TextBox],
                                 iou_threshold: float = 0.3) -> List[TextBox]:
        """Merge boxes whose vertical overlap exceeds ``iou_threshold`` of
        the smaller height."""
        if not boxes:
            return []
        boxes = sorted(boxes, key=lambda b: b.y)
        merged, current = [], boxes[0]
        for nxt in boxes[1:]:
            y1c, y2c = current.y, current.y + current.height
            y1n, y2n = nxt.y, nxt.y + nxt.height
            overlap = max(0, min(y2c, y2n) - max(y1c, y1n))
            min_h = min(current.height, nxt.height)
            if min_h > 0 and overlap / min_h > iou_threshold:
                x1 = min(current.x, nxt.x)
                y1 = min(current.y, nxt.y)
                x2 = max(current.x + current.width, nxt.x + nxt.width)
                y2 = max(current.y + current.height, nxt.y + nxt.height)
                conf = (current.confidence + nxt.confidence) / 2
                current = TextBox(x1, y1, x2 - x1, y2 - y1, confidence=conf,
                                  level=current.level)
            else:
                merged.append(current)
                current = nxt
        merged.append(current)
        return merged

    # ------------------------------------------------------- other levels
    def detect_words(self, image) -> List[Tuple[int, int, int, int]]:
        # Words never deskew: a previous page's deskewed frame must not be
        # taken for this call's by the croppers.
        self.last_deskewed_image = None
        self.last_deskew_boxes = None
        self.last_deskew_angle = 0.0
        return self.legacy_detector.detect_words(image)

    def detect_blocks(self, image) -> List[Tuple[int, int, int, int]]:
        """Blocks of the method's lines (the classic-CV detector's own
        blocks for ``"legacy"``)."""
        if self.method == "legacy":
            return self.legacy_detector.detect_blocks(image)
        lines = [TextBox(x, y, w, h, level=DetectionLevel.LINE)
                 for (x, y, w, h) in self.detect_lines(image)]
        img = self._load_image(image)
        if img is None:
            return []
        h, w = img.shape[:2]
        return [b.bbox for b in
                self.legacy_detector._group_lines_into_blocks(lines, w, h)]

    def detect_characters(self, image) -> List[Tuple[int, int, int, int]]:
        return self.legacy_detector.detect_characters(image)

    def detect_all(self, image) -> List[TextBox]:
        return self.legacy_detector.detect_all(image)

    def is_multiline(self, image, threshold: int = 2) -> bool:
        return len(self.detect_lines(image)) >= threshold

    def get_debug_images(self) -> Dict[str, np.ndarray]:
        return self.legacy_detector.get_debug_images()


def detect_text_lines(image, **kwargs):
    return TextDetector(**kwargs).detect_lines(image)


def detect_text_words(image, **kwargs):
    return TextDetector(**kwargs).detect_words(image)


def detect_text_blocks(image, **kwargs):
    return TextDetector(**kwargs).detect_blocks(image)
