"""The classic-CV text detector (no learned model), the port of
``kiri_tpu/detect/legacy.py`` without cv2.

Method for method as the JAX package's ``ImageProcessingTextDetector``,
with the same arguments, defaults, boxes and ``_debug`` images: a sweep of
binarisations (CLAHE-enhanced grey in both polarities, per-channel RGB, HSV
and LAB masks on colour pages, a morphological gradient) scored by
text-likeness, MSER and Canny stroke components, IoU de-duplication, then
the line, word, block and character hierarchy. Every image operation is
``ops/cvops.py`` (numpy and ``native/cvops.cpp``), byte for byte as OpenCV
5.0 computes it; the detector stays on the host.

Two loops are rewritten to scale, with identical results:
``_group_into_lines`` keeps each line's median top and bottom (sorted edges,
updated on each append) and tests a component against every line in one
vector operation, instead of recomputing two medians a line a component;
``_split_line_to_words`` keeps the running right edge of the open word.

Tie order: the reference sorts with numpy's default (unstable) argsort, so
the component and line order are those of numpy's sort; the port calls the
same function on the same arrays.
"""
from __future__ import annotations

import bisect
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import cvops
from ..ops.imgproc import resize_u8
from ..ops.preprocess import to_gray
from ..utils.imageio import imread_bgr
from .base import DetectionLevel, TextBox


class ImageProcessingTextDetector:
    def __init__(self, min_area: int = 10, max_area_ratio: float = 0.9,
                 min_aspect: float = 0.02, max_aspect: float = 50.0,
                 line_overlap_ratio: float = 0.5,
                 word_gap_ratio: float = 0.7,
                 block_gap_ratio: float = 1.8,
                 max_side: int = 1600,
                 use_mser: bool = True,
                 use_gradient: bool = True,
                 use_color_channels: bool = True,
                 min_text_width: int = 2,
                 min_text_height: int = 6, **_ignored):
        self.min_area = min_area
        self.max_area_ratio = max_area_ratio
        self.min_aspect = min_aspect
        self.max_aspect = max_aspect
        self.line_overlap_ratio = line_overlap_ratio
        self.word_gap_ratio = word_gap_ratio
        self.block_gap_ratio = block_gap_ratio
        self.max_side = max_side
        self.use_mser = use_mser
        self.use_gradient = use_gradient
        self.use_color_channels = use_color_channels
        self.min_text_width = min_text_width
        self.min_text_height = min_text_height
        self._debug: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ public API
    def detect_lines(self, image) -> List[Tuple[int, int, int, int]]:
        return [b.bbox for b in self._detect_lines_objects(image)]

    def detect_words(self, image) -> List[Tuple[int, int, int, int]]:
        img, color = self._load_images(image)
        if img is None:
            return []
        words = []
        for line in self._group_into_lines(self._components(img, color)):
            words.extend(self._split_line_to_words(line))
        return [w.bbox for w in words]

    def detect_characters(self, image) -> List[Tuple[int, int, int, int]]:
        img, color = self._load_images(image)
        if img is None:
            return []
        return [tuple(c) for c in self._components(img, color)]

    def detect_blocks(self, image) -> List[Tuple[int, int, int, int]]:
        img, color = self._load_images(image)
        if img is None:
            return []
        lines = self._lines_from_components(self._components(img, color))
        h, w = img.shape[:2]
        return [b.bbox for b in self._group_lines_into_blocks(lines, w, h)]

    def detect_all(self, image) -> List[TextBox]:
        """Full hierarchy: blocks containing lines containing words/chars."""
        img, color = self._load_images(image)
        if img is None:
            return []
        h, w = img.shape[:2]
        comps = self._components(img, color)
        comp_lines = self._group_into_lines(comps)
        line_boxes = self._boxes_of_lines(comp_lines)
        for lb, lc in zip(line_boxes, comp_lines):
            words = self._split_line_to_words(lc)
            centres = lc[:, 0] + lc[:, 2] / 2
            for wbox in words:
                inside = (wbox.x <= centres) & (centres <= wbox.x + wbox.width)
                wbox.children = [
                    TextBox(int(c[0]), int(c[1]), int(c[2]), int(c[3]),
                            level=DetectionLevel.CHARACTER)
                    for c in lc[inside]]
            lb.children = words
        return self._group_lines_into_blocks(line_boxes, w, h)

    def is_multiline(self, image, threshold: int = 2) -> bool:
        return len(self.detect_lines(image)) >= threshold

    def get_debug_images(self) -> Dict[str, np.ndarray]:
        return self._debug

    # ----------------------------------------------------------- core stages
    def _load_image(self, image) -> Optional[np.ndarray]:
        gray, _ = self._load_images(image)
        return gray

    def _load_images(self, image) -> Tuple[Optional[np.ndarray],
                                           Optional[np.ndarray]]:
        """Returns (gray, color-or-None); color kept for channel candidates.
        A path is read with ``utils.imageio.imread_bgr``."""
        if isinstance(image, (str, Path)):
            img = imread_bgr(image)
            if img is None:
                return None, None
        else:
            img = np.asarray(image)
        if img.ndim == 3:
            return to_gray(img), img
        return img, None

    def _binary_candidates(self, gray: np.ndarray,
                           color: Optional[np.ndarray] = None
                           ) -> List[Tuple[str, np.ndarray]]:
        """CLAHE-enhanced grey families in both polarities, per-channel
        RGB/HSV/LAB masks on colour input, and a morphological-gradient
        edge mask (the JAX package's sweep, in its order)."""
        cands: List[Tuple[str, np.ndarray]] = []
        enhanced = cvops.clahe(gray, 2.0, (8, 8))

        otsu = cvops.threshold_otsu(enhanced)[1]
        cands += [("otsu", otsu), ("otsu_inv", 255 - otsu)]
        for name, method, block, c in (
                ("adaptive_gauss", "gaussian", 21, 10),
                ("adaptive_mean", "mean", 15, 8),
                ("sauvola", "gaussian", 51, 20),
                ("niblack", "mean", 11, 5)):
            m = cvops.adaptive_threshold(enhanced, method, block, c)
            cands += [(name, m), (f"{name}_inv", 255 - m)]

        if self.use_color_channels and color is not None:
            for i, ch_name in enumerate(("blue", "green", "red")):
                m = cvops.threshold_otsu(cvops.clahe(color[:, :, i]))[1]
                cands += [(f"{ch_name}_otsu", m),
                          (f"{ch_name}_otsu_inv", 255 - m)]
            hsv = cvops.bgr_to_hsv(color)
            m = cvops.threshold_otsu(cvops.clahe(hsv[:, :, 2]))[1]
            cands += [("hsv_v_otsu", m), ("hsv_v_otsu_inv", 255 - m)]
            cands.append(("hsv_s", cvops.threshold(hsv[:, :, 1], 50)))
            lab = cvops.bgr_to_lab(color)
            m = cvops.threshold_otsu(cvops.clahe(lab[:, :, 0]))[1]
            cands += [("lab_l_otsu", m), ("lab_l_otsu_inv", 255 - m)]
            for i, ch_name in enumerate(("a", "b")):
                ch = lab[:, :, i + 1]
                cands += [(f"lab_{ch_name}_high", cvops.threshold(ch, 160)),
                          (f"lab_{ch_name}_low",
                           cvops.threshold(ch, 96, inv=True))]

        grad = cvops.morph_gradient_cross(enhanced)
        cands.append(("morph_gradient", cvops.threshold_otsu(grad)[1]))
        return cands

    def _binarize(self, gray: np.ndarray,
                  color: Optional[np.ndarray] = None) -> np.ndarray:
        """The best text mask of the sweep by text-likeness, with at most
        one complementary mask OR-ed in (``_complementary_mask``)."""
        cands = self._binary_candidates(gray, color)
        img_area = gray.shape[0] * gray.shape[1]
        scored: List[Tuple[float, str, np.ndarray]] = []
        best, best_score = cands[0][1], -1.0
        for name, b in cands:
            n, _, stats = cvops.connected_components_with_stats(b)
            if n <= 1:
                continue
            areas = stats[1:, 4]
            hs = stats[1:, 3]
            good = ((areas > self.min_area) & (areas < img_area * 0.2)).sum()
            fg_ratio = float(b.mean()) / 255.0
            if fg_ratio > 0.5 or fg_ratio < 0.0005:
                score = 0.0
            else:
                h_med = float(np.median(hs)) if len(hs) else 1.0
                h_consistency = float((np.abs(hs - h_med) < h_med).mean()) \
                    if len(hs) else 0
                score = good * (0.5 + 0.5 * h_consistency)
            self._debug[f"bin_{name}"] = b
            if score > 0:
                scored.append((score, name, b))
            if score > best_score:
                best, best_score = b, score
        if best_score > 0:
            comp = self._complementary_mask(best, best_score, scored)
            if comp is not None:
                self._debug["bin_union_second"] = comp
                best = np.bitwise_or(best, comp)
        return best

    def _complementary_mask(self, best: np.ndarray, best_score: float,
                            scored: List[Tuple[float, str, np.ndarray]]
                            ) -> Optional[np.ndarray]:
        """The highest-scoring mask whose foreground is mostly disjoint from
        the winner's, reduced to its text-sized components, or None."""
        best_fg = best > 0
        img_area = best.shape[0] * best.shape[1]
        pick, pick_score = None, 0.3 * best_score
        for score, _name, b in scored:
            if score <= pick_score or b is best:
                continue
            fg = b > 0
            own = int(fg.sum())
            if own == 0:
                continue
            overlap = int((fg & best_fg).sum()) / own
            if overlap < 0.25:
                pick, pick_score = b, score
        if pick is None:
            return None
        n, labels, stats = cvops.connected_components_with_stats(pick)
        if n <= 1:
            return None
        areas = stats[1:, 4]
        keep = np.flatnonzero((areas > self.min_area)
                              & (areas < img_area * 0.05)) + 1
        if keep.size == 0:
            return None
        return np.isin(labels, keep).astype(np.uint8) * 255

    def _mser_components(self, gray: np.ndarray) -> np.ndarray:
        """MSER boxes of both polarities with solidity in (0.2, 0.95)."""
        out = []
        for src in (gray, 255 - gray):
            try:
                reg = cvops.mser(src, delta=5, min_area=30, max_area=14400,
                                 max_variation=0.25, min_diversity=0.2)
            except ValueError:  # smaller than 3x3, as cv2 raises
                continue
            w, h = reg.rects[:, 2], reg.rects[:, 3]
            solidity = np.divide(reg.area, reg.hull_area,
                                 out=np.zeros_like(reg.area),
                                 where=reg.hull_area > 0)
            keep = ((w >= self.min_text_width) & (h >= self.min_text_height)
                    & (solidity > 0.2) & (solidity < 0.95))
            out.append(reg.rects[keep])
        return np.concatenate(out, 0).astype(np.int32).reshape(-1, 4) \
            if out else np.zeros((0, 4), np.int32)

    def _gradient_components(self, gray: np.ndarray) -> np.ndarray:
        """Canny stroke components: dilated edges -> external contours,
        kept when the Sobel magnitude inside is consistent."""
        gx = cvops.sobel3(gray, 1, 0)
        gy = cvops.sobel3(gray, 0, 1)
        magnitude = np.sqrt(gx ** 2 + gy ** 2)
        mmax = magnitude.max()
        if mmax <= 0:
            return np.zeros((0, 4), np.int32)
        magnitude = (magnitude / mmax * 255).astype(np.uint8)
        edges = cvops.canny(gray, 50, 150)
        dilated = cvops.dilate_rect(edges, 3, 1, iterations=2)
        self._debug["gradient_edges"] = dilated
        out = []
        for x, y, w, h in cvops.external_contour_rects(dilated).tolist():
            if w < self.min_text_width or h < self.min_text_height:
                continue
            roi = magnitude[y:y + h, x:x + w]
            strong = roi[roi > 20]
            if strong.size <= 10:
                continue
            consistency = 1.0 - float(np.std(strong)) / (
                float(np.mean(strong)) + 1e-6)
            aspect = w / h
            if consistency > 0 and 0.05 < aspect < 15:
                out.append((x, y, w, h))
        return np.asarray(out, np.int32).reshape(-1, 4)

    @staticmethod
    def _nms_boxes(boxes: np.ndarray, iou_thr: float = 0.5) -> np.ndarray:
        """Greedy IoU dedup, larger boxes first."""
        if len(boxes) <= 1:
            return boxes
        areas = boxes[:, 2].astype(np.float64) * boxes[:, 3]
        order = np.argsort(-areas)
        b = boxes[order].astype(np.float64)
        a = areas[order]
        x1, y1 = b[:, 0], b[:, 1]
        x2, y2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
        keep = []
        alive = np.ones(len(b), bool)
        for i in range(len(b)):
            if not alive[i]:
                continue
            keep.append(order[i])
            xx1 = np.maximum(x1[i], x1[i + 1:])
            yy1 = np.maximum(y1[i], y1[i + 1:])
            xx2 = np.minimum(x2[i], x2[i + 1:])
            yy2 = np.minimum(y2[i], y2[i + 1:])
            inter = (np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1))
            iou = inter / np.maximum(1e-9, a[i] + a[i + 1:] - inter)
            alive[i + 1:] &= iou <= iou_thr
        return boxes[np.asarray(keep, np.int64)]

    def _filter_boxes(self, boxes: np.ndarray, img_area: int,
                      img_h: int) -> np.ndarray:
        if len(boxes) == 0:
            return boxes.reshape(0, 4)
        w = boxes[:, 2].astype(np.float32)
        h = boxes[:, 3].astype(np.float32)
        areas = w * h
        aspect = w / np.maximum(h, 1)
        keep = ((areas > self.min_area)
                & (areas < img_area * self.max_area_ratio)
                & (aspect > self.min_aspect) & (aspect < self.max_aspect)
                & (h < img_h * 0.95))
        return boxes[keep]

    def _components(self, gray: np.ndarray,
                    color: Optional[np.ndarray] = None) -> np.ndarray:
        """[K, 4] (x, y, w, h) candidate character components from the best
        binarization plus the MSER and gradient sources, NMS-deduped."""
        h0, w0 = gray.shape[:2]
        scale = 1.0
        if max(h0, w0) > self.max_side:
            scale = self.max_side / max(h0, w0)
            gray = resize_u8(gray, int(w0 * scale), int(h0 * scale))
            if color is not None:
                color = resize_u8(color, gray.shape[1], gray.shape[0])
        binary = self._binarize(gray, color)
        self._debug["binary"] = binary
        img_area = gray.shape[0] * gray.shape[1]

        n, _, stats = cvops.connected_components_with_stats(binary)
        if n > 1:
            cc_boxes = stats[1:, :4]
            # The CC source filters on component pixel area.
            cc_areas = stats[1:, 4]
            w = cc_boxes[:, 2].astype(np.float32)
            h = cc_boxes[:, 3].astype(np.float32)
            aspect = w / np.maximum(h, 1)
            keep = ((cc_areas > self.min_area)
                    & (cc_areas < img_area * self.max_area_ratio)
                    & (aspect > self.min_aspect) & (aspect < self.max_aspect)
                    & (h < gray.shape[0] * 0.95))
            boxes = cc_boxes[keep]
        else:
            boxes = np.zeros((0, 4), np.int32)

        extra = []
        if self.use_mser:
            extra.append(self._filter_boxes(self._mser_components(gray),
                                            img_area, gray.shape[0]))
        if self.use_gradient:
            extra.append(self._filter_boxes(self._gradient_components(gray),
                                            img_area, gray.shape[0]))
        if extra:
            boxes = np.concatenate([boxes.reshape(-1, 4)] +
                                   [e.reshape(-1, 4) for e in extra], axis=0)
        boxes = self._nms_boxes(boxes.astype(np.int32))
        if scale != 1.0 and len(boxes):
            boxes = (boxes / scale).astype(np.int32)
        return boxes.astype(np.int32)

    def _group_into_lines(self, comps: np.ndarray) -> List[np.ndarray]:
        """Components into text lines by vertical overlap: in order of
        their centre, each joins the first line (in creation order) whose
        median top/bottom it overlaps by more than ``line_overlap_ratio``
        of the smaller height, or starts a line; lines sorted by their
        median top (stable)."""
        if len(comps) == 0:
            return []
        order = np.argsort(comps[:, 1] + comps[:, 3] / 2)
        comps = comps[order]
        tops = comps[:, 1].astype(np.float64)
        bottoms = (comps[:, 1] + comps[:, 3]).astype(np.float64)
        heights = comps[:, 3].astype(np.float64)
        cap = 64
        ly1 = np.empty(cap)
        ly2 = np.empty(cap)
        members: List[List[int]] = []
        edges: List[Tuple[List[float], List[float]]] = []
        ratio = self.line_overlap_ratio
        for i in range(len(comps)):
            c1, c2, ch = tops[i], bottoms[i], heights[i]
            n = len(members)
            k = -1
            if n:
                a, b = ly1[:n], ly2[:n]
                ov = np.minimum(b, c2) - np.maximum(a, c1)
                lh = np.maximum(1.0, b - a)
                hit = np.flatnonzero(ov > ratio * np.minimum(lh, ch))
                if hit.size:
                    k = int(hit[0])
            if k < 0:
                if n == cap:
                    cap *= 2
                    ly1, ly2 = (np.resize(v, cap) for v in (ly1, ly2))
                members.append([i])
                edges.append(([c1], [c2]))
                ly1[n], ly2[n] = c1, c2
                continue
            members[k].append(i)
            t, bt = edges[k]
            bisect.insort(t, c1)
            bisect.insort(bt, c2)
            ly1[k], ly2[k] = _median_sorted(t), _median_sorted(bt)
        lines = sorted(range(len(members)), key=lambda j: ly1[j])
        return [comps[members[j]] for j in lines]

    def _boxes_of_lines(self, lines: List[np.ndarray]) -> List[TextBox]:
        boxes = []
        for line in lines:
            x1 = int(line[:, 0].min())
            y1 = int(line[:, 1].min())
            x2 = int((line[:, 0] + line[:, 2]).max())
            y2 = int((line[:, 1] + line[:, 3]).max())
            boxes.append(TextBox(x1, y1, x2 - x1, y2 - y1,
                                 level=DetectionLevel.LINE))
        return boxes

    def _lines_from_components(self, comps: np.ndarray) -> List[TextBox]:
        return self._boxes_of_lines(self._group_into_lines(comps))

    def _detect_lines_objects(self, image) -> List[TextBox]:
        img, color = self._load_images(image)
        if img is None:
            return []
        return self._lines_from_components(self._components(img, color))

    def _split_line_to_words(self, line_comps: np.ndarray) -> List[TextBox]:
        """Left to right, a component more than ``word_gap_ratio`` x half
        the median height right of the open word's right edge starts a new
        word."""
        if len(line_comps) == 0:
            return []
        order = np.argsort(line_comps[:, 0])
        cs = line_comps[order]
        med_h = float(np.median(cs[:, 3]))
        gap_thr = max(2.0, self.word_gap_ratio * med_h * 0.5)
        xs = cs[:, 0].tolist()
        ys = cs[:, 1].tolist()
        rights = (cs[:, 0] + cs[:, 2]).tolist()
        bottoms = (cs[:, 1] + cs[:, 3]).tolist()
        out = []
        x1, y1, x2, y2 = xs[0], ys[0], rights[0], bottoms[0]
        for j in range(1, len(xs)):
            if xs[j] - x2 > gap_thr:
                out.append(TextBox(x1, y1, x2 - x1, y2 - y1,
                                   level=DetectionLevel.WORD))
                x1, y1, x2, y2 = xs[j], ys[j], rights[j], bottoms[j]
            else:
                x1, y1 = min(x1, xs[j]), min(y1, ys[j])
                x2, y2 = max(x2, rights[j]), max(y2, bottoms[j])
        out.append(TextBox(x1, y1, x2 - x1, y2 - y1,
                           level=DetectionLevel.WORD))
        return out

    def _group_lines_into_blocks(self, line_boxes: List[TextBox], img_w: int,
                                 img_h: int) -> List[TextBox]:
        """Vertically-adjacent, x-overlapping lines -> blocks."""
        if not line_boxes:
            return []
        lines = sorted(line_boxes, key=lambda b: b.y)
        med_h = float(np.median([b.height for b in lines])) or 10.0
        blocks: List[List[TextBox]] = [[lines[0]]]
        for b in lines[1:]:
            last = blocks[-1][-1]
            v_gap = b.y - (last.y + last.height)
            x_ov = (min(b.x + b.width, last.x + last.width)
                    - max(b.x, last.x))
            if v_gap < self.block_gap_ratio * med_h and x_ov > 0:
                blocks[-1].append(b)
            else:
                blocks.append([b])
        out = []
        for group in blocks:
            x1 = min(b.x for b in group)
            y1 = min(b.y for b in group)
            x2 = max(b.x + b.width for b in group)
            y2 = max(b.y + b.height for b in group)
            blk = TextBox(x1, y1, x2 - x1, y2 - y1, level=DetectionLevel.BLOCK)
            blk.children = group
            out.append(blk)
        return out


def _median_sorted(v: List[float]) -> float:
    """np.median of a sorted list: the middle value, or the mean of the two
    middle values."""
    n = len(v)
    m = n // 2
    return v[m] if n % 2 else (v[m - 1] + v[m]) / 2
