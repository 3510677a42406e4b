"""A page's line boxes drawn again from the reference's DB map, and the
crops the recognizer reads from them: DB's post-processing as PaddleOCR
defines it, with the box padding, reading order and column split that the
configuration's detector states. No code of the program under test.

From each component DB keeps (``detector.components``):

1. unclip: its minimum-area rectangle grown by ``area *
   det_db_unclip_ratio / perimeter`` (of its float32 quad) on every side,
   which is the minimum-area rectangle of the quad offset with round
   joins; dropped when its short side is under ``min_size + 2``;
2. to page pixels: each float32 corner x / map_w * page_w, clipped to
   [0, page_w], truncated to an integer (y alike);
3. padding: each box's minimum-area rectangle, long side W and short side
   H, grows along its long side by min(W * padding_pct + H / 2 +
   padding_px, half the horizontal gap to the nearest box that overlaps it
   in y) and along its short side by min(H * padding_y_pct +
   padding_y_px, half the vertical gap to the nearest box that overlaps it
   in x); corners in float32, rounded half to even;
4. reading order: the padded boxes' bounding rectangles (x, y, w, h) by
   centre y, a row taking the next box while its centre lies within
   ``reading_order_tolerance`` of the median height of the row's mean
   centre; each row by x;
5. column split (``split_columns``): ink is the side of the page's
   (0.5 %, 99.5 %) percentile midpoint that covers at most half of it; a
   box at least 42 px wide whose ink profile has an ink-free run of 14 px
   or more is cut there when, over the rows of the other boxes (24 rows or
   more), 10 or more columns of that run hold at most max(2, 0.004 * rows)
   ink pixels (the first longest such stretch); each part keeps at least
   10 ink pixels and becomes its ink's bounding box padded by max(2,
   round(0.1 * its height)), clipped to the page.

A crop is the box grown by ``crop_padding`` and clipped to the page (an
empty one is dropped), inverted when its mean is under 127, resized to the
model's height by ``traffic.preprocess.resize_keep_ratio_pad_np`` (held to
OpenCV's own resize in the tests).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from traffic.preprocess import content_width, resize_keep_ratio_pad_np

from .detector import components, corners, min_area_rect

#: Column split: the least gutter, the least clear band in it, the least
#: rows of other boxes that must see it clear.
GUTTER, BAND, SUPPORT = 14, 10, 24


def _bbox(quad: np.ndarray) -> Tuple[int, int, int, int]:
    x0, y0 = quad[:, 0].min(), quad[:, 1].min()
    return (int(x0), int(y0), int(quad[:, 0].max() - x0),
            int(quad[:, 1].max() - y0))


def unclipped(comps: Sequence[Dict], pred_hw, page_hw, det: Dict
              ) -> List[Tuple[np.ndarray, float]]:
    """Steps 1 and 2: (int quad in page pixels, score) of each kept
    component."""
    (mh, mw), (ph, pw) = pred_hw, page_hw
    out = []
    for c in comps:
        if not c["kept"]:
            continue
        q = c["quad"]
        nxt = np.roll(q, -1, 0)
        area = abs(float(np.sum(q[:, 0] * nxt[:, 1] - nxt[:, 0] * q[:, 1])
                         )) / 2
        perim = float(np.sum(np.hypot(*(nxt - q).T)))
        if area == 0 or perim == 0:
            continue
        d = area * det["det_db_unclip_ratio"] / perim
        ext = tuple(e + 2 * d for e in c["rect"]["ext"])
        if min(ext) < det["min_size"] + 2:
            continue
        box = corners(c["rect"], ext)
        box[:, 0] = np.clip(box[:, 0] / mw * pw, 0, pw)
        box[:, 1] = np.clip(box[:, 1] / mh * ph, 0, ph)
        out.append((box.astype(np.int32), c["score"]))
    return out


def _gap(a0, a1, b0, b1) -> int:
    """The gap between [a0, a1) and [b0, b1) (0 where they overlap)."""
    return a0 - b1 if a0 >= b1 else b0 - a1 if b0 >= a1 else 0


def padded(quads: Sequence[np.ndarray], det: Dict) -> List[np.ndarray]:
    """Step 3."""
    rects = [_bbox(q) for q in quads]
    out = []
    for i, q in enumerate(quads):
        xi, yi, wi, hi = rects[i]
        room_w = room_h = np.inf
        for j, (xj, yj, wj, hj) in enumerate(rects):
            if j == i:
                continue
            if max(yi, yj) < min(yi + hi, yj + hj):
                room_w = min(room_w, _gap(xi, xi + wi, xj, xj + wj))
            if max(xi, xj) < min(xi + wi, xj + wj):
                room_h = min(room_h, _gap(yi, yi + hi, yj, yj + hj))
        rect = min_area_rect(q.astype(np.float64))
        (eu, ev), u = rect["ext"], rect["u"]
        # OpenCV's minAreaRect gives first the side along the axis at an
        # angle in (0, 90] degrees; it is the long one unless shorter.
        first_u = 0 < math.degrees(math.atan2(u[1], u[0])) % 180 <= 90
        first, second = (eu, ev) if first_u else (ev, eu)
        long_u = first_u if first >= second else not first_u
        big, small = max(eu, ev), min(eu, ev)
        grow_w = min(big * det["padding_pct"] + small * 0.5
                     + det["padding_px"], max(0.0, room_w * 0.5))
        grow_h = min(small * det["padding_y_pct"] + det["padding_y_px"],
                     max(0.0, room_h * 0.5))
        ext = ((eu + grow_w, ev + grow_h) if long_u
               else (eu + grow_h, ev + grow_w))
        out.append(np.round(corners(rect, ext).astype(np.float32))
                   .astype(np.int32))
    return out


def reading_order(items: List[Dict], tolerance: float) -> List[Dict]:
    """Step 4 over dicts with a "box" (x, y, w, h)."""
    if not items:
        return []
    items = sorted(items, key=lambda b: b["box"][1] + b["box"][3] / 2)
    tol = float(np.median([b["box"][3] for b in items])) * tolerance
    rows, row = [], []
    for b in items:
        cy = b["box"][1] + b["box"][3] / 2
        if row and abs(cy - np.mean([r["box"][1] + r["box"][3] / 2
                                     for r in row])) >= tol:
            rows.append(row)
            row = []
        row.append(b)
    rows.append(row)
    return [b for r in rows for b in sorted(r, key=lambda b: b["box"][0])]


def _clear_stretch(blocked: np.ndarray) -> Optional[Tuple[int, int]]:
    """The first longest run of False in ``blocked``: (start, stop)."""
    best, start = None, None
    for k, b in enumerate(list(blocked) + [True]):
        if not b and start is None:
            start = k
        elif b and start is not None:
            if best is None or k - start > best[1] - best[0]:
                best = (start, k)
            start = None
    return best


def split_columns(page: np.ndarray, items: List[Dict]) -> List[Dict]:
    """Step 5."""
    if len(items) < 3:
        return items
    ih, iw = page.shape
    lo, hi = np.percentile(page, (0.5, 99.5))
    dark = page < (float(lo) + float(hi)) / 2
    ink = dark if dark.mean() <= 0.5 else ~dark
    spans = [(max(0, b["box"][1]), min(ih, b["box"][1] + b["box"][3]))
             for b in items]
    covered = np.zeros(ih, bool)
    for y0, y1 in spans:
        covered[y0:y1] = True
    out = []
    for b, (y0, y1) in zip(items, spans):
        x, _, w, _ = b["box"]
        x0, x1 = max(0, x), min(iw, x + w)
        if x1 - x0 < 3 * GUTTER or y1 <= y0:
            out.append(b)
            continue
        prof = ink[y0:y1, x0:x1].sum(0)
        cols = np.nonzero(prof)[0]
        support = covered.copy()
        support[y0:y1] = False
        if cols.size == 0 or support.sum() < SUPPORT:
            out.append(b)
            continue
        limit = max(2.0, 0.004 * support.sum())
        cuts, run = [], 0
        for c in range(cols[0], cols[-1] + 1):
            if prof[c] == 0:
                run += 1
                continue
            if run >= GUTTER:
                g0 = x0 + c - run
                clear = _clear_stretch(
                    ink[support, g0:x0 + c].sum(0) > limit)
                if clear and clear[1] - clear[0] >= BAND:
                    cuts.append((g0 + clear[0], g0 + clear[1]))
            run = 0
        if not cuts:
            out.append(b)
            continue
        edges = [x0 + cols[0]] + [e for c in cuts for e in c] \
            + [x0 + cols[-1] + 1]
        for s0, s1 in zip(edges[::2], edges[1::2]):
            ys, xs = np.nonzero(ink[y0:y1, s0:s1])
            if ys.size < 10:
                continue
            py0, py1 = y0 + ys.min(), y0 + ys.max() + 1
            px0, px1 = s0 + xs.min(), s0 + xs.max() + 1
            pad = max(2, int(round(0.1 * (py1 - py0))))
            bx, by = max(0, px0 - pad), max(0, py0 - pad)
            out.append(dict(b, box=(int(bx), int(by),
                                    int(min(iw, px1 + pad) - bx),
                                    int(min(ih, py1 + pad) - by))))
    return out


def page_boxes(pred: np.ndarray, page: np.ndarray, det: Dict) -> List[Dict]:
    """The page's boxes in reading order: [{"box": (x, y, w, h), "score"}]
    from its map ``pred`` (``RefDB.u16_map``)."""
    raw = unclipped(components(pred, det), pred.shape, page.shape, det)
    quads = padded([q for q, _ in raw], det)
    items = reading_order([{"box": _bbox(q), "score": s}
                           for q, (_, s) in zip(quads, raw)],
                          det["reading_order_tolerance"])
    return split_columns(page, items) if det["split_columns"] else items


def crop_lines(cfg: Dict, page: np.ndarray, boxes: Sequence, pad: int
               ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """The model inputs of boxes (x, y, w, h): (u8 lines, content widths,
    indices of the boxes whose crop is not empty)."""
    h, w = int(cfg["IMG_H"]), int(cfg["IMG_W"])
    lines, widths, kept = [], [], []
    for i, (x, y, bw, bh) in enumerate(boxes):
        roi = page[max(0, y - pad):min(page.shape[0], y + bh + pad),
                   max(0, x - pad):min(page.shape[1], x + bw + pad)]
        if roi.size == 0:
            continue
        if float(roi.mean()) < 127.0:
            roi = 255 - roi
        widths.append(content_width(roi.shape, h, w))
        lines.append(resize_keep_ratio_pad_np(roi, h, w))
        kept.append(i)
    if not lines:
        return np.zeros((0, h, w), np.uint8), np.zeros(0, np.int32), kept
    return np.stack(lines), np.asarray(widths, np.int32), kept
