"""CRAFT polygon extraction for curved or rotated text (a copy of
``kiri_tpu/detect/craft/poly.py``, numpy only).

Each quad's component is rectified by a perspective warp, scanned column by
column for the character spine, summarised by five pivot points with their
local slope, extended to the text's ends by a collision search and mapped
back to the image as a 14-point polygon. A box gives ``None`` (the caller
keeps the quad) when the region is small, fills its rectified height
(straight text) or its pivots cannot be placed. The homography, the
nearest-neighbour warp and the segment test replace cv2's
``getPerspectiveTransform``, ``warpPerspective`` and ``line``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

# Reference constants (craft/utils.py:115-120).
NUM_PIVOTS = 5
MAX_LEN_RATIO = 0.7
EXPAND_RATIO = 1.45
MAX_R = 2.0
STEP_R = 0.2


def perspective_matrix(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography M with dst ~ M @ src (both [4,2], in order)."""
    rows, rhs = [], []
    for (x, y), (u, v) in zip(src.astype(np.float64), dst.astype(np.float64)):
        rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        rhs.append(u)
        rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        rhs.append(v)
    m = np.linalg.solve(np.asarray(rows), np.asarray(rhs))
    return np.array([[m[0], m[1], m[2]],
                     [m[3], m[4], m[5]],
                     [m[6], m[7], 1.0]])


def warp_label_nearest(labels: np.ndarray, minv: np.ndarray,
                       w: int, h: int) -> np.ndarray:
    """Inverse-mapped nearest-neighbor warp of an integer label map into a
    [h, w] rectified patch (cv2.warpPerspective INTER_NEAREST equivalent)."""
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], axis=0).reshape(3, -1).astype(np.float64)
    src = minv @ pts
    z = src[2]
    z = np.where(np.abs(z) < 1e-12, 1e-12, z)
    sx = np.rint(src[0] / z).astype(np.int64)
    sy = np.rint(src[1] / z).astype(np.int64)
    inb = (sx >= 0) & (sx < labels.shape[1]) & (sy >= 0) & (sy < labels.shape[0])
    out = np.zeros(w * h, labels.dtype)
    out[inb] = labels[sy[inb], sx[inb]]
    return out.reshape(h, w)


def _warp_back(minv: np.ndarray, x: float, y: float) -> np.ndarray:
    """Patch coords -> image coords (reference warpCoord, utils.py:~290)."""
    p = minv @ np.array([x, y, 1.0])
    return np.array([p[0] / p[2], p[1] / p[2]], np.float32)


def _segment_hits(mask: np.ndarray, p: np.ndarray) -> bool:
    """True if the segment (x0,y0,x1,y1) crosses any nonzero mask pixel
    (replaces the reference's cv2.line + logical_and collision test)."""
    x0, y0, x1, y1 = p
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 2
    xs = np.rint(np.linspace(x0, x1, n)).astype(np.int64)
    ys = np.rint(np.linspace(y0, y1, n)).astype(np.int64)
    inb = (xs >= 0) & (xs < mask.shape[1]) & (ys >= 0) & (ys < mask.shape[0])
    if not inb.any():
        return False
    return bool(mask[ys[inb], xs[inb]].any())


def get_poly_core(boxes: Sequence[np.ndarray], labels: np.ndarray,
                  mapper: Sequence[int]) -> List[Optional[np.ndarray]]:
    """Per-box polygon or None; indices align with ``boxes``."""
    polys: List[Optional[np.ndarray]] = []
    for k, box in enumerate(boxes):
        w = int(np.linalg.norm(box[0] - box[1]) + 1)
        h = int(np.linalg.norm(box[1] - box[2]) + 1)
        if w < 10 or h < 10:
            polys.append(None)
            continue

        rect = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        m = perspective_matrix(np.asarray(box, np.float64), rect)
        try:
            minv = np.linalg.inv(m)
        except np.linalg.LinAlgError:
            polys.append(None)
            continue
        patch = warp_label_nearest(labels, minv, w, h)
        word = (patch == mapper[k])

        # Column-wise spine: first/last occupied row per column with >=2
        # occupied pixels (reference utils.py:145-157), vectorized.
        counts = word.sum(axis=0)
        has = counts >= 2
        first = np.argmax(word, axis=0)
        last = h - 1 - np.argmax(word[::-1], axis=0)
        col_x = np.nonzero(has)[0]
        if col_x.size == 0:
            polys.append(None)
            continue
        seg_len = last[col_x] - first[col_x] + 1
        if h * MAX_LEN_RATIO < seg_len.max():
            polys.append(None)  # fills the height: straight text, quad wins
            continue

        # Pivot placement over 2*NUM_PIVOTS+1 fixed-width segments: odd
        # segments carry a pivot at their tallest column; every segment
        # accumulates a center-of-mass anchor (reference utils.py:159-203).
        tot_seg = NUM_PIVOTS * 2 + 1
        seg_w = w / tot_seg
        pivots: List[Optional[tuple]] = [None] * NUM_PIVOTS
        seg_height = np.zeros(NUM_PIVOTS)
        anchors = np.zeros((tot_seg, 2))
        anchor_n = np.zeros(tot_seg, np.int64)
        seg_num = 0
        prev_h = -1
        broke = False
        for x, sy, ey, cur_h in zip(col_x, first[col_x], last[col_x], seg_len):
            if (seg_num + 1) * seg_w <= x and seg_num <= tot_seg:
                if anchor_n[seg_num] == 0:
                    broke = True
                    break
                seg_num += 1
                prev_h = -1
                if seg_num >= tot_seg:
                    break
            cy = (sy + ey) * 0.5
            anchors[seg_num] += (x, cy)
            anchor_n[seg_num] += 1
            if seg_num % 2 == 0:
                continue  # even segments are anchor-only
            if prev_h < cur_h:
                pivots[(seg_num - 1) // 2] = (x, cy)
                seg_height[(seg_num - 1) // 2] = cur_h
                prev_h = cur_h
        if broke or any(p is None for p in pivots) \
                or seg_w < seg_height.max() * 0.25:
            polys.append(None)
            continue
        anchors = anchors / np.maximum(1, anchor_n)[:, None]

        # Vertical half-extent and locally-rotated pivot normals
        # (reference utils.py:205-223).
        half_h = float(np.median(seg_height)) * EXPAND_RATIO / 2
        spans = []
        for i, (px, pcy) in enumerate(pivots):
            dx = anchors[i * 2 + 2][0] - anchors[i * 2][0]
            dy = anchors[i * 2 + 2][1] - anchors[i * 2][1]
            if dx == 0:
                spans.append([px, pcy - half_h, px, pcy + half_h])
                continue
            rad = -math.atan2(dy, dx)
            c = half_h * math.cos(rad)
            s = half_h * math.sin(rad)
            spans.append([px - s, pcy - c, px + s, pcy + c])

        # Start/end caps: slide outward along the spine slope until the
        # cap segment clears the component (reference utils.py:225-252).
        def slope(a, b):
            denom = pivots[b][0] - pivots[a][0]
            return (pivots[b][1] - pivots[a][1]) / (denom if denom else 1e-9)

        grad_s = slope(0, 1) + slope(1, 2)
        grad_e = slope(-1, -2) + slope(-2, -3)
        spp = epp = None
        for r in np.arange(0.5, MAX_R, STEP_R):
            dx = 2 * half_h * r
            last_try = r + 2 * STEP_R >= MAX_R
            if spp is None:
                p = np.asarray(spans[0]) - np.array([dx, grad_s * dx] * 2)
                if not _segment_hits(word, p) or last_try:
                    spp = p
            if epp is None:
                p = np.asarray(spans[-1]) + np.array([dx, grad_e * dx] * 2)
                if not _segment_hits(word, p) or last_try:
                    epp = p
            if spp is not None and epp is not None:
                break
        if spp is None or epp is None:
            polys.append(None)
            continue

        # Assemble: start cap, top edge, end cap, bottom edge (reversed),
        # all mapped back to image space (reference utils.py:254-266).
        pts = [_warp_back(minv, spp[0], spp[1])]
        pts += [_warp_back(minv, s[0], s[1]) for s in spans]
        pts.append(_warp_back(minv, epp[0], epp[1]))
        pts.append(_warp_back(minv, epp[2], epp[3]))
        pts += [_warp_back(minv, s[2], s[3]) for s in reversed(spans)]
        pts.append(_warp_back(minv, spp[2], spp[3]))
        polys.append(np.asarray(pts, np.float32))
    return polys
