# Frozen copy of kiri_tpu_torch/ops/draw.py at commit
# 0bc739aac3bff3542a3b3238ea9226e557ccfdbd, for the benchmark's traffic and
# reference; later changes to the program do not reach it.
"""Pillow's ``ImageDraw`` for "L" images, in numpy: what the pseudo-glyph
font and the generators draw with, pixel for pixel as Pillow 12.1
(``libImaging/Draw.c``, ``Paste.c``) computes it.

- ``line``: width 0 or 1 draws each segment with Pillow's Bresenham (the
  end point left to the next segment) and then the last point; a wider line
  draws each segment as its own four-corner polygon (no joint), the corners
  offset by ``ROUND_DOWN``/``ROUND_UP`` of (width - 1) / 2 along the normal;
- a wide segment's quadrilateral is filled by Pillow's scanline
  (``polygon_generic``): float32 edge crossings, a
  horizontal edge drawn as one span, an edge's last row doubled below the
  polygon's last row, corners that meet on an exact integer crossing pulled
  to the next row's crossings, spans from ``ROUND_UP`` of the left crossing
  to ``ROUND_DOWN`` of the right;
- ``ellipse`` and ``arc``: Pillow's integer "quarter" rasterizer on doubled
  coordinates (the stripe between an outer ellipse and an inner one 2 (w - 1)
  smaller), an arc clipped by the two half-planes of its end angles;
- ``polygon(outline=)`` draws the closing width-1 segments, ``rectangle(
  fill=)`` the inclusive span of every row;
- ``draw_bitmap`` composites a text mask as ``ImageDraw.text`` does: the
  origin truncated toward zero, the mask clipped to the image and ink
  blended through it with Pillow's ``DIV255`` rounding.

Every primitive writes ``ink`` into the u8 array in place and clips to it.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

_f32 = np.float32
_HALF = _f32(0.5)


def _round_up(f) -> int:
    """Pillow's ``ROUND_UP``: ``floor(f + 0.5F)``, mirrored for negatives;
    in float32 for a float32 ``f``, in float64 for a Python float."""
    half = _HALF if isinstance(f, np.float32) else 0.5
    if f >= 0:
        return int(math.floor(f + half))
    return -int(math.floor(abs(f) + half))


def _round_down(f) -> int:
    """Pillow's ``ROUND_DOWN``: ``ceil(f - 0.5F)``, mirrored for
    negatives."""
    half = _HALF if isinstance(f, np.float32) else 0.5
    if f >= 0:
        return int(math.ceil(f - half))
    return -int(math.ceil(abs(f) - half))


def _roundf(f) -> np.float32:
    """C's ``roundf``: half away from zero."""
    f = _f32(f)
    r = _f32(math.floor(abs(f) + 0.5))
    return r if f >= 0 else -r


def _points(xy) -> List[Tuple[int, int]]:
    """A flat ``[x0, y0, x1, y1, ...]`` or a sequence of pairs, each
    coordinate truncated as Pillow's C code casts it."""
    flat = []
    for v in xy:
        if isinstance(v, (tuple, list)):
            flat.extend(v)
        else:
            flat.append(v)
    return [(int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2)]


class Draw:
    """``ImageDraw.Draw`` over a u8 [H, W] array (mode "L")."""

    def __init__(self, im: np.ndarray):
        if im.dtype != np.uint8 or im.ndim != 2:
            raise ValueError("Draw needs a u8 [H, W] array")
        self.im = im
        self.h, self.w = im.shape

    # ----------------------------------------------------------- low level
    def _point(self, x: int, y: int, ink: int) -> None:
        if 0 <= x < self.w and 0 <= y < self.h:
            self.im[y, x] = ink

    def _hline(self, x0: int, y: int, x1: int, ink: int) -> None:
        if 0 <= y < self.h:
            x0, x1 = max(x0, 0), min(x1, self.w - 1)
            if x0 <= x1:
                self.im[y, x0:x1 + 1] = ink

    def _line1(self, x0: int, y0: int, x1: int, y1: int, ink: int) -> None:
        """``line8``: Bresenham without the end point."""
        dx, xs = (x0 - x1, -1) if x1 < x0 else (x1 - x0, 1)
        dy, ys = (y0 - y1, -1) if y1 < y0 else (y1 - y0, 1)
        if dx == 0:
            for _ in range(dy):
                self._point(x0, y0, ink)
                y0 += ys
        elif dy == 0:
            for _ in range(dx):
                self._point(x0, y0, ink)
                x0 += xs
        elif dx > dy:
            n, dy2 = dx, dy + dy
            e, dx2 = dy2 - dx, dx + dx
            for _ in range(n):
                self._point(x0, y0, ink)
                if e >= 0:
                    y0 += ys
                    e -= dx2
                e += dy2
                x0 += xs
        else:
            n, dx2 = dy, dx + dx
            e, dy2 = dx2 - dy, dy + dy
            for _ in range(n):
                self._point(x0, y0, ink)
                if e >= 0:
                    x0 += xs
                    e -= dy2
                e += dx2
                y0 += ys

    def _wide_line(self, x0: int, y0: int, x1: int, y1: int, ink: int,
                   width: int) -> None:
        """``ImagingDrawWideLine``: one segment as a filled quadrilateral."""
        dx, dy = x1 - x0, y1 - y0
        if dx == 0 and dy == 0:
            self._point(x0, y0, ink)
            return
        big = math.hypot(dx, dy)
        small = (width - 1) / 2.0
        ratio_max = _round_up(small) / big
        ratio_min = _round_down(small) / big
        dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
        dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
        v = [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
             (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)]
        self._fill_polygon(v, ink)

    def _fill_polygon(self, pts: Sequence[Tuple[int, int]], ink: int) -> None:
        """``polygon_generic`` (no alpha) over the closed vertex list."""
        edges = []
        n = len(pts)
        for i in range(n):
            (ax, ay), (bx, by) = pts[i], pts[(i + 1) % n]
            dxe = _f32(0) if ay == by else _f32(_f32(bx - ax) / _f32(by - ay))
            edges.append((min(ax, bx), max(ax, bx), min(ay, by), max(ay, by),
                          dxe, ax, ay))
        ymin, ymax = self.h - 1, 0
        table = []
        for e in edges:
            xmin, xmax, eymin, eymax = e[:4]
            ymin, ymax = min(ymin, eymin), max(ymax, eymax)
            if eymin == eymax:
                self._hline(xmin, eymin, xmax, ink)
                continue
            table.append(e)
        ymin, ymax = max(ymin, 0), min(ymax, self.h)

        def at(e, y) -> np.float32:
            return _f32(_f32(y - e[6]) * e[4]) + _f32(e[5])

        for y in range(ymin, ymax + 1):
            xx: List[np.float32] = []
            for i, cur in enumerate(table):
                if not (cur[2] <= y <= cur[3]):
                    continue
                xx.append(at(cur, y))
                if y == cur[3] and y < ymax:
                    xx.append(xx[-1])
                elif (cur[4] != 0 and len(xx) % 2 == 1
                      and _roundf(xx[-1]) == xx[-1]):
                    # Corners that meet on an exact crossing take the
                    # adjacent row's crossings.
                    for other in table[:i]:
                        if ((cur[4] > 0 and other[4] <= 0)
                                or (cur[4] < 0 and other[4] >= 0)):
                            continue
                        if _roundf(xx[-1]) != _roundf(at(other, y)):
                            continue
                        off = -1 if y == ymax else 1
                        adj = at(cur, y + off)
                        if not (other[2] <= y + off <= other[3]):
                            continue
                        adj_o = at(other, y + off)
                        if xx[-1] > adj + 1 and xx[-1] > adj_o + 1:
                            xx[-1] = _roundf(max(adj, adj_o)) + 1
                        elif xx[-1] < adj - 1 and xx[-1] < adj_o - 1:
                            xx[-1] = _roundf(min(adj, adj_o)) - 1
                        break
            xx.sort()
            for k in range(1, len(xx), 2):
                self._hline(_round_up(xx[k - 1]), y, _round_down(xx[k]), ink)

    # ------------------------------------------------------------ ellipses
    @staticmethod
    def _quarter(a: int, b: int):
        """``quarter_next``'s points of one quarter (doubled coordinates),
        or None for a negative axis."""
        if a < 0 or b < 0:
            return None
        a2, b2 = a * a, b * b
        a2b2 = a2 * b2

        def delta(x, y):
            return abs(a2 * y * y + b2 * x * x - a2b2)

        cx, cy, ex, ey = a, b % 2, a % 2, b
        out = [(cx, cy)]
        while not (cx == ex and cy == ey):
            nx, ny = cx, cy + 2
            nd = delta(nx, ny)
            if nx > 1:
                d = delta(cx - 2, cy + 2)
                if nd > d:
                    nx, ny, nd = cx - 2, cy + 2, d
                d = delta(cx - 2, cy)
                if nd > d:
                    nx, ny = cx - 2, cy
            cx, cy = nx, ny
            out.append((cx, cy))
        return out

    @classmethod
    def _ellipse_spans(cls, a: int, b: int, w: int):
        """``ellipse_next``'s (x0, y, x1) spans of the stripe of width ``w``
        in doubled coordinates centred on 0, in Pillow's order."""
        outer = cls._quarter(a, b)
        if w < 1 or not outer:
            return []
        inner = cls._quarter(a - 2 * (w - 1), b - 2 * (w - 1)) or []
        leftmost = a % 2
        oi = ii = 0
        pr, py = outer[0]
        oi = 1
        pl = leftmost
        spans = []
        finished = False
        while not finished:
            y, l, r = py, pl, pr
            cx = cy = 0
            done_o = True
            while oi < len(outer):
                cx, cy = outer[oi]
                oi += 1
                if not cy <= y:
                    done_o = False
                    break
            if done_o:
                finished = True
            else:
                pr, py = cx, cy
            done_i = True
            while ii < len(inner):
                cx, cy = inner[ii]
                ii += 1
                if not cy <= y:
                    done_i = False
                    break
                l = cx
            pl = leftmost if done_i else cx
            buf = []
            if (l > 0 or l < r) and y > 0:
                buf.append((2 if l == 0 else l, y, r))
            if y > 0:
                buf.append((-r, y, -l))
            if l > 0 or l < r:
                buf.append((2 if l == 0 else l, -y, r))
            buf.append((-r, -y, -l))
            spans.extend(reversed(buf))
        return spans

    def ellipse(self, xy, fill=None, outline=None, width: int = 1) -> None:
        (x0, y0), (x1, y1) = _points(xy)
        if x1 < x0 or y1 < y0:
            raise ValueError("x1 must be >= x0 and y1 >= y0")
        a, b = x1 - x0, y1 - y0
        if fill is not None:
            self._spans(self._ellipse_spans(a, b, a + b), x0, y0, a, b, fill)
        if outline is not None and outline != fill and width != 0:
            self._spans(self._ellipse_spans(a, b, width), x0, y0, a, b,
                        outline)

    def _spans(self, spans, x0, y0, a, b, ink) -> None:
        for X0, Y, X1 in spans:
            self._hline(x0 + (X0 + a) // 2, y0 + (Y + b) // 2,
                        x0 + (X1 + a) // 2, ink)

    def arc(self, xy, start: float, end: float, fill=None,
            width: int = 1) -> None:
        """The ellipse stripe clipped to the angles [start, end] (degrees,
        clockwise from +x on the y-down image) as ``arc_init`` clips it.
        Only angles on multiples of 90 degrees are held to Pillow (the
        pseudo-glyph font's half ellipses): others raise."""
        if fill is None:
            return
        if start % 90 or end % 90:
            raise NotImplementedError("arcs end on multiples of 90 degrees")
        (x0, y0), (x1, y1) = _points(xy)
        if x1 < x0 or y1 < y0:
            raise ValueError("x1 must be >= x0 and y1 >= y0")
        a, b = x1 - x0, y1 - y0
        tree = _arc_tree(a, b, float(_f32(start)), float(_f32(end)))
        for X0, Y, X1 in self._ellipse_spans(a, b, width):
            for c0, c1 in _clip(tree, X0, Y, X1):
                self._hline(x0 + (c0 + a) // 2, y0 + (Y + b) // 2,
                            x0 + (c1 + a) // 2, fill)

    # ------------------------------------------------------------- others
    def line(self, xy, fill=None, width: int = 0) -> None:
        if fill is None:
            return
        pts = _points(xy)
        if width <= 1:
            for (ax, ay), (bx, by) in zip(pts, pts[1:]):
                self._line1(ax, ay, bx, by, fill)
            if len(pts) > 1:
                self._point(*pts[-1], fill)
        else:
            for (ax, ay), (bx, by) in zip(pts, pts[1:]):
                self._wide_line(ax, ay, bx, by, fill, width)

    def polygon(self, xy, fill=None, outline=None, width: int = 1) -> None:
        """The outline of width 1 (filled polygons, whose edge list Pillow
        builds otherwise, are not needed and raise)."""
        pts = _points(xy)
        if fill is not None:
            raise NotImplementedError("filled polygons")
        if outline is not None and width != 0:
            if width != 1:
                raise NotImplementedError("polygon outlines wider than 1")
            for (ax, ay), (bx, by) in zip(pts, pts[1:] + pts[:1]):
                self._line1(ax, ay, bx, by, outline)

    def rectangle(self, xy, fill=None, outline=None, width: int = 1) -> None:
        if outline is not None and outline != fill:
            raise NotImplementedError("rectangle outlines")
        if fill is None:
            return
        (x0, y0), (x1, y1) = _points(xy)
        if x1 < x0 or y1 < y0:
            raise ValueError("x1 must be >= x0 and y1 >= y0")
        for y in range(max(y0, 0), min(y1, self.h - 1) + 1):
            self._hline(x0, y, x1, fill)

    def draw_bitmap(self, xy, mask: np.ndarray, ink: int) -> None:
        """Blend ``ink`` into the image through the u8 ``mask`` placed at
        ``xy`` (truncated toward zero), as ``ImageDraw.text`` does."""
        x, y = int(xy[0]), int(xy[1])
        mh, mw = mask.shape
        sx, sy = max(0, -x), max(0, -y)
        dx, dy = max(0, x), max(0, y)
        w = min(mw - sx, self.w - dx)
        h = min(mh - sy, self.h - dy)
        if w <= 0 or h <= 0:
            return
        m = mask[sy:sy + h, sx:sx + w].astype(np.uint32)
        out = self.im[dy:dy + h, dx:dx + w]
        t = out.astype(np.uint32) * (255 - m) + np.uint32(ink) * m + 128
        out[...] = (((t >> 8) + t) >> 8).astype(np.uint8)

    def text(self, xy, text: str, fill: int, font) -> None:
        """``ImageDraw.text`` with a font that renders its own u8 mask
        (``font.render``), one line, no anchor."""
        self.draw_bitmap(xy, font.render(text), fill)


# ---------------------------------------------------------------- arc clip
def _normalize_angles(al: float, ar: float) -> Tuple[float, float]:
    """``normalize_angles`` in float32: 0 <= al < 360, al <= ar <= al + 360."""
    al, ar = _f32(al), _f32(ar)
    if ar - al >= 360:
        return 0.0, 360.0
    al = _f32(math.fmod(_f32(360) - _f32(math.fmod(-al, 360)) if al < 0
                        else al, 360))
    span = (_f32(360) - _f32(math.fmod(al - ar, 360)) if ar < al
            else ar - al)
    ar = al + _f32(math.fmod(span, 360))
    return float(al), float(ar)


def _arc_tree(a: int, b: int, al: float, ar: float):
    """``arc_init``'s clip tree: None (the whole ellipse), "empty" (a span
    of 0) or ("and"|"or", lc, rc) of half-planes (A, B, C) keeping
    A x + B y + C >= 0."""
    transpose = a < b
    if transpose:
        a, b, al, ar = b, a, 90 - ar, 90 - al
    al, ar = _normalize_angles(al, ar)
    if ar == al + 360:
        return None
    if ar == al:
        return "empty"
    lc = [-a * math.sin(al * math.pi / 180.0),
          b * math.cos(al * math.pi / 180.0),
          (a * a - b * b) * math.sin(al * math.pi / 90.0) / 2.0]
    rc = [a * math.sin(ar * math.pi / 180.0),
          -b * math.cos(ar * math.pi / 180.0),
          (b * b - a * a) * math.sin(ar * math.pi / 90.0) / 2.0]
    if transpose:
        lc[0], lc[1] = lc[1], lc[0]
        rc[0], rc[1] = rc[1], rc[0]
    return ("and" if ar - al <= 180 else "or", tuple(lc), tuple(rc))


def _clip_half(node, x0: int, y: int, x1: int):
    eps = 1e-9
    A, B, C = node
    if abs(A) < eps:
        if B * y + C < -eps:
            return []
    else:
        ix = -(B * y + C) / A
        if A * x0 + B * y + C < eps:
            x0 = _lround(max(x0, ix))
        if A * x1 + B * y + C < eps:
            x1 = _lround(min(x1, ix))
    return [(x0, x1)] if x0 <= x1 else []


def _lround(v: float) -> int:
    """C's ``lround``: half away from zero."""
    return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))


def _clip(tree, x0: int, y: int, x1: int):
    """The spans of [x0, x1] on row ``y`` that the tree keeps."""
    if tree is None:
        return [(x0, x1)]
    if tree == "empty":
        return []
    kind, lc, rc = tree
    l1, l2 = _clip_half(lc, x0, y, x1), _clip_half(rc, x0, y, x1)
    ev1 = [(x, t) for s in l1 for x, t in ((s[0], 1), (s[1], -1))]
    ev2 = [(x, t) for s in l2 for x, t in ((s[0], 1), (s[1], -1))]
    out: List[Tuple[int, int]] = []
    tail = None
    k1 = k2 = 0
    i = j = 0
    while i < len(ev1) or j < len(ev2):
        if j >= len(ev2) or (i < len(ev1) and (
                ev1[i][0] < ev2[j][0]
                or (ev1[i][0] == ev2[j][0] and ev1[i][1] > ev2[j][1]))):
            t = ev1[i]
            k1 += t[1]
            i += 1
        else:
            t = ev2[j]
            k2 += t[1]
            j += 1
        if kind == "or":
            keep = ((t[1] == 1 and (tail is None or tail[1] == -1))
                    or (t[1] == -1 and k1 == 0 and k2 == 0))
        else:
            keep = ((t[1] == 1 and (tail is None or tail[1] == -1)
                     and k1 > 0 and k2 > 0)
                    or (t[1] == -1 and tail is not None and tail[1] == 1
                        and (k1 == 0 or k2 == 0)))
        if keep:
            out.append(t)
            tail = t
    return [(out[k][0], out[k + 1][0]) for k in range(0, len(out) - 1, 2)]
