"""Plain reference of the DB page detector: the net in PyTorch float32 with
TF32 off, and DB's box scoring in NumPy / SciPy. No code of the program
under test.

Net (the checkpoint's JAX layout: HWIO kernels, ``params.<layer>.*``): a
3x3 stride-2 stem 1 -> 16, four residual stages (32, 64, 128, 256 channels,
two blocks each, the first at stride 2 with a 1x1 shortcut), GroupNorm with
8 groups after every normed conv, ReLU; an FPN (1x1 laterals to 64,
top-down nearest x2 sums, 3x3 smoothing), the four levels brought to
stride 4 and concatenated; the probability head conv3x3 256 -> 64, GN,
ReLU, 2x2 stride-2 transposed conv 64 -> 64 with bias, GN, ReLU, 2x2
stride-2 transposed conv 64 -> 1 with bias, sigmoid. Convolutions pad as
XLA's "SAME" (the low side gets the smaller half); ``jax.lax.conv_transpose``
does not flip its kernel, so the kernels are flipped for
``F.conv_transpose2d``.

Page -> map: grey, inverted when its mean is below 127, resized (OpenCV's
linear u8 resize, the frozen copy in ``traffic.imgproc``) so that its long
side is at most 960 and each side a multiple of 32, pasted top-left on a
white canvas of the size bucket (320, 448, ..., 960), normalised to
[-1, 1]; the map is kept as u16 counts (round(p * 65535)), as the
configuration states, and cropped to the resized page.

Scores (DB's post-processing, as PaddleOCR defines it): the map above
``det_db_thresh``, 8-connected components; a component of at least 4
pixels whose minimum-area rectangle (of its pixels' centres; corners in
float32, as ``cv2.boxPoints`` gives them) has a short side of at least
``min_size`` is scored by the mean of the map over the pixels whose
centres lie inside that rectangle (its bounding box clipped to the map,
edges inclusive); it is kept at a score of at least ``det_db_box_thresh``.
``reference/boxes.py`` draws the boxes from the kept ones.

``tf32=True`` is the control: the same net with TF32 on.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from traffic.imgproc import resize_u8

from .weights import read_safetensors

BUCKETS = (320, 448, 576, 704, 832, 960)
STAGES = ((32, 2, 2), (64, 2, 2), (128, 2, 2), (256, 2, 2))
MAX_SIDE = 960


def _bucket(v: int) -> int:
    return next((b for b in BUCKETS if b >= v), BUCKETS[-1])


def page_canvas(page: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Grey u8 page -> (u8 canvas, (resized h, resized w))."""
    gray = 255 - page if float(page.mean()) < 127.0 else page
    h, w = gray.shape
    ratio = MAX_SIDE / max(h, w) if max(h, w) > MAX_SIDE else 1.0
    nh = max(32, int(round(h * ratio / 32) * 32))
    nw = max(32, int(round(w * ratio / 32) * 32))
    canvas = np.full((_bucket(nh), _bucket(nw)), 255, np.uint8)
    canvas[:nh, :nw] = resize_u8(gray, nw, nh, "linear")
    return canvas, (nh, nw)


class RefDB:
    def __init__(self, ckpt_path, device, tf32: bool = False):
        self.dev = torch.device(device)
        self.tf32 = tf32
        self.p: Dict[str, torch.Tensor] = {}
        for key, v in read_safetensors(ckpt_path).items():
            layer, leaf = key.split(".", 2)[1:]
            v = v.astype(np.float32)
            if leaf == "w" and layer.endswith(("_d1", "_d2")):
                t = v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif leaf == "w":
                t = v.transpose(3, 2, 0, 1)
            else:
                t = v
            self.p[f"{layer}.{leaf}"] = torch.from_numpy(
                np.ascontiguousarray(t)).to(self.dev)

    def _conv(self, x, name, k, stride=1, norm=True):
        pads = []
        for n in (x.shape[-1], x.shape[-2]):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv2d(F.pad(x, pads), self.p[f"{name}.w"], stride=stride)
        if norm:
            y = F.group_norm(y, 8, self.p[f"{name}.gn.scale"],
                             self.p[f"{name}.gn.bias"], 1e-5)
        return y

    def _deconv(self, x, name, norm):
        y = F.conv_transpose2d(x, self.p[f"{name}.w"], self.p[f"{name}.b"],
                               stride=2)
        if norm:
            y = F.group_norm(y, 8, self.p[f"{name}.gn.scale"],
                             self.p[f"{name}.gn.bias"], 1e-5)
        return y

    @torch.no_grad()
    def prob(self, canvas: np.ndarray) -> torch.Tensor:
        """u8 canvas [H, W] -> probability map [H, W], float32."""
        mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
        before = (mm.allow_tf32, dnn.allow_tf32)
        mm.allow_tf32 = dnn.allow_tf32 = self.tf32
        try:
            x = torch.from_numpy(canvas).to(self.dev).float()
            x = ((x / 255.0 - 0.5) / 0.5)[None, None]
            x = F.relu(self._conv(x, "stem", 3, 2))
            feats, cin = [], 16
            for si, (c, blocks, stride) in enumerate(STAGES):
                for bi in range(blocks):
                    pre = f"s{si}b{bi}"
                    st = stride if bi == 0 else 1
                    y = self._conv(F.relu(self._conv(x, f"{pre}_c1", 3, st)),
                                   f"{pre}_c2", 3)
                    sc = (self._conv(x, f"{pre}_sc", 1, st) if cin != c
                          else x)
                    x = F.relu(y + sc)
                    cin = c
                feats.append(x)
            lats = [self._conv(f, f"lat{si}", 1, norm=False)
                    for si, f in enumerate(feats)]
            for si in range(len(lats) - 2, -1, -1):
                lats[si] = lats[si] + F.interpolate(lats[si + 1],
                                                    scale_factor=2)
            cat = [F.interpolate(self._conv(t, f"smooth{si}", 3, norm=False),
                                 scale_factor=2 ** si) if si else
                   self._conv(t, "smooth0", 3, norm=False)
                   for si, t in enumerate(lats)]
            h = F.relu(self._conv(torch.cat(cat, 1), "prob_c1", 3))
            h = F.relu(self._deconv(h, "prob_d1", True))
            return torch.sigmoid(self._deconv(h, "prob_d2", False))[0, 0]
        finally:
            mm.allow_tf32, dnn.allow_tf32 = before

    def u16_map(self, page: np.ndarray) -> np.ndarray:
        """A grey u8 page -> its map as DB keeps it: u16 counts, read back
        as float32, cropped to the resized page."""
        canvas, (nh, nw) = page_canvas(page)
        prob = self.prob(canvas)[:nh, :nw]
        return (torch.round(prob * 65535.0) / 65535.0).float().cpu().numpy()


def _hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull (monotone chain) of integer pixel coordinates; only each
    row's leftmost and rightmost pixel can be a vertex."""
    order = np.lexsort((pts[:, 0], pts[:, 1]))
    ys, xs = pts[order, 1], pts[order, 0]
    first = np.r_[True, ys[1:] != ys[:-1]]
    last = np.r_[ys[1:] != ys[:-1], True]
    ext = np.concatenate([np.stack([xs[first], ys[first]], 1),
                          np.stack([xs[last], ys[last]], 1)])
    ext = sorted(set(map(tuple, ext.tolist())))
    if len(ext) < 3:
        return np.array(ext, np.float64)

    def half(seq):
        out: List = []
        for p in seq:
            while len(out) >= 2 and (
                    (out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                    - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out[:-1]
    return np.array(half(ext) + half(ext[::-1]), np.float64)


def min_area_rect(pts: np.ndarray) -> Dict:
    """The minimum-area rectangle around ``pts``: its centre, its axes u
    (along the hull edge it lies on) and v, and its extents along them."""
    hull = _hull(pts)
    if len(hull) < 3:
        p = hull[0] if len(hull) else np.zeros(2)
        return {"c": p.astype(np.float64), "u": np.array([1.0, 0.0]),
                "v": np.array([0.0, 1.0]), "ext": (0.0, 0.0)}
    best = None
    for i in range(len(hull)):
        e = hull[(i + 1) % len(hull)] - hull[i]
        n = math.hypot(*e)
        if n < 1e-12:
            continue
        u = e / n
        v = np.array([-u[1], u[0]])
        pu, pv = hull @ u, hull @ v
        area = (pu.max() - pu.min()) * (pv.max() - pv.min())
        if best is None or area < best[0]:
            best = (area, u, v, pu.min(), pu.max(), pv.min(), pv.max())
    _, u, v, u0, u1, v0, v1 = best
    return {"c": (u0 + u1) / 2 * u + (v0 + v1) / 2 * v, "u": u, "v": v,
            "ext": (u1 - u0, v1 - v0)}


def corners(rect: Dict, ext=None) -> np.ndarray:
    """The rectangle's 4 corners (with extents ``ext``, else its own), in
    float32 as ``cv2.boxPoints`` gives them."""
    eu, ev = rect["ext"] if ext is None else ext
    c, u, v = rect["c"], rect["u"] * eu / 2, rect["v"] * ev / 2
    quad = np.array([c - u - v, c + u - v, c + u + v, c - u + v])
    return quad.astype(np.float32).astype(np.float64)


def quad_mean(pred: np.ndarray, quad: np.ndarray) -> float:
    h, w = pred.shape
    x0 = int(np.clip(math.floor(quad[:, 0].min()), 0, w - 1))
    x1 = int(np.clip(math.ceil(quad[:, 0].max()), 0, w - 1))
    y0 = int(np.clip(math.floor(quad[:, 1].min()), 0, h - 1))
    y1 = int(np.clip(math.ceil(quad[:, 1].max()), 0, h - 1))
    if x1 <= x0 or y1 <= y0:
        return 0.0
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    area2 = sum(quad[i, 0] * quad[(i + 1) % 4, 1]
                - quad[(i + 1) % 4, 0] * quad[i, 1] for i in range(4))
    sign = 1.0 if area2 >= 0 else -1.0
    inside = np.ones(xs.shape, bool)
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        c = (b[0] - a[0]) * (ys - a[1]) - (b[1] - a[1]) * (xs - a[0])
        inside &= sign * c >= 0
    return float(pred[y0:y1 + 1, x0:x1 + 1][inside].astype(np.float64).mean()
                 ) if inside.any() else 0.0


def components(pred: np.ndarray, det: Dict) -> List[Dict]:
    """DB's scored components of a map (cropped to the resized page), in
    raster order of their first pixel, each with its score, whether DB
    keeps it, its minimum-area rectangle and its quad (map pixels);
    ``det`` is the configuration's detector."""
    labels, n = ndimage.label(pred > det["det_db_thresh"],
                              structure=np.ones((3, 3)))
    out = []
    for lab, sl in enumerate(ndimage.find_objects(labels), start=1):
        mask = labels[sl] == lab
        if mask.sum() < 4:
            continue
        ys, xs = np.nonzero(mask)
        pts = np.stack([xs + sl[1].start, ys + sl[0].start], 1)
        rect = min_area_rect(pts)
        if min(rect["ext"]) < det["min_size"]:
            continue
        quad = corners(rect)
        score = quad_mean(pred, quad)
        out.append({"score": score, "kept": score >= det["det_db_box_thresh"],
                    "rect": rect, "quad": quad})
    return out
