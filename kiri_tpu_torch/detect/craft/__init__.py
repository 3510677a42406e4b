"""CRAFT text detector: the net on the card, geometry on the host (the port
of ``kiri_tpu/detect/craft/__init__.py``).

    page (BGR or gray u8) -> gray, invert if dark -> aspect resize by
    ``mag_ratio`` (at most ``canvas_size``), padded with black to a /32
    canvas -> ``CRAFTNet`` in float32 (TF32 off) -> sigmoid -> region and
    affinity maps at half resolution, rounded to float16 -> host:
    thresholds, connected components, dilation, min-area quads (optionally
    polygons), scaled back by 2 / ratio.

The float16 rounding is kept from the JAX package: the boxes are computed
from the rounded maps. One upload and one download a page, or a canvas
group when batched.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import native
from ...checkpoints import read_safetensors, write_safetensors
from ...device import no_tf32, resolve_device
from ...ops.imgproc import resize_u8
from ...ops.preprocess import invert_if_dark, to_gray
from ...utils.imageio import imread_bgr
from .net import CRAFTNet, build_craft_net, flat_from_state_dict


def resize_aspect_ratio(img: np.ndarray, square_size: int, mag_ratio: float
                        ) -> Tuple[np.ndarray, float]:
    """Magnify by ``mag_ratio`` (the longer side at most ``square_size``)
    with cv2's ``INTER_LINEAR``, then pad with zeros to multiples of 32.
    Returns (canvas, ratio)."""
    h, w = img.shape[:2]
    target = mag_ratio * max(h, w)
    if target > square_size:
        target = square_size
    ratio = target / max(h, w)
    nh, nw = int(h * ratio), int(w * ratio)
    proc = resize_u8(img, nw, nh, "linear")
    ch = nh + (32 - nh % 32) % 32
    cw = nw + (32 - nw % 32) % 32
    canvas = np.zeros((ch, cw), dtype=img.dtype)
    canvas[:nh, :nw] = proc
    return canvas, ratio


def get_det_boxes(textmap: np.ndarray, linkmap: np.ndarray,
                  text_threshold: float, link_threshold: float,
                  low_text: float, poly: bool = False):
    """Score maps -> min-area quads; with ``poly=True`` also one polygon
    outline per quad (None where the quad describes the text better)."""
    boxes, labels, mapper = _det_boxes_core(textmap, linkmap, text_threshold,
                                            link_threshold, low_text)
    if not poly:
        return boxes
    from .poly import get_poly_core

    return boxes, get_poly_core(boxes, labels, mapper)


def _det_boxes_core(textmap: np.ndarray, linkmap: np.ndarray,
                    text_threshold: float, link_threshold: float,
                    low_text: float):
    """(quads, label map, the component of each quad)."""
    text_score = (textmap >= low_text).astype(np.uint8)
    link_score = (linkmap >= link_threshold).astype(np.uint8)
    combined = np.clip(text_score + link_score, 0, 1).astype(np.uint8)

    n, labels, stats = native.connected_components(combined)
    boxes = []
    mapper = []
    for comp in range(1, n + 1):
        x, y, w, h, size = stats[comp - 1]
        if size < 10:
            continue
        if textmap[labels == comp].max() < text_threshold:
            continue
        # The component without its link-only pixels, dilated by a size-
        # dependent kernel, before the rect.
        seg = np.zeros_like(combined)
        mask = labels == comp
        seg[mask & ~(link_score.astype(bool) & ~text_score.astype(bool))] = 1
        niter = int(np.sqrt(size * min(w, h) / max(w * h, 1)) * 2)
        pad = niter
        x0, y0 = max(0, x - pad), max(0, y - pad)
        x1 = min(seg.shape[1], x + w + pad + 1)
        y1 = min(seg.shape[0], y + h + pad + 1)
        window = seg[y0:y1, x0:x1]
        if niter > 0:
            window = native.dilate(window, 1 + 2 * niter)
        ys, xs = np.nonzero(window)
        if len(xs) < 4:
            continue
        pts = np.stack([xs + x0, ys + y0], axis=1).astype(np.float64)
        rect = native.min_area_rect(pts)
        box = native.box_points(rect)
        # A near-square rect (a diamond) becomes the axis-aligned hull.
        bw = np.linalg.norm(box[0] - box[1])
        bh = np.linalg.norm(box[1] - box[2])
        ratio = max(bw, bh) / (min(bw, bh) + 1e-5)
        if abs(1 - ratio) <= 0.1:
            l, r = xs.min() + x0, xs.max() + x0
            t, b = ys.min() + y0, ys.max() + y0
            box = np.array([[l, t], [r, t], [r, b], [l, b]], dtype=np.float32)
        # Clockwise from the top-left corner.
        startidx = box.sum(axis=1).argmin()
        box = np.roll(box, 4 - startidx, 0)
        boxes.append(box)
        mapper.append(comp)
    return boxes, labels, mapper


def load_craft_checkpoint(path) -> Dict[str, np.ndarray]:
    """The JAX package's CRAFT checkpoint as flat numpy arrays
    (``params.<layer>.<leaf>``)."""
    return read_safetensors(path)


def save_craft_checkpoint(path, net: CRAFTNet) -> None:
    """Write ``net`` as the JAX package's CRAFT checkpoint (flat
    ``params.<layer>.<leaf>``, HWIO kernels), which both packages load."""
    write_safetensors(path, flat_from_state_dict(net.state_dict()))


class CRAFTDetector:
    """CRAFT detector with the JAX package's constructor surface
    (canvas_size 1280, mag_ratio 1.5, thresholds 0.7 / 0.4 / 0.4), plus
    ``device`` (None means the card). ``variables`` takes the flat
    parameters instead of a checkpoint path."""

    def __init__(self, model_path: Optional[str] = None,
                 text_threshold: float = 0.7, link_threshold: float = 0.4,
                 low_text: float = 0.4, canvas_size: int = 1280,
                 mag_ratio: float = 1.5,
                 variables: Optional[Dict[str, np.ndarray]] = None,
                 device=None):
        self.text_threshold = text_threshold
        self.link_threshold = link_threshold
        self.low_text = low_text
        self.canvas_size = canvas_size
        self.mag_ratio = mag_ratio
        self.model_path = model_path
        self.device = resolve_device(device)
        if variables is None:
            if not (model_path and Path(model_path).exists()):
                raise FileNotFoundError(
                    f"CRAFT model not found at {model_path}")
            variables = load_craft_checkpoint(model_path)
        self.net: CRAFTNet = build_craft_net(variables).to(self.device)

    @staticmethod
    def _load_gray(image) -> np.ndarray:
        """Path or array -> gray u8 (cv2's ``COLOR_BGR2GRAY`` for colour)."""
        if isinstance(image, (str, Path)):
            img = imread_bgr(image)
            if img is None:
                raise ValueError(f"Image not found: {image}")
            return to_gray(img)
        return to_gray(np.asarray(image))

    @torch.inference_mode()
    def forward_maps(self, canvas_u8: np.ndarray) -> torch.Tensor:
        """u8 canvases [B, H, W] -> float16 [B, 2, H/2, W/2] (region,
        affinity) on the device."""
        x = torch.from_numpy(np.ascontiguousarray(canvas_u8)).to(self.device)
        x = (x.to(torch.float32) / 255.0 - 0.5) / 0.5
        with no_tf32():
            region, affinity = self.net(x[:, None])
        return torch.sigmoid(torch.stack([region, affinity], 1)).to(
            torch.float16)

    def predict_maps(self, gray: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Gray u8 page -> (region, affinity as float32 of the float16
        maps, ratio)."""
        canvas, ratio = resize_aspect_ratio(invert_if_dark(gray),
                                            self.canvas_size, self.mag_ratio)
        maps = self.forward_maps(canvas[None]).cpu().numpy()[0]
        return maps[0].astype(np.float32), maps[1].astype(np.float32), ratio

    def detect_text(self, image, poly: bool = False
                    ) -> List[Tuple[np.ndarray, float]]:
        """(points, confidence) list in image coordinates: points is a
        [4, 2] quad, or with ``poly=True`` a polygon where one was found."""
        gray = self._load_gray(image)
        region, affinity, ratio = self.predict_maps(gray)
        return self._postprocess(gray, region, affinity, ratio, poly)

    def _postprocess(self, gray, region, affinity, ratio, poly):
        if poly:
            boxes, polys = get_det_boxes(region, affinity,
                                         self.text_threshold,
                                         self.link_threshold, self.low_text,
                                         poly=True)
            shapes = [p if p is not None else b
                      for b, p in zip(boxes, polys)]
        else:
            shapes = get_det_boxes(region, affinity, self.text_threshold,
                                   self.link_threshold, self.low_text)
            boxes = shapes
        results = []
        for quad, pts in zip(boxes, shapes):
            # The maps are at half the canvas resolution.
            scaled = pts * (2.0 / ratio)
            xs = np.clip(scaled[:, 0], 0, gray.shape[1])
            ys = np.clip(scaled[:, 1], 0, gray.shape[0])
            ix0 = max(0, int(quad[:, 0].min()))
            iy0 = max(0, int(quad[:, 1].min()))
            ix1 = min(region.shape[1], int(quad[:, 0].max()) + 1)
            iy1 = min(region.shape[0], int(quad[:, 1].max()) + 1)
            conf = (float(region[iy0:iy1, ix0:ix1].max())
                    if (ix1 > ix0 and iy1 > iy0) else 1.0)
            results.append((np.stack([xs, ys], axis=1).astype(np.float32),
                            conf))
        return results

    def _iter_maps_batch(self, grays: List[np.ndarray]):
        """Yield (page index, region, affinity, ratio) group by group:
        pages of one canvas shape run as batched forwards (``_batch``)."""
        from .._batch import iter_grouped_batches

        canvases, ratios = [], []
        for gray in grays:
            canvas, ratio = resize_aspect_ratio(invert_if_dark(gray),
                                                self.canvas_size,
                                                self.mag_ratio)
            canvases.append(canvas)
            ratios.append(ratio)
        for chunk, maps in iter_grouped_batches(canvases, self.forward_maps):
            for r, i in enumerate(chunk):
                yield (i, maps[r, 0].astype(np.float32),
                       maps[r, 1].astype(np.float32), ratios[i])

    def predict_maps_batch(self, grays: List[np.ndarray]):
        """Gray u8 pages -> [(region, affinity, ratio), ...] in input
        order."""
        out: List = [None] * len(grays)
        for i, region, affinity, ratio in self._iter_maps_batch(grays):
            out[i] = (region, affinity, ratio)
        return out

    def iter_detect_text(self, images: List, poly: bool = False):
        """Yield (page index, ``detect_text`` result) in the order the
        batched forwards finish (canvas groups, not input order)."""
        grays = [self._load_gray(image) for image in images]
        for i, region, affinity, ratio in self._iter_maps_batch(grays):
            yield i, self._postprocess(grays[i], region, affinity, ratio,
                                       poly)

    def detect_text_batch(self, images: List, poly: bool = False
                          ) -> List[List[Tuple[np.ndarray, float]]]:
        """``detect_text`` of many pages, in input order."""
        results: List = [None] * len(images)
        for i, res in self.iter_detect_text(images, poly=poly):
            results[i] = res
        return results
