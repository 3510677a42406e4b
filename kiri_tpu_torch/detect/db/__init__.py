"""DB text detector: the net on the card, geometry on the host (the port of
``kiri_tpu/detect/db/__init__.py``).

    page (BGR or gray u8) -> gray, invert if dark -> resized to a /32 canvas
    in a size bucket (white pad) -> ``DBNet`` in float32 (TF32 off) ->
    probability map quantized to u16 (round(prob * 65535)), optionally
    mean-pooled by ``det_map_downsample`` -> host: threshold, connected
    components, min-area quads, box score, unclip, smart padding, reading
    order.

The u16 quantization is kept from the JAX package (where it halved the
download): the boxes are computed from the quantized map.

A ``.onnx`` model (the reference's default detector is the PP-OCR DB graph)
runs through the port's graph interpreter (``utils/onnx_import.py``) in
place of ``DBNet``, as in the JAX package: the gray canvas scaled to
[0, 1], replicated to three channels and normalized with ImageNet's mean
and std, the graph's first output taken as the probability map; everything
after the map is shared.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ... import native
from ...checkpoints import read_safetensors, write_safetensors
from ...device import no_tf32, resolve_device
from ...ops.imgproc import resize_f32_linear, resize_u8
from ...ops.preprocess import invert_if_dark, to_gray
from ...utils.imageio import imread_bgr
from .net import DBNet, build_db_net, flat_from_state_dict

#: ImageNet normalization of the PP-OCR graphs' RGB input.
_ONNX_MEAN = (0.485, 0.456, 0.406)
_ONNX_STD = (0.229, 0.224, 0.225)

#: Canvas size buckets (multiples of 32).
_SIZE_BUCKETS = (320, 448, 576, 704, 832, 960)


def _bucket(v: int) -> int:
    for b in _SIZE_BUCKETS:
        if b >= v:
            return b
    return _SIZE_BUCKETS[-1]


def load_db_checkpoint(path) -> Dict[str, np.ndarray]:
    """The JAX package's DB checkpoint as flat float32 numpy arrays
    (``params.<layer>.<leaf>``; any dtype the reader takes is cast)."""
    return {k: v.astype(np.float32)
            for k, v in read_safetensors(path).items()}


def save_db_checkpoint(path, net: DBNet) -> None:
    """Write ``net`` as the JAX package's DB checkpoint (flat
    ``params.<layer>.<leaf>``, HWIO kernels), which both packages load."""
    write_safetensors(path, flat_from_state_dict(net.state_dict()))


class DBDetector:
    """DB text detector with the JAX package's constructor surface, plus
    ``device`` (None means the card; ``"cpu"`` runs the net on the CPU)."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        use_gpu: bool = False,  # accepted for API compatibility
        det_db_thresh: float = 0.3,
        det_db_box_thresh: float = 0.5,
        det_db_unclip_ratio: float = 1.6,
        max_side_len: int = 960,
        min_size: int = 3,
        binary_threshold: Optional[float] = None,
        polygon_threshold: Optional[float] = None,
        unclip_ratio: Optional[float] = None,
        input_size: Optional[Tuple[int, int]] = None,
        max_candidates: int = 1000,
        padding_pct: float = 0.01,
        padding_px: int = 5,
        padding_y_pct: float = 0.05,
        padding_y_px: int = 5,
        line_tolerance_ratio: float = 0.7,
        debug: bool = False,
        variables: Optional[Dict[str, np.ndarray]] = None,
        det_map_downsample: int = 1,
        device=None,
    ):
        # Legacy aliases.
        self.det_db_thresh = (binary_threshold if binary_threshold is not None
                              else det_db_thresh)
        self.det_db_box_thresh = (polygon_threshold
                                  if polygon_threshold is not None
                                  else det_db_box_thresh)
        self.det_db_unclip_ratio = (unclip_ratio if unclip_ratio is not None
                                    else det_db_unclip_ratio)
        self.max_side_len = max_side_len
        self.min_size = min_size
        self.max_candidates = max_candidates
        self.padding_pct = padding_pct
        self.padding_px = padding_px
        self.padding_y_pct = padding_y_pct
        self.padding_y_px = padding_y_px
        self.line_tolerance_ratio = line_tolerance_ratio
        self.debug = debug
        self.model_path = model_path
        #: The map comes back at 1/ds resolution (mean pool on the device)
        #: and is resized back linearly on the host.
        self.det_map_downsample = int(det_map_downsample)
        if self.det_map_downsample < 1 or 32 % self.det_map_downsample:
            raise ValueError(f"det_map_downsample must be a divisor of 32, "
                             f"got {det_map_downsample}")
        self.device = resolve_device(device)
        #: The imported graph of a ``.onnx`` model (else None, and ``net``
        #: is the native DB net).
        self.onnx = None
        self.net: Optional[DBNet] = None
        if variables is None and model_path and str(model_path).endswith(
                ".onnx"):
            if not Path(model_path).exists():
                raise FileNotFoundError(f"DB model not found at {model_path}")
            from ...utils.onnx_import import import_onnx

            self.onnx = import_onnx(model_path).to(self.device)
            return
        if variables is None:
            if not (model_path and Path(model_path).exists()):
                raise FileNotFoundError(f"DB model not found at {model_path}")
            variables = load_db_checkpoint(model_path)
        self.net = build_db_net(variables).to(self.device)

    # ------------------------------------------------------------ preprocess
    def _resize_image(self, img: np.ndarray):
        """Resize to a /32 canvas in its size bucket, padded bottom and
        right with white."""
        h, w = img.shape[:2]
        ratio = 1.0
        if max(h, w) > self.max_side_len:
            ratio = self.max_side_len / max(h, w)
        new_h = max(32, int(round(h * ratio / 32) * 32))
        new_w = max(32, int(round(w * ratio / 32) * 32))
        resized = resize_u8(img, new_w, new_h, "linear")
        canvas = np.full((_bucket(new_h), _bucket(new_w)), 255, np.uint8)
        canvas[:new_h, :new_w] = resized
        return canvas, (new_h, new_w), (h, w)

    @staticmethod
    def _to_gray(img: np.ndarray) -> np.ndarray:
        return to_gray(img)

    def _to_prob(self, wire: np.ndarray, net_h: int, net_w: int
                 ) -> np.ndarray:
        """u16 map -> float32 prob cropped to the content (resized back to
        the canvas with det_map_downsample > 1)."""
        prob = wire.astype(np.float32) / 65535.0
        ds = self.det_map_downsample
        if ds > 1:
            prob = resize_f32_linear(prob, prob.shape[1] * ds,
                                     prob.shape[0] * ds)
        return prob[:net_h, :net_w]

    # -------------------------------------------------------------- inference
    @torch.inference_mode()
    def forward_wire(self, canvas_u8: np.ndarray) -> torch.Tensor:
        """u8 canvases [B, H, W] -> the u16 map values [B, H/ds, W/ds] on
        the device (int32: the values of round(prob * 65535))."""
        x = torch.from_numpy(np.ascontiguousarray(canvas_u8)).to(self.device)
        with no_tf32():
            if self.onnx is not None:
                x = x.to(torch.float32)[:, None] / 255.0
                mean, std = (torch.tensor(v, dtype=torch.float32,
                                          device=self.device)[None, :, None,
                                                              None]
                             for v in (_ONNX_MEAN, _ONNX_STD))
                out = self.onnx.apply(self.onnx.params, (x - mean) / std)
                if isinstance(out, tuple):
                    out = out[0]
                prob = out.reshape((x.shape[0],) + tuple(out.shape[-2:]))
            else:
                x = (x.to(torch.float32) / 255.0 - 0.5) / 0.5
                prob = self.net(x[:, None])
        ds = self.det_map_downsample
        if ds > 1:
            prob = F.avg_pool2d(prob[:, None], ds)[:, 0]
        return torch.round(prob * 65535.0).to(torch.int32)

    def predict_maps(self, img: np.ndarray) -> Tuple[np.ndarray, Tuple]:
        """Gray u8 page -> (prob map cropped to the content, scale info)."""
        canvas, (net_h, net_w), (orig_h, orig_w) = self._resize_image(img)
        wire = self.forward_wire(canvas[None]).cpu().numpy()[0]
        return (self._to_prob(wire.astype(np.uint16), net_h, net_w),
                (net_h, net_w, orig_h, orig_w))

    def _iter_maps_batch(self, imgs: List[np.ndarray]):
        """Yield (page index, prob map, scale info) group by group: pages
        of one canvas shape run as batched forwards (``_batch``)."""
        from .._batch import iter_grouped_batches

        canvases, infos = [], []
        for img in imgs:
            canvas, (net_h, net_w), (orig_h, orig_w) = self._resize_image(img)
            canvases.append(canvas)
            infos.append((net_h, net_w, orig_h, orig_w))
        for chunk, arr in iter_grouped_batches(canvases, self.forward_wire):
            for r, i in enumerate(chunk):
                net_h, net_w, _, _ = infos[i]
                yield i, self._to_prob(arr[r].astype(np.uint16), net_h,
                                       net_w), infos[i]

    def predict_maps_batch(self, imgs: List[np.ndarray]):
        """Gray u8 pages -> [(prob map, scale info), ...] in input order."""
        out: List = [None] * len(imgs)
        for i, prob, info in self._iter_maps_batch(imgs):
            out[i] = (prob, info)
        return out

    def iter_detect_text(self, images: List):
        """Yield (page index, ``detect_text`` result) in the order the
        batched forwards finish (canvas groups, not input order)."""
        grays = [invert_if_dark(self._to_gray(self._load_bgr(image)))
                 for image in images]
        for i, pred, (_, _, orig_h, orig_w) in self._iter_maps_batch(grays):
            boxes, scores = self._finish_page(pred, orig_w, orig_h)
            yield i, self._padded_sorted(boxes, scores)

    def detect_text_batch(self, images: List) -> List[List]:
        """``detect_text`` of many pages, in input order."""
        results: List = [None] * len(images)
        for i, res in self.iter_detect_text(images):
            results[i] = res
        return results

    # ------------------------------------------------------------- postproc
    def _get_mini_boxes(self, points: np.ndarray) -> Tuple[np.ndarray, float]:
        """Sorted min-area quad and its short side."""
        rect = native.min_area_rect(points)
        pts = sorted(native.box_points(rect).tolist(), key=lambda p: p[0])
        i1, i4 = (0, 1) if pts[1][1] > pts[0][1] else (1, 0)
        i2, i3 = (2, 3) if pts[3][1] > pts[2][1] else (3, 2)
        box = np.array([pts[i1], pts[i2], pts[i3], pts[i4]])
        return box, min(rect[1])

    def _unclip(self, box: np.ndarray) -> Optional[np.ndarray]:
        area, perim = native.polygon_area_perimeter(box)
        if area == 0 or perim == 0:
            return None
        distance = area * self.det_db_unclip_ratio / perim
        return native.offset_polygon(box.astype(float), distance)

    def _boxes_from_bitmap(self, pred: np.ndarray, bitmap: np.ndarray,
                           dest_w: int, dest_h: int):
        height, width = bitmap.shape
        n, labels, stats = native.connected_components(
            bitmap, max_components=self.max_candidates)
        boxes, scores = [], []
        for comp in range(1, n + 1):
            if stats[comp - 1, 4] < 4:
                continue
            pts = native.component_boundary(labels, comp)
            if len(pts) < 4:
                continue
            box, sside = self._get_mini_boxes(pts)
            if sside < self.min_size:
                continue
            score = native.box_score(pred, box)
            if score < self.det_db_box_thresh:
                continue
            expanded = self._unclip(box)
            if expanded is None:
                continue
            box, sside = self._get_mini_boxes(expanded)
            if sside < self.min_size + 2:
                continue
            box[:, 0] = np.clip(box[:, 0] / width * dest_w, 0, dest_w)
            box[:, 1] = np.clip(box[:, 1] / height * dest_h, 0, dest_h)
            boxes.append(box.astype(np.int32))
            scores.append(float(score))
        return boxes, scores

    def _finish_page(self, pred: np.ndarray, orig_w: int, orig_h: int):
        """prob map -> (raw boxes, scores), for one page and for batches."""
        bitmap = (pred > self.det_db_thresh).astype(np.uint8)
        if self.debug:
            print(f"  pred {pred.shape} max={pred.max():.3f} "
                  f"fg={int(bitmap.sum())}")
        return self._boxes_from_bitmap(pred, bitmap, orig_w, orig_h)

    def _padded_sorted(self, boxes, scores):
        """raw boxes -> smart-padded (box, score) list in reading order."""
        if not boxes:
            return []
        padded = self._apply_smart_padding(boxes)
        return self._sort_boxes_reading_order(list(zip(padded, scores)))

    def detect(self, img: np.ndarray, return_scores: bool = False):
        if img is None:
            return ([], []) if return_scores else []
        # Dark pages (light text on black) are inverted first.
        gray = invert_if_dark(self._to_gray(img))
        pred, (_, _, orig_h, orig_w) = self.predict_maps(gray)
        boxes, scores = self._finish_page(pred, orig_w, orig_h)
        return (boxes, scores) if return_scores else boxes

    # ---------------------------------------------------------- padding, sort
    @staticmethod
    def _bounding_rect(box: np.ndarray) -> Tuple[int, int, int, int]:
        x0, y0 = box[:, 0].min(), box[:, 1].min()
        x1, y1 = box[:, 0].max(), box[:, 1].max()
        return int(x0), int(y0), int(x1 - x0), int(y1 - y0)

    def _apply_smart_padding(self, boxes: List[np.ndarray]) -> List[np.ndarray]:
        """Grow each box, by at most half the gap to its nearest neighbour
        in its row and column bands."""
        if not boxes:
            return []
        n = len(boxes)
        aabbs = [self._bounding_rect(b) for b in boxes]
        max_pad_w = np.full(n, np.inf)
        max_pad_h = np.full(n, np.inf)
        for i in range(n):
            xi, yi, wi, hi = aabbs[i]
            for j in range(n):
                if i == j:
                    continue
                xj, yj, wj, hj = aabbs[j]
                if max(yi, yj) < min(yi + hi, yj + hj):  # y-band overlap
                    if xi >= xj + wj:
                        dist_x = xi - (xj + wj)
                    elif xj >= xi + wi:
                        dist_x = xj - (xi + wi)
                    else:
                        dist_x = 0
                    max_pad_w[i] = min(max_pad_w[i], dist_x)
                if max(xi, xj) < min(xi + wi, xj + wj):  # x-band overlap
                    if yi >= yj + hj:
                        dist_y = yi - (yj + hj)
                    elif yj >= yi + hi:
                        dist_y = yj - (yi + hi)
                    else:
                        dist_y = 0
                    max_pad_h[i] = min(max_pad_h[i], dist_y)
        out = []
        for i, box in enumerate(boxes):
            (cx, cy), (w, h), angle = native.min_area_rect(box.astype(float))
            if w < h:
                w, h = h, w
                angle += 90
            target_pad_w = (w * self.padding_pct) + (h * 0.5) + self.padding_px
            target_pad_h = (h * self.padding_y_pct) + self.padding_y_px
            pw = min(target_pad_w, max(0.0, max_pad_w[i] * 0.5))
            ph = min(target_pad_h, max(0.0, max_pad_h[i] * 0.5))
            new_box = native.box_points(((cx, cy), (w + pw, h + ph), angle))
            out.append(np.int32(np.round(new_box)))
        return out

    def _sort_boxes_reading_order(self, results):
        """Rows by median height (centres within 0.8 of it), then x."""
        if not results:
            return []
        data = []
        for box, conf in results:
            x, y, w, h = self._bounding_rect(box)
            data.append({"box": box, "conf": conf, "cy": y + h / 2,
                         "x": x, "h": h})
        data.sort(key=lambda b: b["cy"])
        median_h = float(np.median([b["h"] for b in data]))
        y_tol = median_h * 0.8
        lines, current = [], []
        for item in data:
            if not current:
                current.append(item)
                continue
            avg_y = np.mean([b["cy"] for b in current])
            if abs(item["cy"] - avg_y) < y_tol:
                current.append(item)
            else:
                lines.append(current)
                current = [item]
        if current:
            lines.append(current)
        out = []
        for line in lines:
            line.sort(key=lambda b: b["x"])
            out.extend((i["box"], i["conf"]) for i in line)
        return out

    # ----------------------------------------------------------- public API
    @staticmethod
    def _load_bgr(image: Union[str, Path, np.ndarray]) -> np.ndarray:
        """Path or array -> BGR or gray ndarray."""
        if isinstance(image, (str, Path)):
            img = imread_bgr(image)
            if img is None:
                raise ValueError(f"Image not found at {image}")
            return img
        if isinstance(image, np.ndarray):
            return image
        raise TypeError("Image must be a path or numpy array")

    def detect_text(self, image: Union[str, Path, np.ndarray]):
        """(box quad, confidence) list in reading order."""
        boxes, scores = self.detect(self._load_bgr(image), return_scores=True)
        return self._padded_sorted(boxes, scores)

    def __call__(self, img: np.ndarray):
        return self.detect(img)
