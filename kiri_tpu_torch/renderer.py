"""Result rendering: box overlays, a text overlay and an HTML report (the
port of ``kiri_tpu/renderer.py``).

``create_report`` needs nothing beyond the port: the page is embedded as a
PNG from ``utils/imageio.py``. ``draw_boxes`` and ``draw_results`` draw
glyphs, which takes Pillow's font rasteriser; Pillow is imported when one of
them is called (the machine with the card has none), and where it is
missing the call raises and says to run without rendering (``predict
--no-render``). Their images are the JAX package's pixel for pixel: Khmer
text goes through a Khmer TTF where one is installed, else through the
procedural pseudo-glyphs of the generators, as there.
"""
from __future__ import annotations

import base64
import html
import importlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .utils.imageio import encode_png, imread_bgr

_KHMER = (0x1780, 0x17FF)


def _conf_color(conf: float):
    if conf > 0.9:
        return (0, 200, 0)
    if conf > 0.7:
        return (255, 165, 0)
    return (220, 0, 0)


def _pillow():
    """(PIL.Image, PIL.ImageDraw, PIL.ImageFont), or a clear error."""
    try:
        return tuple(importlib.import_module(f"PIL.{m}")
                     for m in ("Image", "ImageDraw", "ImageFont"))
    except ImportError:
        raise RuntimeError(
            "drawing the result images needs Pillow's font rasteriser, and "
            "Pillow cannot be imported here; run predict with --no-render "
            "(the OCR results and the report need no Pillow)") from None


class DocumentRenderer:
    """Render OCR results onto document images (paths or u8 arrays, grey or
    BGR)."""

    def __init__(self, font_path: Optional[str] = None, font_size: int = 12):
        self.font_size = font_size
        self.font_path = font_path
        self._font = None
        self._khmer_font = None

    @property
    def font(self):
        if self._font is None:
            _, _, image_font = _pillow()
            candidates = [self.font_path] if self.font_path else []
            if Path("fonts").exists():
                candidates += [str(f) for f in Path("fonts").glob("*.ttf")]
            candidates += ["/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                           "DejaVuSans.ttf"]
            for cand in candidates:
                try:
                    self._font = image_font.truetype(cand, self.font_size)
                    break
                except Exception:
                    continue
            if self._font is None:
                self._font = image_font.load_default()
        return self._font

    def _font_for(self, text: str):
        """Khmer text goes through the first Khmer-capable font of the
        generators' ``FontManager``: a system TTF, else the procedural
        pseudo-glyph pool; other text through the own font."""
        if not any(_KHMER[0] <= ord(c) <= _KHMER[1] for c in text):
            return self.font
        if self._khmer_font is None:
            try:
                from .data.synth import FontManager

                fm = FontManager()
                path = fm.khmer_fonts[0] if fm.khmer_fonts else None
                self._khmer_font = (fm.get(path, max(12, self.font_size))
                                    if path else self.font)
            except Exception:
                self._khmer_font = self.font
        return self._khmer_font

    @staticmethod
    def _load_rgb_array(image) -> np.ndarray:
        if isinstance(image, (str, Path)):
            bgr = imread_bgr(image)
            if bgr is None:
                raise ValueError(f"Could not load image: {image}")
        else:
            bgr = np.asarray(image, np.uint8)
        if bgr.ndim == 2:
            return np.repeat(bgr[..., None], 3, axis=2)
        return np.ascontiguousarray(bgr[..., 2::-1])

    def _load_rgb(self, image):
        return _pillow()[0].fromarray(self._load_rgb_array(image))

    def draw_boxes(self, image_path, results: List[Dict],
                   output_path: str = "output_boxes.png") -> str:
        """Confidence-coloured bounding boxes with their confidence."""
        _, image_draw, _ = _pillow()
        img = self._load_rgb(image_path)
        draw = image_draw.Draw(img)
        for r in results:
            x, y, w, h = r["box"]
            color = _conf_color(r.get("confidence", 0.0))
            draw.rectangle([x, y, x + w, y + h], outline=color, width=2)
            label = f"{r.get('confidence', 0) * 100:.0f}%"
            draw.text((x, max(0, y - self.font_size - 2)), label,
                      fill=color, font=self.font)
        img.save(output_path)
        return str(output_path)

    def draw_results(self, image_path, results: List[Dict],
                     output_path: str = "output_ocr.png",
                     show_text: bool = True,
                     show_confidence: bool = True) -> str:
        """The page and, beside it, the recognized text in each box;
        ``show_text=False`` draws the boxes only, ``show_confidence`` adds
        each confidence to its text."""
        image, image_draw, _ = _pillow()
        img = self._load_rgb(image_path)
        width = img.width * 2 + 10 if show_text else img.width
        canvas = image.new("RGB", (width, img.height), (255, 255, 255))
        canvas.paste(img, (0, 0))
        draw = image_draw.Draw(canvas)
        xoff = img.width + 10
        for r in results:
            x, y, w, h = r["box"]
            color = _conf_color(r.get("confidence", 0.0))
            draw.rectangle([x, y, x + w, y + h], outline=color, width=2)
            if not show_text:
                continue
            text = r.get("text", "")[:50]
            if show_confidence:
                text += f" ({r.get('confidence', 0.0) * 100:.0f}%)"
            draw.rectangle([xoff + x, y, xoff + x + w, y + h],
                           outline=(200, 200, 200), width=1)
            draw.text((xoff + x + 2, y + max(0, (h - self.font_size) // 2)),
                      text, fill=(0, 0, 0), font=self._font_for(text))
        canvas.save(output_path)
        return str(output_path)

    def create_report(self, image_path, results: List[Dict],
                      output_path: str = "report.html") -> str:
        """A standalone HTML report: the page (an embedded PNG) and a table
        of the results."""
        rgb = self._load_rgb_array(image_path)
        b64 = base64.b64encode(encode_png(rgb[..., ::-1])).decode("ascii")
        rows = []
        for r in results:
            conf = r.get("confidence", 0.0)
            color = ("#0c0" if conf > 0.9
                     else "#fa0" if conf > 0.7 else "#d00")
            rows.append(
                f"<tr><td>{r.get('line_number', '')}</td>"
                f"<td>{html.escape(r.get('text', ''))}</td>"
                f"<td style='color:{color}'>{conf * 100:.1f}%</td>"
                f"<td>{r['box']}</td></tr>")
        avg = (float(np.mean([r.get("confidence", 0) for r in results]))
               if results else 0.0)
        source = (str(image_path) if isinstance(image_path, (str, Path))
                  else f"array {rgb.shape[1]}x{rgb.shape[0]}")
        doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Kiri-TPU OCR Report</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; width: 100%; }}
 td, th {{ border: 1px solid #ccc; padding: 4px 8px; }}
 img {{ max-width: 100%; border: 1px solid #999; }}
</style></head><body>
<h1>OCR Report</h1>
<p>Source: {html.escape(source)} —
 {len(results)} regions, average confidence {avg * 100:.1f}%</p>
<img src="data:image/png;base64,{b64}" alt="document"/>
<table><tr><th>#</th><th>Text</th><th>Confidence</th><th>Box</th></tr>
{''.join(rows)}
</table></body></html>"""
        Path(output_path).write_text(doc, encoding="utf-8")
        return str(output_path)
