"""Reading and writing page images.

PNG is read and written here with the standard library (``zlib``,
``struct``) on every machine: 8-bit grey, grey + alpha, RGB, RGBA and
palette images (palette and grey also at 1, 2 and 4 bits), not interlaced,
with all five row filters (undone in ``native/cvops.cpp``). ``imread_bgr``
gives what ``cv2.imread(path)`` gives: BGR bytes, grey repeated over the
three channels, alpha dropped, the palette expanded; ``imread_gray``
what Pillow's ``Image.open(path).convert("L")`` gives (training's
datasets read lines so). Other files (and
PNGs of another kind: 16-bit, interlaced) are read through cv2 or PIL
where one can be imported; the machine with the card has neither.
"""
from __future__ import annotations

import importlib
import struct
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..native.cvops import png_unfilter

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples a pixel by colour type: grey, RGB, palette, grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG this reader does not decode (16-bit, interlaced)."""


def read_png(data: bytes) -> np.ndarray:
    """Decode a PNG into u8 [H, W, C] samples as stored (C = 1 grey, 2
    grey + alpha, 3 RGB, 4 RGBA; a palette image comes back as RGB)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, plte, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    if interlace or depth == 16:
        raise UnsupportedPNG(f"PNG with bit depth {depth}, interlace "
                             f"{interlace}")
    if depth < 8 and ctype not in (0, 3):
        raise ValueError(f"bad PNG bit depth {depth} for colour type {ctype}")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    rows = png_unfilter(zlib.decompress(b"".join(idat)), h, stride,
                        max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        vals = bits.reshape(h, w, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (vals * weights).sum(-1).astype(np.uint8)
        if ctype == 0:  # scale grey to 8 bits
            samples = (samples.astype(np.int32) * (255 // ((1 << depth) - 1))
                       ).astype(np.uint8)
        samples = samples[..., None]
    else:
        samples = rows.reshape(h, w, ch)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        samples = plte[np.minimum(samples[..., 0], len(plte) - 1)]
    return np.ascontiguousarray(samples)


def png_to_bgr(samples: np.ndarray) -> np.ndarray:
    """``read_png`` samples as ``cv2.imread(path)`` gives them: u8
    [H, W, 3] BGR."""
    if samples.shape[2] <= 2:
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., 2::-1])


def encode_png(img: np.ndarray) -> bytes:
    """A PNG of u8 [H, W] grey, [H, W, 3] BGR or [H, W, 4] BGRA (written as
    RGB / RGBA, as ``cv2.imwrite`` does), no row filters."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        ctype, px = 0, img[..., None]
    elif img.shape[2] == 3:
        ctype, px = 2, img[..., ::-1]
    elif img.shape[2] == 4:
        ctype, px = 6, img[..., [2, 1, 0, 3]]
    else:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(px).reshape(h, -1)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def imwrite_png(path: Union[str, Path], img: np.ndarray) -> str:
    Path(path).write_bytes(encode_png(img))
    return str(path)


def _read_other(path: Union[str, Path]) -> Optional[np.ndarray]:
    try:
        cv2 = importlib.import_module("cv2")
        return cv2.imread(str(path))
    except ImportError:
        pass
    try:
        image = importlib.import_module("PIL.Image")
    except ImportError:
        raise RuntimeError(
            f"cannot read {path}: the port reads PNG files itself; any other "
            "file needs cv2 or PIL, and neither can be imported here; pass "
            "the page as a PNG or a u8 numpy array") from None
    try:
        with image.open(path) as im:
            rgb = np.asarray(im.convert("RGB"))
            return np.ascontiguousarray(rgb[..., ::-1])
    except (OSError, ValueError):
        return None


def imread_bgr(path: Union[str, Path]) -> Optional[np.ndarray]:
    """u8 BGR [H, W, 3] of an image file, None when it cannot be read (as
    ``cv2.imread``). PNG is decoded here; other files go through cv2 or
    PIL, and raise when neither can be imported."""
    try:
        with open(path, "rb") as f:
            head = f.read(8)
            data = head + f.read() if head == PNG_SIGNATURE else None
    except OSError:
        return None
    if data is None:
        return _read_other(path)
    try:
        return png_to_bgr(read_png(data))
    except UnsupportedPNG:
        return _read_other(path)
    except (ValueError, zlib.error, struct.error):
        return None


def imread_gray(path: Union[str, Path]) -> np.ndarray:
    """u8 [H, W] of an image file as Pillow's ``Image.open(path).convert(
    "L")`` gives it: grey kept, alpha dropped, colour (and palette) through
    Pillow's fixed-point luma. PNG is decoded here; other files need PIL.
    Raises when the file cannot be read."""
    with open(path, "rb") as f:
        return decode_gray(f.read(), str(path))


def decode_gray(data: bytes, name: str = "image") -> np.ndarray:
    """``imread_gray`` of a file's bytes (``name`` is what an error names):
    PNG decoded here, any other format through PIL where it imports."""
    from ..ops.imgproc import pil_gray

    if data[:8] == PNG_SIGNATURE:
        try:
            samples = read_png(data)
        except UnsupportedPNG:
            samples = None
        if samples is not None:
            return (np.ascontiguousarray(samples[..., 0])
                    if samples.shape[2] <= 2 else pil_gray(samples))
    try:
        image = importlib.import_module("PIL.Image")
    except ImportError:
        raise RuntimeError(f"cannot read {name}: the port reads 8-bit PNG "
                           "files itself; any other file needs PIL") from None
    import io

    with image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)
