"""RecognizerEngine: batched line recognition on the card (the port of
``kiri_tpu/engine.py``, CTC fast path).

    u8 lines [N, 48, 640] --width buckets, batch buckets--> encode + CTC head
        + greedy CTC stats (on the device) --one fetch--> texts (host)

``recognize_crops`` preprocesses raw variable-size crops on the device
(``kernels.resize.preprocess_lines``) and then recognizes them the same way.
The decoder paths ("decoder", "beam", "auto"), ``enhance=True`` and 4-bit
uploads come with later slices of the port and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoints import find_vocab_file, load_checkpoint
from .config import CFG
from .device import resolve_device
from .kernels.resize import pack_crops, preprocess_lines
from .models.recognizer import Recognizer
from .ops.ctc import greedy_ctc_stats
from .ops.preprocess import pick_batch_bucket, pick_width_bucket
from .tokenizer import CharTokenizer

Result = Tuple[str, float]
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_method(method: str) -> None:
    if method != "ctc":
        raise NotImplementedError(
            f"method {method!r}: the decoder paths (accurate, beam, auto) "
            "come with a later slice of the port; only 'ctc' runs now")


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy 32-bit tensors to the host in one transfer."""
    flat = torch.cat([t.reshape(-1).view(torch.int32) for t in tensors])
    flat = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        np_dtype = np.float32 if t.dtype == torch.float32 else np.int32
        out.append(flat[o: o + n].view(np_dtype).reshape(tuple(t.shape)))
        o += n
    return out


class RecognizerEngine:
    def __init__(self, model: Recognizer, cfg: CFG, tok: CharTokenizer,
                 device=None, upload_bits: int = 8):
        """``device=None`` means the card; pass ``device="cpu"`` to run on
        the CPU (the kernels' plain versions). ``cfg.COMPUTE_DTYPE`` picks
        the compute dtype."""
        if upload_bits == 4:
            raise NotImplementedError("upload_bits=4 comes with a later "
                                      "slice of the port")
        if upload_bits != 8:
            raise ValueError(f"upload_bits must be 4 or 8, got {upload_bits}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.tok = tok
        self.dtype = _DTYPES[cfg.COMPUTE_DTYPE]

    @classmethod
    def from_checkpoint(cls, path: str, device=None) -> "RecognizerEngine":
        """Engine over a checkpoint, its meta's config and the vocab beside
        it."""
        model, cfg, meta = load_checkpoint(path, device)
        vocab = find_vocab_file(meta.get("vocab_path", ""), path)
        if vocab is None:
            raise FileNotFoundError(f"no vocab file found near {path}")
        return cls(model, cfg, CharTokenizer(vocab, cfg), device)

    # ------------------------------------------------------------ internals
    @torch.inference_mode()
    def _encode(self, images: torch.Tensor):
        mem = self.model.encode(images, self.dtype)
        ctc = self.model.ctc_logits(mem)
        ids, conf, est = greedy_ctc_stats(ctc, self.tok.ctc_offset)
        return mem, ctc, ids, conf, est

    def _encode_u8(self, imgs_u8: np.ndarray):
        """Pad u8 [N, H, W] with blank rows to its batch bucket, upload and
        encode; returns (mem, ctc, ids, conf, est, n_valid)."""
        imgs_u8 = np.asarray(imgs_u8, np.uint8)
        n = imgs_u8.shape[0]
        pad = pick_batch_bucket(self.cfg, n) - n
        if pad:
            imgs_u8 = np.concatenate(
                [imgs_u8, np.zeros((pad,) + imgs_u8.shape[1:], np.uint8)])
        x = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(self.device)
        return (*self._encode(x), n)

    def encode_batch(self, imgs_u8: np.ndarray):
        """u8 [N, H, W] -> (memp, ctc_logits, ids, conf, est_len, n_valid)
        on the device; the batch is padded with blank rows to its bucket."""
        mem, ctc, ids, conf, est, n = self._encode_u8(imgs_u8)
        with torch.inference_mode():
            memp = self.model.mem_project(mem)
        return memp, ctc, ids, conf, est, n

    def _texts(self, chunks) -> List[List[Result]]:
        """(ids, conf, n_valid) per chunk -> results, with one fetch."""
        fetched = _fetch([t for ids, conf, _ in chunks for t in (ids, conf)])
        out = []
        for k, (_, _, m) in enumerate(chunks):
            ids, conf = fetched[2 * k][:m], fetched[2 * k + 1][:m]
            out.append([(t, float(c)) for t, c in
                        zip(self.tok.decode_ctc_batch(ids), conf)])
        return out

    # --------------------------------------------------------- public paths
    def recognize_batch(self, imgs_u8: np.ndarray, method: str,
                        widths: Optional[np.ndarray] = None
                        ) -> List[Result]:
        """Recognize N preprocessed u8 lines [N, IMG_H, IMG_W]; returns
        (text, confidence) per line in input order.

        With ``widths`` (each line's content width) the lines are grouped by
        width bucket (``cfg.WIDTH_BUCKETS``) and each group is encoded
        sliced to its bucket, in chunks of at most the largest batch
        bucket. Slicing moves the stem's zero edge to the bucket's edge, as
        in the JAX package, so results depend on the bucket.
        """
        _check_method(method)
        imgs_u8 = np.asarray(imgs_u8)
        n = imgs_u8.shape[0]
        if n == 0:
            return []
        if widths is None:
            _, _, ids, conf, _, m = self._encode_u8(imgs_u8)
            return self._texts([(ids, conf, m)])[0]
        groups: Dict[int, List[int]] = {}
        for i in range(n):
            groups.setdefault(pick_width_bucket(self.cfg, int(widths[i])),
                              []).append(i)
        max_b = int(self.cfg.BATCH_BUCKETS[-1])
        order, chunks = [], []
        for bw, idxs in sorted(groups.items()):
            for s in range(0, len(idxs), max_b):
                chunk = idxs[s: s + max_b]
                _, _, ids, conf, _, m = self._encode_u8(
                    imgs_u8[np.asarray(chunk), :, :bw])
                order.append(chunk)
                chunks.append((ids, conf, m))
        out: List[Optional[Result]] = [None] * n
        for idxs, results in zip(order, self._texts(chunks)):
            for i, r in zip(idxs, results):
                out[i] = r
        return out  # type: ignore[return-value]

    def recognize_crops(self, crops: Sequence[np.ndarray], method: str,
                        enhance: bool = False) -> List[Result]:
        """Recognize raw variable-size u8 line crops, preprocessed on the
        device (invert-if-dark, aspect resize, pad, normalize) at the full
        width IMG_W."""
        _check_method(method)
        if enhance:
            raise NotImplementedError("enhance=True (device crop cleanup) "
                                      "comes with a later slice of the port")
        if len(crops) == 0:
            return []
        buf, sizes = pack_crops(list(crops))
        n = buf.shape[0]
        pad = pick_batch_bucket(self.cfg, n) - n
        sizes3 = np.zeros((n + pad, 3), np.int32)
        sizes3[:n, :2] = sizes
        sizes3[n:, :2] = 1
        if pad:
            buf = np.concatenate(
                [buf, np.zeros((pad,) + buf.shape[1:], np.uint8)])
        norm = preprocess_lines(torch.from_numpy(buf).to(self.device),
                                torch.from_numpy(sizes3).to(self.device),
                                self.cfg.IMG_H, self.cfg.IMG_W)
        _, _, ids, conf, _ = self._encode(norm)
        return self._texts([(ids, conf, n)])[0]
