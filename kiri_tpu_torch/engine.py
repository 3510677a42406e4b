"""RecognizerEngine: batched line recognition on the card (the port of
``kiri_tpu/engine.py``).

    u8 lines [N, 48, 640] --width buckets, batch buckets--> encode + CTC head
        + greedy CTC stats (on the device)
        --"ctc": one fetch--> texts (host)
        --"decoder": CTC-drafted ``spec_decode`` with its two-candidate
          rescore; rows past the round budget go through the step loop again
        --"beam": ``beam_search`` with ``cfg.BEAM`` beams
        --"auto": the CTC texts, and beam search for the rows whose CTC
          confidence lies below ``cfg.AUTO_CONF_THRESHOLD``

``recognize_crops`` preprocesses raw variable-size crops on the device
(``kernels.resize.preprocess_lines``) and then recognizes them the same way.
Width-bucketed batches keep the JAX package's fetch pattern: every chunk is
encoded, one fetch brings the length estimates, every chunk's decode is
launched, one fetch brings the results. ``enhance=True`` and the
certificate-gated beam (``cfg.SPEC_BEAM``) are not ported and raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoints import find_vocab_file, load_checkpoint
from .config import CFG
from .device import resolve_device
from .kernels.resize import pack_crops, preprocess_lines
from .models.recognizer import Recognizer
from .ops import decode as D
from .ops.ctc import greedy_ctc_stats
from .ops.preprocess import pick_batch_bucket, pick_width_bucket
from .tokenizer import CharTokenizer

Result = Tuple[str, float]
METHODS = ("ctc", "decoder", "beam", "auto")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pack4(imgs_u8: np.ndarray) -> np.ndarray:
    """uint8 [..., W] -> uint8 [..., W/2]: two 16-level pixels per byte,
    quantized to the nearest of {0, 17, ..., 255}. W must be even."""
    q = ((imgs_u8.astype(np.uint16) + 8) // 17).astype(np.uint8)
    return (q[..., 0::2] << 4) | q[..., 1::2]


def _unpack4(packed_u8: torch.Tensor) -> torch.Tensor:
    """On the device, the inverse of ``pack4``: u8 [..., W/2] -> u8 [..., W]."""
    pair = torch.stack([(packed_u8 >> 4) * 17, (packed_u8 & 0xF) * 17], dim=-1)
    return pair.reshape(*packed_u8.shape[:-1], packed_u8.shape[-1] * 2)


def _fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Copy float32, int32 and bool tensors to the host in one transfer."""
    flat = torch.cat([(t.to(torch.int32) if t.dtype == torch.bool else t)
                      .reshape(-1).view(torch.int32) for t in tensors])
    flat = flat.cpu().numpy()
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        part = flat[o: o + n]
        if t.dtype == torch.float32:
            part = part.view(np.float32)
        elif t.dtype == torch.bool:
            part = part.astype(bool)
        out.append(part.reshape(tuple(t.shape)))
        o += n
    return out


class Encoded(NamedTuple):
    """One encoded chunk on the device: rows past ``n`` pad the batch to its
    bucket. ``memp`` is None where only the CTC head is read."""
    memp: Optional[torch.Tensor]
    ctc: torch.Tensor
    ids: torch.Tensor
    conf: torch.Tensor
    est: torch.Tensor
    n: int


class RecognizerEngine:
    def __init__(self, model: Recognizer, cfg: CFG, tok: CharTokenizer,
                 device=None, upload_bits: int = 8):
        """``device=None`` means the card; pass ``device="cpu"`` to run on
        the CPU (the kernels' plain versions). ``cfg.COMPUTE_DTYPE`` picks
        the compute dtype. ``upload_bits=4`` packs two 16-level pixels per
        byte on the host (``pack4``) and unpacks them on the device, halving
        the upload of ``recognize_batch``; 8 keeps the pixels exact."""
        if upload_bits not in (4, 8):
            raise ValueError(f"upload_bits must be 4 or 8, got {upload_bits}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.tok = tok
        self.upload_bits = upload_bits
        self.dtype = _DTYPES[cfg.COMPUTE_DTYPE]
        self._ids = dict(eos_id=tok.dec_eos,
                         unk_dec_id=tok.unk_id + tok.dec_offset,
                         dec_offset=tok.dec_offset, bos_id=tok.dec_bos)
        #: Rows that ``spec_decode`` left unconverged and the step loop
        #: decoded again, counted over the engine's life.
        self.fallback_rows = 0

    @classmethod
    def from_checkpoint(cls, path: str, device=None, upload_bits: int = 8
                        ) -> "RecognizerEngine":
        """Engine over a checkpoint, its meta's config and the vocab beside
        it."""
        model, cfg, meta = load_checkpoint(path, device)
        vocab = find_vocab_file(meta.get("vocab_path", ""), path)
        if vocab is None:
            raise FileNotFoundError(f"no vocab file found near {path}")
        return cls(model, cfg, CharTokenizer(vocab, cfg), device, upload_bits)

    # ------------------------------------------------------------ internals
    def _check(self, method: str, enhance: bool = False) -> None:
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got "
                             f"{method!r}")
        if method == "beam" and self.cfg.SPEC_BEAM:
            raise NotImplementedError(
                "cfg.SPEC_BEAM: the certificate-gated beam (beam_device_spec"
                ", beam_spec_certificate) comes with a later slice of the "
                "port")
        if enhance:
            raise NotImplementedError("enhance=True (device crop cleanup) "
                                      "comes with a later slice of the port")

    @torch.inference_mode()
    def _encode(self, images: torch.Tensor, n: int, project: bool = True
                ) -> Encoded:
        mem = self.model.encode(images, self.dtype)
        ctc = self.model.ctc_logits(mem)
        ids, conf, est = greedy_ctc_stats(ctc, self.tok.ctc_offset)
        memp = self.model.mem_project(mem) if project else None
        return Encoded(memp, ctc, ids, conf, est, n)

    def _encode_u8(self, imgs_u8: np.ndarray, project: bool = True
                   ) -> Encoded:
        """Pad u8 [N, H, W] with blank rows to its batch bucket, upload and
        encode."""
        imgs_u8 = np.asarray(imgs_u8, np.uint8)
        n = imgs_u8.shape[0]
        pad = pick_batch_bucket(self.cfg, n) - n
        if pad:
            imgs_u8 = np.concatenate(
                [imgs_u8, np.zeros((pad,) + imgs_u8.shape[1:], np.uint8)])
        if self.upload_bits == 4:
            x = _unpack4(torch.from_numpy(pack4(imgs_u8)).to(self.device))
        else:
            x = torch.from_numpy(np.ascontiguousarray(imgs_u8)).to(self.device)
        return self._encode(x, n, project)

    def encode_batch(self, imgs_u8: np.ndarray):
        """u8 [N, H, W] -> (memp, ctc_logits, ids, conf, est_len, n_valid)
        on the device; the batch is padded with blank rows to its bucket."""
        return tuple(self._encode_u8(imgs_u8))

    def _decode_texts(self, tokens: np.ndarray, lengths: np.ndarray
                      ) -> List[str]:
        """Text = tokens[1:length], cut at the first eos."""
        texts = []
        for row, length in zip(tokens, lengths):
            ids = row[1:length]
            eos_pos = np.nonzero(ids == self.tok.dec_eos)[0]
            if eos_pos.size:
                ids = ids[: eos_pos[0]]
            texts.append(self.tok.decode_dec(ids))
        return texts

    def _step_cap(self, est_len: np.ndarray, n: int, mem_len: int) -> int:
        """The step bucket that covers the largest budget of the n lines."""
        tl = np.asarray(est_len)[:n]
        ms = np.where(
            tl > 0,
            np.minimum(self.cfg.MAX_DEC_LEN,
                       (tl * self.cfg.DEC_MAX_LEN_RATIO).astype(np.int64)
                       + self.cfg.DEC_MAX_LEN_PAD),
            min(self.cfg.MAX_DEC_LEN, int(mem_len * self.cfg.MEM_MAX_LEN_RATIO)
                + self.cfg.DEC_MAX_LEN_PAD))
        return D.pick_l_cap(self.cfg, int(ms.max(initial=1)))

    def _step_bound(self, tl_np: np.ndarray, mem_len: int, l_cap: int) -> int:
        """How many steps a step loop over these rows (padding included) can
        need: the bound the host loops to without asking the device."""
        return min(l_cap, int(D.max_decode_steps_host(
            self.cfg, tl_np, mem_len).max(initial=1)))

    def _gather_rows(self, rows: Sequence[int], *tensors):
        """The given rows of each tensor, padded to a batch bucket with
        copies of the first of them: device tensors are gathered on the
        device, host arrays on the host and uploaded."""
        sel = np.asarray(rows, np.int64)
        pad = pick_batch_bucket(self.cfg, len(sel)) - len(sel)
        sel = np.concatenate([sel, np.full(pad, sel[0], np.int64)])
        sel_dev = torch.from_numpy(sel).to(self.device)
        return [torch.from_numpy(t[sel]).to(self.device)
                if isinstance(t, np.ndarray) else t.index_select(0, sel_dev)
                for t in tensors]

    @torch.inference_mode()
    def _launch_beam(self, memp, ctc, tl: torch.Tensor, conf, l_cap: int,
                     bound: int, k: int) -> D.DecodeOut:
        return D.beam_search(self.model, memp, ctc, tl, conf, cfg=self.cfg,
                             k_beam=k, l_cap=l_cap, step_bound=bound,
                             **self._ids)

    @torch.inference_mode()
    def _launch_single_hyp(self, memp, ctc, ids, tl: torch.Tensor, conf,
                           l_cap: int, bound: int, raw_select: bool = False
                           ) -> D.DecodeOut:
        """Single-hypothesis decode ("decoder"/accurate mode).

        With cfg.SPEC_DECODE the CTC transcript drafts the output and
        teacher-forced passes verify it (``ops.decode.spec_decode``: a few
        passes per batch and not one step per character, the same output);
        otherwise the KV-cached step loop runs (``beam_search`` with one
        beam, or ``greedy_decode`` for ``raw_select``)."""
        if self.cfg.SPEC_DECODE:
            rescore = not raw_select and self.cfg.ACCURATE_CTC_RESCORE
            return D.spec_decode(
                self.model, memp, ids, tl, None if raw_select else conf,
                cfg=self.cfg, l_cap=l_cap, raw_select=raw_select,
                max_rounds=self.cfg.SPEC_MAX_ROUNDS,
                ctc_logits=ctc if rescore else None, **self._ids)
        if raw_select:
            return D.greedy_decode(
                self.model, memp, tl, cfg=self.cfg, l_cap=l_cap,
                step_bound=bound, eos_id=self.tok.dec_eos,
                unk_dec_id=self._ids["unk_dec_id"], bos_id=self.tok.dec_bos)
        return self._launch_beam(memp, ctc, tl, conf, l_cap, bound, 1)

    def _step_redecode(self, e: Encoded, tl_np: np.ndarray, rows: List[int],
                       l_cap: int, raw_select: bool = False) -> D.DecodeOut:
        """Decode the given rows again with the step loop: ``spec_decode``'s
        fallback for rows past its round budget. The rows are gathered on
        the device from the chunk's encoder outputs."""
        memp, ctc, conf, tl = self._gather_rows(rows, e.memp, e.ctc, e.conf,
                                                tl_np)
        bound = self._step_bound(tl_np[rows], memp.shape[1], l_cap)
        if raw_select:
            with torch.inference_mode():
                return D.greedy_decode(
                    self.model, memp, tl, cfg=self.cfg, l_cap=l_cap,
                    step_bound=bound, eos_id=self.tok.dec_eos,
                    unk_dec_id=self._ids["unk_dec_id"],
                    bos_id=self.tok.dec_bos)
        return self._launch_beam(memp, ctc, tl, conf, l_cap, bound, 1)

    def _launch_escalation(self, e: Encoded, conf_np: np.ndarray,
                           est_np: np.ndarray):
        """For "auto": launch beam search on the rows of an encoded chunk
        whose greedy-CTC confidence lies below cfg.AUTO_CONF_THRESHOLD,
        gathered on the device from the encoder outputs. Returns (rows,
        DecodeOut), or None if every row is confident; the caller fetches."""
        low = [r for r in range(e.n)
               if conf_np[r] < self.cfg.AUTO_CONF_THRESHOLD]
        if not low:
            return None
        l_cap = self._step_cap(est_np[low], len(low), e.memp.shape[1])
        tl_np = np.where(est_np > 0, est_np, 0).astype(np.int32)
        memp, ctc, conf, tl = self._gather_rows(low, e.memp, e.ctc, e.conf,
                                                tl_np)
        bound = self._step_bound(tl_np[low], memp.shape[1], l_cap)
        return low, self._launch_beam(memp, ctc, tl, conf, l_cap, bound,
                                      self.cfg.BEAM)

    def _collect(self, launched: List[Tuple[List[int], D.DecodeOut]],
                 out: List[Optional[Result]]
                 ) -> List[Optional[np.ndarray]]:
        """One fetch for every launched decode; writes (text, final_conf) of
        its rows into ``out`` and returns each decode's ``converged`` (None
        where the decode reports none)."""
        if not launched:
            return []
        fields = [(d.tokens, d.lengths, d.final_conf)
                  + (() if d.converged is None else (d.converged,))
                  for _, d in launched]
        fetched = iter(_fetch([t for f in fields for t in f]))
        conv = []
        for (idxs, _), f in zip(launched, fields):
            tokens, lengths, final_conf = (next(fetched) for _ in range(3))
            conv.append(next(fetched)[:len(idxs)] if len(f) > 3 else None)
            texts = self._decode_texts(tokens[:len(idxs)], lengths)
            for i, t, c in zip(idxs, texts, final_conf):
                out[i] = (t, float(c))
        return conv

    def _recognize(self, chunks: List[Tuple[List[int], Encoded]], method: str,
                   n_out: int) -> List[Result]:
        """Results of encoded chunks (output indices, Encoded) in output
        order, with one fetch of what the host must see before it can launch
        the decodes and one of their results."""
        out: List[Optional[Result]] = [None] * n_out
        if method in ("ctc", "auto"):
            # The CTC results of every chunk in one fetch; for "auto" then
            # beam search on each chunk's low-confidence rows, all launched
            # before the one fetch of their results.
            per = 3 if method == "auto" else 2
            fetched = _fetch([t for _, e in chunks
                              for t in (e.ids, e.conf, e.est)[:per]])
            launched = []
            for c, (idxs, e) in enumerate(chunks):
                ids_np, conf_np = (a[:e.n] for a in
                                   fetched[per * c: per * c + 2])
                for i, t, cf in zip(idxs, self.tok.decode_ctc_batch(ids_np),
                                    conf_np):
                    out[i] = (t, float(cf))
                if method == "auto":
                    esc = self._launch_escalation(e, conf_np,
                                                  fetched[per * c + 2][:e.n])
                    if esc is not None:
                        launched.append(([idxs[r] for r in esc[0]], esc[1]))
            self._collect(launched, out)
            return out  # type: ignore[return-value]
        # "decoder" / "beam": one fetch of every chunk's length estimates,
        # every chunk's decode launched, one fetch of the results.
        k = 1 if method == "decoder" else self.cfg.BEAM
        ests = _fetch([e.est for _, e in chunks])
        launched, context = [], []
        for (idxs, e), est_np in zip(chunks, ests):
            l_cap = self._step_cap(est_np, e.n, e.memp.shape[1])
            tl_np = np.where(est_np > 0, est_np, 0).astype(np.int32)
            tl = torch.from_numpy(tl_np).to(self.device)
            bound = self._step_bound(tl_np, e.memp.shape[1], l_cap)
            dec = (self._launch_single_hyp(e.memp, e.ctc, e.ids, tl, e.conf,
                                           l_cap, bound) if k == 1 else
                   self._launch_beam(e.memp, e.ctc, tl, e.conf, l_cap, bound,
                                     k))
            launched.append((idxs[:e.n], dec))
            context.append((e, tl_np, l_cap))
        for (idxs, _), conv, (e, tl_np, l_cap) in zip(
                launched, self._collect(launched, out), context):
            if conv is None or conv.all():
                continue
            # spec_decode's round budget was hit (a draft far from the
            # decoder's reading): the step loop decodes just those rows.
            rows = [r for r in range(e.n) if not conv[r]]
            self.fallback_rows += len(rows)
            fb = self._step_redecode(e, tl_np, rows, l_cap)
            self._collect([([idxs[r] for r in rows], fb)], out)
        return out  # type: ignore[return-value]

    # --------------------------------------------------------- public paths
    def recognize_batch(self, imgs_u8: np.ndarray, method: str,
                        widths: Optional[np.ndarray] = None
                        ) -> List[Result]:
        """Recognize N preprocessed u8 lines [N, IMG_H, IMG_W]; returns
        (text, confidence) per line in input order. ``method`` is one of
        "ctc", "decoder", "beam", "auto"; "auto" gives the greedy-CTC result
        for rows whose CTC confidence reaches cfg.AUTO_CONF_THRESHOLD and the
        beam-search result for the others.

        With ``widths`` (each line's content width) the lines are grouped by
        width bucket (``cfg.WIDTH_BUCKETS``) and each group is encoded
        sliced to its bucket, in chunks of at most the largest batch
        bucket. Slicing moves the stem's zero edge to the bucket's edge, as
        in the JAX package, so results depend on the bucket.
        """
        self._check(method)
        imgs_u8 = np.asarray(imgs_u8)
        n = imgs_u8.shape[0]
        if n == 0:
            return []
        project = method != "ctc"
        if widths is None:
            return self._recognize(
                [(list(range(n)), self._encode_u8(imgs_u8, project))],
                method, n)
        groups: Dict[int, List[int]] = {}
        for i in range(n):
            groups.setdefault(pick_width_bucket(self.cfg, int(widths[i])),
                              []).append(i)
        max_b = int(self.cfg.BATCH_BUCKETS[-1])
        chunks = []
        for bw, idxs in sorted(groups.items()):
            for s in range(0, len(idxs), max_b):
                chunk = idxs[s: s + max_b]
                chunks.append((chunk, self._encode_u8(
                    imgs_u8[np.asarray(chunk), :, :bw], project)))
        return self._recognize(chunks, method, n)

    def recognize_crops(self, crops: Sequence[np.ndarray], method: str,
                        enhance: bool = False) -> List[Result]:
        """Recognize raw variable-size u8 line crops, preprocessed on the
        device (invert-if-dark, aspect resize, pad, normalize) at the full
        width IMG_W."""
        self._check(method, enhance)
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
        return self._recognize(
            [(list(range(n)), self._encode(norm, n, method != "ctc"))],
            method, n)
