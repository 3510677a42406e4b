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

        --"beam" with ``cfg.SPEC_BEAM``: ``spec_decode`` and its certificate
          (``beam_device_spec``); the step loop runs only for the rows the
          certificate does not cover (``beam_device_bucketed``)

``recognize_crops`` preprocesses raw variable-size crops on the device
(``kernels.resize.preprocess_lines``, after ``enhance_lines`` with
``enhance=True``) and then recognizes them the same way. Width-bucketed
batches keep the JAX package's fetch pattern: every chunk is encoded, one
fetch brings the length estimates, every chunk's decode is launched, one
fetch brings the results.

``stream_records[_batch]`` give the reference's streaming records, one
sequence a line: replayed from one decode of the whole batch, or produced a
window of steps at a time (``window=W``, ``_WindowedStream``).

``mesh=`` (``kiri_tpu_torch.parallel.make_mesh``, one process per device):
the parameters are placed by ``parallel.shard_variables`` (the model axis
splits attentions, FFNs and vocabulary heads, whose forward then all-reduces
over it), and each public call splits its lines over the data axis as
``kiri_tpu`` shards its batch: the batch bucket rounded up to a multiple of
the data axis, in equal blocks of rows, the rows past the batch left out.
Each rank recognizes its rows (the stem and preprocess kernels on its own
device) and every rank returns the whole batch's results in input order.
Every rank must make the same calls with the same lines. Over a data axis
above 1 a stream's records are gathered whole before they are returned.
"""
from __future__ import annotations

from typing import (Dict, Generator, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from .checkpoints import find_vocab_file, load_checkpoint
from .config import CFG
from .device import resolve_device
from .data.khmer_order import IncrementalLogical
from .kernels.resize import (enhance_lines, pack_crops, post_blur_masked,
                             preprocess_lines)
from . import parallel as P
from .models.recognizer import Recognizer
from .ops import decode as D
from .ops.ctc import greedy_ctc_stats
from .ops.preprocess import pick_batch_bucket, pick_width_bucket
from .tokenizer import CharTokenizer
from .utils.profiling import annotate, count

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
    """Copy float32, int32 and bool tensors to the host in one transfer:
    one wait for the device."""
    count("host_waits")
    with annotate("engine.fetch"):
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
    bucket. ``memp`` is None where only the CTC head is read; ``ctc`` is
    None for a checkpoint without a CTC head (``cfg.USE_CTC`` false), whose
    ``ids``, ``conf`` and ``est`` are zeros."""
    memp: Optional[torch.Tensor]
    ctc: Optional[torch.Tensor]
    ids: torch.Tensor
    conf: torch.Tensor
    est: torch.Tensor
    n: int


class RecognizerEngine:
    def __init__(self, model: Recognizer, cfg: CFG, tok: CharTokenizer,
                 device=None, upload_bits: int = 8, mesh=None):
        """``device=None`` means the card; pass ``device="cpu"`` to run on
        the CPU (the kernels' plain versions). ``cfg.COMPUTE_DTYPE`` picks
        the compute dtype. ``upload_bits=4`` packs two 16-level pixels per
        byte on the host (``pack4``) and unpacks them on the device, halving
        the upload of ``recognize_batch``; 8 keeps the pixels exact.
        ``mesh``: recognize over the ranks of a ``parallel.Mesh`` (see the
        module's docstring)."""
        if upload_bits not in (4, 8):
            raise ValueError(f"upload_bits must be 4 or 8, got {upload_bits}")
        self.device = resolve_device(device)
        model = model.to(self.device)
        if mesh is not None:
            model = P.shard_variables(model, mesh)
        self.model = model.eval()
        self.mesh = mesh
        self._dp = 1 if mesh is None else mesh.data_size
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
        #: Rows that ``beam_device_spec`` certified (no step loop needed),
        #: counted over the engine's life.
        self.certified_rows = 0

    @classmethod
    def from_checkpoint(cls, path: str, device=None, upload_bits: int = 8,
                        mesh=None) -> "RecognizerEngine":
        """Engine over a recognizer file in any format that
        ``checkpoints.load_checkpoint`` reads, its config and the vocab
        beside it."""
        model, cfg, meta = load_checkpoint(path, device=device)
        vocab = find_vocab_file(meta.get("vocab_path", ""), path)
        if vocab is None:
            raise FileNotFoundError(f"no vocab file found near {path}")
        return cls(model, cfg, CharTokenizer(vocab, cfg), device, upload_bits,
                   mesh)

    # ------------------------------------------------------------ the mesh
    def _rows(self, n: int) -> Tuple[int, int, int]:
        """(lo, hi, rows a rank) of this rank's block of n lines over the
        data axis: the batch bucket rounded up to a multiple of the data
        axis, cut in equal blocks; [lo, hi) is clipped to the n lines."""
        dp = self._dp
        bucket = pick_batch_bucket(self.cfg, n)
        per = -(-bucket // dp)
        lo = min(n, self.mesh.data_index * per)
        return lo, min(n, lo + per), per

    def _over_data(self, n: int, fn) -> List:
        """``fn(lo, hi)`` (a list, one item a line) on this rank's lines,
        every rank's lists joined in line order; ``fn(0, n)`` without a data
        axis."""
        if self._dp == 1:
            return fn(0, n)
        lo, hi, _ = self._rows(n)
        mine = fn(lo, hi) if hi > lo else []
        return [r for part in P.all_gather_objects(mine, self.mesh.data_group)
                for r in part]

    # ------------------------------------------------------------ internals
    def _check(self, method: str) -> None:
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got "
                             f"{method!r}")

    @torch.inference_mode()
    def _encode(self, images: torch.Tensor, n: int, project: bool = True
                ) -> Encoded:
        with annotate("engine.encode"):
            mem = self.model.encode(images, self.dtype)
            if self.cfg.USE_CTC:
                ctc = self.model.ctc_logits(mem)
                ids, conf, est = greedy_ctc_stats(ctc, self.tok.ctc_offset)
            else:
                ctc, (b, t) = None, mem.shape[:2]
                ids = torch.zeros((b, t), dtype=torch.int32, device=mem.device)
                conf = torch.zeros(b, dtype=torch.float32, device=mem.device)
                est = torch.zeros(b, dtype=torch.int32, device=mem.device)
            memp = self.model.mem_project(mem) if project else None
            return Encoded(memp, ctc, ids, conf, est, n)

    def _encode_u8(self, imgs_u8: np.ndarray, project: bool = True
                   ) -> Encoded:
        """Pad u8 [N, H, W] with blank rows to its batch bucket, upload and
        encode."""
        with annotate("engine.upload"):
            imgs_u8 = np.asarray(imgs_u8, np.uint8)
            n = imgs_u8.shape[0]
            pad = pick_batch_bucket(self.cfg, n) - n
            if pad:
                imgs_u8 = np.concatenate(
                    [imgs_u8, np.zeros((pad,) + imgs_u8.shape[1:], np.uint8)])
            if self.upload_bits == 4:
                x = _unpack4(torch.from_numpy(pack4(imgs_u8)).to(self.device))
            else:
                x = torch.from_numpy(
                    np.ascontiguousarray(imgs_u8)).to(self.device)
        return self._encode(x, n, project)

    def encode_batch(self, imgs_u8: np.ndarray):
        """u8 [N, H, W] -> (memp, ctc_logits, ids, conf, est_len, n_valid)
        on the device; the batch is padded with blank rows to its bucket.
        Over a data axis each rank encodes its block of the padded batch
        (the bucket rounded up to a multiple of the axis) and every rank
        gets the whole padded batch's outputs."""
        imgs_u8 = np.asarray(imgs_u8, np.uint8)
        n = imgs_u8.shape[0]
        if self._dp == 1:
            return tuple(self._encode_u8(imgs_u8))
        _, _, per = self._rows(n)
        padded = np.zeros((per * self._dp,) + imgs_u8.shape[1:], np.uint8)
        padded[:n] = imgs_u8
        d = self.mesh.data_index
        e = self._encode_u8(padded[d * per: (d + 1) * per])
        m = self.mesh
        whole = [None if t is None else torch.cat(P.gather_tensor(
            t[:per], m.data_group, m.data_size, m.data_index))
            for t in e[:5]]
        return (*whole, n)

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
        device, host arrays on the host and uploaded; None stays None."""
        sel = np.asarray(rows, np.int64)
        pad = pick_batch_bucket(self.cfg, len(sel)) - len(sel)
        sel = np.concatenate([sel, np.full(pad, sel[0], np.int64)])
        sel_dev = torch.from_numpy(sel).to(self.device)
        return [None if t is None else torch.from_numpy(t[sel]).to(self.device)
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
        otherwise, and without a CTC head to draft from, the KV-cached step
        loop runs (``beam_search`` with one beam, or ``greedy_decode`` for
        ``raw_select``)."""
        if self.cfg.SPEC_DECODE and ctc is not None:
            rescore = not raw_select and self.cfg.ACCURATE_CTC_RESCORE
            with annotate("decode.spec"):
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
        with annotate("decode.step_loop"):
            memp, ctc, conf, tl = self._gather_rows(rows, e.memp, e.ctc,
                                                    e.conf, tl_np)
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
            with annotate("engine.texts"):
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
                with annotate("engine.texts"):
                    for i, t, cf in zip(idxs,
                                        self.tok.decode_ctc_batch(ids_np),
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
        if k > 1 and self.cfg.SPEC_BEAM:
            # Beam's texts, with the step loop only for the rows that the
            # certificate does not cover. Only valid rows are decoded.
            self._collect([([idxs[r] for r in rows], dec)
                           for (idxs, e), est_np in zip(chunks, ests)
                           for rows, dec in self.beam_device_spec(
                               e.memp, e.ctc, e.ids, est_np[:e.n], e.conf)],
                          out)
            return out  # type: ignore[return-value]
        launched, context = [], []
        for (idxs, e), est_np in zip(chunks, ests):
            l_cap = self._step_cap(est_np, e.n, e.memp.shape[1])
            tl_np = np.where(est_np > 0, est_np, 0).astype(np.int32)
            with annotate("engine.upload"):
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
        return self._over_data(n, lambda lo, hi: self._recognize_batch(
            imgs_u8[lo:hi], method,
            None if widths is None else np.asarray(widths)[lo:hi]))

    def _recognize_batch(self, imgs_u8: np.ndarray, method: str,
                         widths: Optional[np.ndarray]) -> List[Result]:
        n = imgs_u8.shape[0]
        project = method != "ctc"
        if widths is None:
            return self._recognize(
                [(list(range(n)), self._encode_u8(imgs_u8, project))],
                method, n)
        with annotate("engine.group"):
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
                        enhance: bool = False, sharpen=False
                        ) -> List[Result]:
        """Recognize raw variable-size u8 line crops, preprocessed on the
        device (invert-if-dark, aspect resize, pad, normalize) at the full
        width IMG_W.

        ``enhance`` first cleans the crops on the device
        (``kernels.resize.enhance_lines``: despike, noise-gated blur,
        unsharp mask where ``sharpen``, contrast stretch); noisy crops under
        36 px are resized linearly and blurred after the resize.
        ``sharpen`` is a bool or one bool per crop."""
        self._check(method)
        if len(crops) == 0:
            return []
        crops = list(crops)
        sharpen = (np.asarray(sharpen, bool) if np.ndim(sharpen)
                   else bool(sharpen))
        return self._over_data(len(crops), lambda lo, hi:
                               self._recognize_crops(
                                   crops[lo:hi], method, enhance,
                                   sharpen[lo:hi] if np.ndim(sharpen)
                                   else sharpen))

    def _recognize_crops(self, crops: List[np.ndarray], method: str,
                         enhance: bool, sharpen) -> List[Result]:
        with annotate("engine.upload"):
            norm, n = self._upload_crops(crops, enhance, sharpen)
        return self._recognize(
            [(list(range(n)), self._encode(norm, n, method != "ctc"))],
            method, n)

    def _upload_crops(self, crops: List[np.ndarray], enhance: bool, sharpen
                      ) -> Tuple[torch.Tensor, int]:
        """Pack the crops, pad them to their batch bucket, upload them and
        preprocess them on the device: (normalized lines, number of
        crops)."""
        buf, sizes = pack_crops(crops)
        n = buf.shape[0]
        pad = pick_batch_bucket(self.cfg, n) - n
        sizes = np.concatenate([sizes, np.ones((pad, 2), np.int32)])
        mask = np.concatenate([np.broadcast_to(np.asarray(sharpen, bool), (n,)),
                               np.zeros(pad, bool)])
        if pad:
            buf = np.concatenate(
                [buf, np.zeros((pad,) + buf.shape[1:], np.uint8)])
        with torch.inference_mode():
            dbuf = torch.from_numpy(buf).to(self.device)
            dsizes = torch.from_numpy(sizes).to(self.device)
            small_noisy = torch.zeros(n + pad, dtype=torch.bool,
                                      device=self.device)
            if enhance:
                dbuf, small_noisy = enhance_lines(
                    dbuf, dsizes, torch.from_numpy(mask).to(self.device))
            # (h, w, linear flag): the kernel resizes flagged lines linearly.
            sizes3 = torch.cat([dsizes, small_noisy.to(torch.int32)[:, None]],
                               dim=1)
            norm = preprocess_lines(dbuf, sizes3, self.cfg.IMG_H,
                                    self.cfg.IMG_W)
            if enhance:
                norm = post_blur_masked(norm, small_noisy)
        return norm, n

    # ------------------------------------------------------ beam dispatch
    def beam_device_bucketed(self, memp: torch.Tensor, ctc: torch.Tensor,
                             est_np: np.ndarray, conf: torch.Tensor,
                             chunk: Optional[int] = None
                             ) -> List[Tuple[np.ndarray, D.DecodeOut]]:
        """Beam search over the first ``len(est_np)`` rows of an encoded
        batch, in chunks of rows sorted by their step budget, each chunk
        with the step bucket (``cfg.BEAM_STEP_BUCKETS``) of its longest
        row: rows never interact, so the texts are one ``beam_search``'s,
        while short rows run short loops over a small cache.

        est_np: host [n] CTC length estimates of those rows. Every decode
        is launched before this returns; the caller fetches. Returns
        [(row indices, DecodeOut)], each row once; a DecodeOut's first
        ``len(rows)`` rows are theirs (a chunk is padded to a batch bucket
        with its own smallest-budget row).
        """
        n = len(est_np)
        tl_np = np.where(est_np > 0, est_np, 0).astype(np.int32)
        # The device's float32 budget: a float64 product could round a row
        # into the bucket below at a boundary.
        ms = D.max_decode_steps_host(self.cfg, tl_np, memp.shape[1])
        order = np.argsort(ms, kind="stable")
        if chunk is None:
            chunk = max(1, min(self.cfg.BEAM_CHUNK,
                               pick_batch_bucket(self.cfg, n)))
        launched = []
        for s in range(0, n, chunk):
            sel = order[s: s + chunk]
            l_cap = D.pick_l_cap(self.cfg, int(ms[sel].max(initial=1)),
                                 buckets=self.cfg.BEAM_STEP_BUCKETS)
            memp_c, ctc_c, conf_c, tl = self._gather_rows(sel, memp, ctc,
                                                          conf, tl_np)
            bound = self._step_bound(tl_np[sel], memp.shape[1], l_cap)
            launched.append((sel, self._launch_beam(
                memp_c, ctc_c, tl, conf_c, l_cap, bound, self.cfg.BEAM)))
        return launched

    def beam_device_spec(self, memp: torch.Tensor, ctc: torch.Tensor,
                         ids: torch.Tensor, est_np: np.ndarray,
                         conf: torch.Tensor, chunk: Optional[int] = None
                         ) -> List[Tuple[np.ndarray, D.DecodeOut]]:
        """The certificate-gated speculative beam over the first
        ``len(est_np)`` rows of an encoded batch: the CTC-drafted
        single-hypothesis decode (``spec_decode``) and one teacher-forced
        pass that proves, row by row, that ``beam_search`` would read the
        same text (``ops.decode.beam_spec_certificate``); only the rows it
        does not certify go through the step loop
        (``beam_device_bucketed``). Texts are beam's on every row; a
        certified row's confidence can differ from the step loop's in the
        last float digits. Same contract as ``beam_device_bucketed``; one
        fetch (the certificate) before the step loops are launched.
        """
        n = len(est_np)
        if ctc is None:
            # No CTC head: nothing to draft from, the step loop reads all.
            return self.beam_device_bucketed(memp, ctc, est_np, conf,
                                             chunk=chunk)
        tl_np = np.where(est_np > 0, est_np, 0).astype(np.int32)
        l_cap = self._step_cap(est_np, n, memp.shape[1])
        with torch.inference_mode():
            memp, ctc, ids, conf = (t[:n] for t in (memp, ctc, ids, conf))
            tl = torch.from_numpy(tl_np).to(self.device)
            with annotate("decode.spec"):
                spec = D.spec_decode(
                    self.model, memp, ids, tl, conf, cfg=self.cfg,
                    l_cap=l_cap, max_rounds=self.cfg.SPEC_MAX_ROUNDS,
                    **self._ids)
            cert = D.beam_spec_certificate(
                self.model, memp, ctc, tl, spec.tokens, spec.lengths,
                cfg=self.cfg, k_beam=self.cfg.BEAM, l_cap=l_cap,
                eos_id=self.tok.dec_eos, unk_dec_id=self._ids["unk_dec_id"],
                dec_offset=self.tok.dec_offset)
        cert_np, conv = _fetch([cert, spec.converged])
        ok = cert_np & conv
        self.certified_rows += int(ok.sum())
        good, bad = np.nonzero(ok)[0], np.nonzero(~ok)[0]
        launched: List[Tuple[np.ndarray, D.DecodeOut]] = []
        if len(good):
            sel = torch.from_numpy(good).to(self.device)
            launched.append((good, spec if len(good) == n else D.DecodeOut(
                *[None if f is None else f.index_select(0, sel)
                  for f in spec])))
        if len(bad):
            sel = torch.from_numpy(bad).to(self.device)
            memp_b, ctc_b, conf_b = (t.index_select(0, sel)
                                     for t in (memp, ctc, conf))
            launched += [(bad[rows], dec) for rows, dec in
                         self.beam_device_bucketed(memp_b, ctc_b, est_np[bad],
                                                   conf_b, chunk=chunk)]
        return launched

    # ---------------------------------------------------------- streaming
    def stream_records(self, img_u8: np.ndarray, method: str,
                       window: Optional[int] = None
                       ) -> Generator[Dict, None, None]:
        """Streaming records of ONE u8 line image [H, W] (or [1, H, W]), in
        the reference's schema; see ``stream_records_batch``."""
        imgs = np.asarray(img_u8)
        yield from self.stream_records_batch(
            imgs[None] if imgs.ndim == 2 else imgs, method, window=window)[0]

    def stream_records_batch(self, imgs_u8: np.ndarray, method: str,
                             window: Optional[int] = None
                             ) -> List[Iterable[Dict]]:
        """Streaming records of N u8 lines [N, IMG_H, W], one sequence of
        dicts a line, as the JAX package's ``stream_records_batch`` gives
        them. "auto" streams as "ctc" (streamed characters cannot be taken
        back by a later escalation); "decoder" streams the greedy selection
        (the argmax of the raw logits).

        window=None: one decode of the whole batch records each step, one
        fetch brings it all, and the records are replayed from it: the
        first record comes after the whole decode.

        window=W > 0 ("decoder" and "beam"): the decode runs W steps at a
        time, its state staying on the device, and each line's sequence is
        a generator that runs the next window only when it has no record
        left, with one fetch a window: a line's first record comes after
        the encode and one window. The records are those of window=None,
        but for the record that flushes a held Khmer cluster of a line
        whose budget ran out, which carries the window's step and
        confidence 0 as in the JAX package. "ctc" ignores ``window``.
        """
        self._check(method)
        imgs_u8 = np.asarray(imgs_u8)
        if imgs_u8.shape[0] == 0:
            return []
        if self._dp > 1:
            return self._over_data(imgs_u8.shape[0], lambda lo, hi: [
                list(r) for r in self._stream_records_batch(
                    imgs_u8[lo:hi], method, window)])
        return self._stream_records_batch(imgs_u8, method, window)

    def _stream_records_batch(self, imgs_u8: np.ndarray, method: str,
                              window: Optional[int]) -> List[Iterable[Dict]]:
        if method == "auto":
            method = "ctc"
        e = self._encode_u8(imgs_u8, project=method != "ctc")
        n = e.n
        if method == "ctc":
            with torch.inference_mode():
                # No CTC head: zero ids and probabilities, so each line
                # streams one finished record of "" (confidence 0).
                max_probs = (torch.zeros(e.ids.shape, device=e.ids.device)
                             if e.ctc is None else
                             torch.softmax(e.ctc, dim=-1).amax(dim=-1))
            ids_np, probs_np = _fetch([e.ids, max_probs])
            return [list(self._stream_ctc_row(ids_np[i], probs_np[i]))
                    for i in range(n)]
        tl_np = _fetch([e.est])[0].astype(np.int32)
        l_cap = self._step_cap(tl_np, n, e.memp.shape[1])
        bound = self._step_bound(tl_np, e.memp.shape[1], l_cap)
        tl = torch.from_numpy(tl_np).to(self.device)
        if window is not None and window > 0:
            runner = _WindowedStream(self, e, tl, method, l_cap, bound,
                                     int(window))
            return [runner.row_records(i) for i in range(n)]
        if method == "decoder":
            out = self._launch_single_hyp(e.memp, e.ctc, e.ids, tl, e.conf,
                                          l_cap, bound, raw_select=True)
            conv = (torch.ones_like(out.hist_steps, dtype=torch.bool)
                    if out.converged is None else out.converged)
            steps, extra, conv = _fetch([out.hist_steps, out.hist_extra,
                                         conv])
            recs = self._greedy_records(steps, extra, n)
            rows = [i for i in range(n) if not conv[i]]
            if rows:
                # spec_decode's round budget ran out: the step loop decodes
                # those rows again.
                self.fallback_rows += len(rows)
                fb = self._step_redecode(e, tl_np, rows, l_cap,
                                         raw_select=True)
                fb_recs = self._greedy_records(
                    *_fetch([fb.hist_steps, fb.hist_extra]), len(rows))
                for i, r in zip(rows, fb_recs):
                    recs[i] = r
            return recs
        with torch.inference_mode():
            out = D.beam_search(self.model, e.memp, e.ctc, tl, e.conf,
                                cfg=self.cfg, k_beam=self.cfg.BEAM,
                                l_cap=l_cap, step_bound=bound,
                                record_history=True, **self._ids)
        steps, toks, lens, scores, fins = _fetch(
            [t[:n] for t in (out.hist_steps, out.hist_tokens, out.hist_len,
                             out.hist_score, out.hist_finished)])
        hist = D.DecodeOut(None, None, None, None, None, steps,
                           hist_tokens=toks, hist_len=lens, hist_score=scores,
                           hist_finished=fins)
        return [list(self._stream_beam(hist, i)) for i in range(n)]

    def _greedy_records(self, steps: np.ndarray, extra: np.ndarray, n: int
                        ) -> List[List[Dict]]:
        """Records of the first n rows of a fetched greedy decode."""
        hist = D.DecodeOut(None, None, None, None, None, steps, extra)
        return [list(self._stream_greedy(hist, r)) for r in range(n)]

    def _stream_ctc_row(self, best_ids: np.ndarray, max_probs: np.ndarray
                        ) -> Generator[Dict, None, None]:
        """The CTC stream of one line from its per-frame ids and max
        probabilities: a record per new character, then a finished one."""
        decoded = ""
        prev = None
        step = 0
        # A visual-order checkpoint emits ink order: an open Khmer cluster
        # is held back and its logical characters come once it closes
        # ("token" may be "" or several characters).
        filt = self._stream_filter()
        for t in range(len(best_ids)):
            idx = int(best_ids[t])
            if idx == prev:
                continue
            prev = idx
            if idx < self.tok.ctc_offset:
                continue
            raw = idx - self.tok.ctc_offset
            if 0 <= raw < self.tok.vocab_size:
                char = self.tok.id_to_token.get(raw, "")
                if char and char != self.tok.unk_token:
                    emit = filt.push(char) if filt is not None else char
                    decoded += emit
                    step += 1
                    yield {"token": emit, "token_id": idx, "text": decoded,
                           "confidence": float(max_probs[t]), "step": step,
                           "finished": False}
        tail = filt.flush() if filt is not None else ""
        decoded += tail
        yield {"token": tail, "token_id": -1, "text": decoded,
               "confidence": float(max_probs.mean()), "step": step,
               "finished": True}

    def _stream_filter(self) -> Optional[IncrementalLogical]:
        """``IncrementalLogical`` for a visual-order checkpoint, else
        None."""
        return IncrementalLogical() if self.tok.visual_order else None

    def _greedy_record(self, line: "_LineText", prob: float, tid: int,
                       step: int) -> Dict:
        """The record of one greedy step of a line; updates ``line``."""
        tok = self.tok
        finished = tid == tok.dec_eos
        char = ""
        if not finished and tid not in (tok.dec_pad, tok.dec_bos,
                                        tok.dec_eos):
            raw = tid - tok.dec_offset
            if 0 <= raw < tok.vocab_size:
                # As the reference: an <unk> step yields token '<unk>' and
                # leaves the text as it was.
                char = tok.id_to_token.get(raw, "")
                if char != tok.unk_token and line.filt is not None:
                    char = line.filt.push(char)
                if char != tok.unk_token:
                    line.text += char
        if finished and line.filt is not None:
            tail = line.filt.flush()
            char, line.text = char + tail, line.text + tail
        return {"token": char, "token_id": tid, "text": line.text,
                "confidence": prob, "step": step, "finished": finished}

    def _beam_record(self, line: "_LineText", toks: np.ndarray, length: int,
                     score: np.float32, fin: bool, step: int) -> Dict:
        """The record of one beam step from the best beam's snapshot;
        ``token`` is what the text adds past its longest common prefix
        with the line's previous text (a visual-order checkpoint's logical
        text can change inside the prefix, where the JAX package's
        ``text[len(prev):]`` would emit stray characters)."""
        ids = toks[1:length]
        eos_pos = np.nonzero(ids == self.tok.dec_eos)[0]
        if eos_pos.size:
            ids = ids[: eos_pos[0]]
        text = self.tok.decode_dec(ids)
        token = text[_common_prefix(line.text, text):]
        line.text = text
        L = max(1, int(length) - 1)
        return {"token": token, "text": text,
                "confidence": float(min(1.0, max(0.0, np.exp(score / L)))),
                "step": step, "finished": bool(fin)}

    def _stream_greedy(self, out: D.DecodeOut, row: int = 0
                       ) -> Generator[Dict, None, None]:
        """Greedy streaming of one row of a fetched decode (``hist_steps``,
        ``hist_extra`` as host arrays)."""
        steps = int(np.asarray(out.hist_steps)[row])
        extra = np.asarray(out.hist_extra)[row]   # [S, 2] (raw prob, id)
        line = _LineText(self._stream_filter())
        prob = 0.0
        for s in range(steps):
            prob = float(extra[s, 0])
            rec = self._greedy_record(line, prob, int(extra[s, 1]), s + 1)
            yield rec
            if rec["finished"]:
                return
        # The budget ran out before EOS: release a held-back cluster, so
        # that the streamed text is whole (visual order only).
        tail = line.filt.flush() if line.filt is not None else ""
        if tail:
            line.text += tail
            yield {"token": tail, "token_id": -1, "text": line.text,
                   "confidence": prob, "step": steps + 1, "finished": False}

    def _stream_beam(self, out: D.DecodeOut, row: int = 0
                     ) -> Generator[Dict, None, None]:
        """Beam streaming of one row of a fetched ``record_history`` decode:
        the best beam after each step."""
        line = _LineText(None)
        for s in range(int(np.asarray(out.hist_steps)[row])):
            rec = self._beam_record(
                line, np.asarray(out.hist_tokens)[row, s],
                np.asarray(out.hist_len)[row, s],
                np.asarray(out.hist_score)[row, s],
                np.asarray(out.hist_finished)[row, s], s + 1)
            yield rec
            if rec["finished"]:
                return


def _common_prefix(a: str, b: str) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _LineText:
    """A streamed line's text so far and its visual-order filter."""

    def __init__(self, filt: Optional[IncrementalLogical]):
        self.filt = filt
        self.text = ""


class _WindowedStream:
    """The decode behind windowed streaming: its state stays on the device
    between windows (``ops.decode.*_stream_window``), and each line has a
    buffer of records.

    ``advance`` runs one window for every line, with one fetch, and turns
    its history into records; ``row_records(i)`` is a generator that calls
    ``advance`` only when line i has no buffered record left, so a reader
    who takes the lines in order has line 0's first records after one
    window, and the others' records come from windows already run. The
    records are made by the engine's ``_greedy_record`` / ``_beam_record``,
    as in the one-shot replay.
    """

    def __init__(self, engine: RecognizerEngine, e: Encoded,
                 tl: torch.Tensor, method: str, l_cap: int, bound: int,
                 window: int):
        self.e, self.n, self.method, self.window = engine, e.n, method, window
        self.tl = tl
        cfg, tok = engine.cfg, engine.tok
        with torch.inference_mode():
            if method == "beam":
                self.state, self.cross = D.beam_stream_init(
                    engine.model, e.memp, tl, cfg=cfg, k_beam=cfg.BEAM,
                    l_cap=l_cap, bos_id=tok.dec_bos, step_bound=bound)
            else:
                self.state, self.cross = D.greedy_stream_init(
                    engine.model, e.memp, tl, cfg=cfg, l_cap=l_cap,
                    bos_id=tok.dec_bos, step_bound=bound)
        self.buffers: List[List[Dict]] = [[] for _ in range(self.n)]
        # Beam texts come logical from decode_dec: only greedy filters.
        self.lines = [_LineText(engine._stream_filter() if method != "beam"
                                else None) for _ in range(self.n)]
        self._stopped = [False] * self.n      # the finished record is out
        self._t0 = 0                          # the step the window starts at
        self.windows = 0
        self.done = False

    def advance(self) -> None:
        """Run one window for every line and buffer its records."""
        if self.done:
            return
        e, tok, cfg, n = self.e, self.e.tok, self.e.cfg, self.n
        ids = dict(eos_id=tok.dec_eos, unk_dec_id=e._ids["unk_dec_id"])
        with torch.inference_mode():
            if self.method == "beam":
                self.state, hist, all_done = D.beam_stream_window(
                    e.model, self.state, self.cross, self.tl, cfg=cfg,
                    w=self.window, **ids)
                hist = [h[:n] for h in hist]
            else:
                self.state, extra, all_done = D.greedy_stream_window(
                    e.model, self.state, self.cross, self.tl, cfg=cfg,
                    w=self.window, **ids)
                hist = [extra[:n]]
        *hist, steps_done, all_done = _fetch(
            hist + [self.state.steps_done, all_done])
        self.windows += 1
        for i in range(n):
            if self._stopped[i]:
                continue
            for s in range(max(0, int(steps_done[i]) - self._t0)):
                step = self._t0 + s + 1
                if self.method == "beam":
                    rec = e._beam_record(self.lines[i], hist[0][i, s],
                                         hist[1][i, s], hist[2][i, s],
                                         hist[3][i, s], step)
                else:
                    rec = e._greedy_record(self.lines[i],
                                           float(hist[0][i, s, 0]),
                                           int(hist[0][i, s, 1]), step)
                self.buffers[i].append(rec)
                if rec["finished"]:
                    self._stopped[i] = True
                    break
        # Lines take their steps from the window's start, so the JAX
        # package's window (a while_loop over the batch, padding rows
        # included) ends after the most steps any line has taken.
        self._t0 = int(steps_done.max())
        self.done = bool(all_done)

    def row_records(self, i: int) -> Generator[Dict, None, None]:
        emitted = 0
        while True:
            buf = self.buffers[i]
            while emitted < len(buf):
                emitted += 1
                yield buf[emitted - 1]
            if self._stopped[i] or self.done:
                line = self.lines[i]
                if not self._stopped[i] and line.filt is not None:
                    # The budget ran out before EOS: release the held-back
                    # cluster, as the JAX package's windowed stream does.
                    tail = line.filt.flush()
                    if tail:
                        line.text += tail
                        yield {"token": tail, "token_id": -1,
                               "text": line.text, "confidence": 0.0,
                               "step": self._t0 + 1, "finished": False}
                return
            self.advance()
