"""Recognizer training on one card: the port of ``kiri_tpu/train/trainer.py``.

Hybrid loss 0.5 * CTC + 0.5 * cross-entropy of the teacher-forced decoder;
global-norm clipping at 1.0 as optax computes it, then AdamW (betas (0.9,
0.98), eps 1e-8, decay on every trained parameter) under the OneCycle cosine
schedule, computed on the host; decoder-only mode; CTC exact-match
validation plus sampled AR decoding through the port's ``RecognizerEngine``;
step, epoch, latest and best checkpoints and ``history.json``.

The forward and backward of a step are torch operations (convs, matmuls,
``F.ctc_loss``), as the JAX trainer's are XLA operations, without TF32 in a
float32 run: the TPU kernel of the stem computes only the BN-folded
inference stem and has no gradient.
Inference inside training (validation, the frozen encoder of decoder-only
mode) runs the eval forward, whose stem is the CUDA kernel on the card.

More than one device (``n_devices``, ``model_parallel`` above 1) means one
process per device, joined by ``kiri_tpu_torch.parallel.initialize`` (under
``torchrun``): a (data, model) mesh as ``kiri_tpu``'s. Every rank takes the
same global batch, pads it with zero rows to a multiple of the data axis
and keeps its rows; the stem's BatchNorm statistics are the global batch's;
the loss terms are sums over the rank's rows divided by global counts, so
the gradients summed over the data axis are the global batch's, clipped by
their global norm (shards' squares added over the model axis); dropout and
decoder-input noise are drawn for the global batch from the one seeded
generator and cut to the rank's rows (and heads or hidden slice under
tensor parallelism). A data-parallel step is thus one device's step on the
padded global batch. Rank 0 writes the checkpoints (gathered whole).

Differences from the JAX package: parameters the loss never reaches
(``lm_head``) get zero gradients so that AdamW still decays them, as optax
does; a resumed ``train_loop`` restores the dropout generator
and replays the epoch plans already trained, so a run resumed at an epoch
boundary continues as the run that was not stopped (the JAX package starts
both afresh); labels are replaced by their canonical text
(``CharTokenizer.canonical_text``).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel as P
from ..checkpoints import load_state, read_checkpoint
from ..config import CFG
from ..device import no_tf32, resolve_device
from ..models.layers import GlobalDraw, randint, rand, wide
from ..models.recognizer import Recognizer
from ..ops.ctc import ctc_loss_terms
from ..ops.preprocess import (content_width, pick_width_bucket,
                              resize_keep_ratio_pad_np)
from ..tokenizer import CharTokenizer
from .checkpoints import load_opt_state, save_checkpoint

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class TrainConfig:
    """Trainer hyperparameters (the JAX package's, field for field)."""

    epochs: int = 10
    batch_size: int = 32
    lr: float = 3e-4
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.98)
    grad_clip: float = 1.0
    warmup_steps: int = 4000
    ctc_weight: float = 0.5
    dec_weight: float = 0.5
    max_seq_len: int = 512
    save_steps: int = 0            # 0 = only per-epoch checkpoints
    out_dir: str = "checkpoints"
    seed: int = 42
    val_every: int = 1             # validate every N epochs
    n_devices: Optional[int] = None
    model_parallel: int = 1
    log_every: int = 50
    select_metric: str = "ctc"     # best-ckpt criterion: ctc | ar | mean
    train_only: Optional[str] = None   # None = all | "decoder"
    dec_input_noise: float = 0.0   # P(replace a decoder-input token)


#: The JAX package's DECODER_PARAM_KEYS under the port's module names
#: ("dec_layers" is "dec"): what feeds only the AR / beam decode path.
DECODER_PARAM_KEYS = ("mem_proj", "dec_emb", "dec", "dec_ln", "dec_head",
                      "lm_head")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def hybrid_loss(model: Recognizer, batch: Dict[str, torch.Tensor],
                gen: Optional[torch.Generator], *, cfg: CFG,
                dtype: torch.dtype, dec_pad: int, ctc_weight: float,
                dec_weight: float, train_only: Optional[str] = None,
                dec_input_noise: float = 0.0, dec_vocab: int = 0,
                mesh=None):
    """ctc_weight * CTC + dec_weight * CE on a batch of device tensors
    (image [B, H, W] u8, ctc_target [B, Lc], ctc_len [B], dec_inp and
    dec_tgt [B, Ld]). Returns (loss, the stem's new running statistics or
    None, metrics as 0-d tensors).

    Over ``mesh`` the batch is this rank's rows of the global batch: the
    returned loss is this rank's term (its rows' sums over the global
    counts; the terms of all ranks add up to the global loss) and the
    metrics are the global batch's.

    ``train_only="decoder"`` runs the encoder in eval mode (running
    statistics, no dropout, the stem kernel on the card) without gradients
    and skips the CTC loss. ``dec_input_noise`` replaces that fraction of
    real decoder-input tokens (never pad / bos / eos) by ids drawn from
    [3, dec_vocab), the targets kept.
    """
    dec_only = train_only == "decoder"
    if dec_only:
        with torch.no_grad():
            mem = model.encode(batch["image"], dtype)
        stats = None
    else:
        mem, stats = model.encode(batch["image"], dtype, train=True,
                                  drop=cfg.DROPOUT, gen=gen, mesh=mesh)
    b, t_mem, _ = mem.shape
    metrics = {}
    loss = torch.zeros((), dtype=torch.float32, device=mem.device)
    if cfg.USE_CTC and not dec_only:
        logits = model.ctc_logits(mem, cfg.DROPOUT, gen)
        frame_lens = torch.full((b,), t_mem, dtype=torch.int64,
                                device=mem.device)
        nll, count = ctc_loss_terms(logits, frame_lens, batch["ctc_target"],
                                    batch["ctc_len"])
        l_ctc = nll / P.data_sum_value(count, mesh).clamp(min=1)
        loss = loss + ctc_weight * l_ctc
        metrics["ctc_loss"] = l_ctc

    dec_inp = batch["dec_inp"]
    if dec_input_noise > 0.0 and dec_vocab > 3:
        replace = (rand(gen, dec_inp.shape, dec_inp.device)
                   < dec_input_noise)
        replace &= dec_inp > 2
        rand_ids = randint(gen, 3, dec_vocab, dec_inp.shape, dec_inp.device,
                           dec_inp.dtype)
        dec_inp = torch.where(replace, rand_ids, dec_inp)

    memp = model.mem_project(mem)
    dec_logits = model.decoder_train_logits(memp, dec_inp, cfg.DROPOUT, gen)
    tgt = batch["dec_tgt"].long()
    ce = F.cross_entropy(dec_logits.flatten(0, 1), tgt.flatten(),
                         reduction="none").view(tgt.shape)
    mask = (tgt != dec_pad).float()
    l_dec = (ce * mask).sum() / P.data_sum_value(mask.sum(), mesh).clamp(
        min=1.0)
    loss = loss + dec_weight * l_dec
    metrics["dec_loss"] = l_dec
    metrics["loss"] = loss
    metrics = {k: P.data_sum_value(v, mesh) for k, v in metrics.items()}
    return loss, stats, metrics


# ---------------------------------------------------------------------------
# Schedule and optimizer
# ---------------------------------------------------------------------------
def onecycle_schedule(total_steps: int, peak: float, warmup: int,
                      div_factor: float = 25.0,
                      final_div_factor: float = 1e4) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule(max(T, 2), peak, warmup / max(T, 2),
    div_factor, final_div_factor)`` on the host: the same float64 boundary
    arithmetic, the cosine in float32 as JAX takes it."""
    t = max(total_steps, 2)
    marks = {int(warmup / t * t): div_factor,
             int(t): 1.0 / (div_factor * final_div_factor)}
    boundaries, scales = zip(*sorted(marks.items()))
    bounds = np.stack((0,) + boundaries)
    values = np.cumprod(np.stack((peak / div_factor,) + scales))
    sizes = bounds[1:] - bounds[:-1]
    start, end = values[:-1], values[1:]

    def schedule(count: int) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = ((count - bounds[:-1]) / sizes).astype(np.float32)
        arg = np.float32(np.pi) * pct
        cos = np.cos(arg.astype(np.float64)).astype(np.float32) + np.float32(1)
        interp = (end.astype(np.float32)
                  + ((start - end) / 2.0).astype(np.float32) * cos)
        on = (bounds[:-1] <= count) & (count < bounds[1:])
        return float(on.dot(interp) + (bounds[-1] <= count) * values[-1])

    return schedule


def warmup_steps(tc: TrainConfig, total_steps: int) -> int:
    return min(tc.warmup_steps, max(1, total_steps // 10))


def clip_by_global_norm(grads: List[torch.Tensor], limit: float,
                        sharded: Sequence[bool] = (), mesh=None
                        ) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the norm is at least
    ``limit``, each gradient becomes (g / norm) * limit. Returns the norm
    before clipping, on the device (no host sync), in float32 (float64 in
    a float64 run). Over a ``mesh`` whose model axis splits the gradients
    flagged in ``sharded``, their squares are added over the model axis."""
    norms = torch.stack([torch.linalg.vector_norm(wide(g)) for g in grads])
    if mesh is None or mesh.model_size == 1 or not any(sharded):
        norm = torch.linalg.vector_norm(norms)
    else:
        split = torch.tensor(list(sharded), device=norms.device)
        sq = norms * norms
        norm = torch.sqrt(sq[~split].sum()
                          + P.model_sum_value(sq[split].sum(), mesh))
    under = norm < limit
    torch._foreach_div_(grads, torch.where(under, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(under, 1.0, limit))
    return norm


def make_optimizer(params: List[torch.nn.Parameter], tc: TrainConfig,
                   device: torch.device) -> torch.optim.AdamW:
    """AdamW over ``params``, decay on each (fused on the card)."""
    return torch.optim.AdamW(params, lr=tc.lr, betas=tuple(tc.betas),
                             eps=1e-8, weight_decay=tc.weight_decay,
                             fused=device.type == "cuda" or None)


def ar_divergence_warning(ctc_acc: float, ar_acc: float,
                          threshold: float = 0.15) -> Optional[str]:
    """A warning when the sampled AR accuracy lags CTC exact match by more
    than ``threshold``."""
    if ctc_acc - ar_acc > threshold:
        return (f"⚠ AR decoder accuracy ({ar_acc * 100:.1f}%) lags CTC "
                f"({ctc_acc * 100:.1f}%) by more than "
                f"{threshold * 100:.0f} points — decoder head may be "
                f"undertrained or diverging.")
    return None


# ---------------------------------------------------------------------------
# Host-side batching
# ---------------------------------------------------------------------------
def canonical_samples(samples, tok: CharTokenizer, verbose: bool = True
                      ) -> List[Dict[str, Any]]:
    """Sample dicts with each text replaced by ``tok.canonical_text``;
    prints how many changed (only Khmer in non-canonical cluster order
    changes, and only with ``KHMER_VISUAL_ORDER``)."""
    out, changed = [], 0
    for s in samples:
        text = tok.canonical_text(s["text"])
        changed += text != s["text"]
        out.append({**s, "text": text})
    if verbose and tok.visual_order:
        print(f"🔤 {changed} of {len(out)} labels replaced by their "
              "canonical cluster order")
    return out


def collate(samples: List[Dict[str, Any]], tok: CharTokenizer,
            max_seq_len: int = 512,
            img_hw: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """List of {image u8 [H, W], text} -> the fixed-shape numpy batch of the
    JAX package: images resize-padded to ``img_hw`` (or the common shape),
    CTC targets cut at max_seq_len - 1, decoder rows (bos-shifted input,
    eos-terminated target) cut at max_seq_len, both target widths one shared
    bucket, a multiple of 48. Texts are encoded in their canonical form."""
    imgs = [np.asarray(s["image"], dtype=np.uint8) for s in samples]
    if img_hw is None:
        shapes = {im.shape for im in imgs}
        img_hw = imgs[0].shape if len(shapes) == 1 else (
            max(im.shape[0] for im in imgs), max(im.shape[1] for im in imgs))
    imgs = [im if im.shape == tuple(img_hw)
            else resize_keep_ratio_pad_np(im, img_hw[0], img_hw[1])
            for im in imgs]
    images = np.stack(imgs)
    texts = [tok.canonical_text(s["text"]) for s in samples]
    enc_ctc = [tok.encode_ctc(t)[: max_seq_len - 1] for t in texts]
    enc_dec = [tok.encode_dec(t)[: max_seq_len] for t in texts]

    def _bucket(v: int) -> int:
        return min(max_seq_len, ((v + 47) // 48) * 48)

    b = len(samples)
    shared = _bucket(max(2, max((len(e) for e in enc_dec), default=2),
                         max((len(e) for e in enc_ctc), default=1)))
    ctc_target = np.zeros((b, shared), np.int32)
    ctc_len = np.zeros((b,), np.int32)
    dec_inp = np.zeros((b, shared - 1), np.int32)
    dec_tgt = np.zeros((b, shared - 1), np.int32)
    for i, (ec, ed) in enumerate(zip(enc_ctc, enc_dec)):
        ctc_target[i, : len(ec)] = ec
        ctc_len[i] = len(ec)
        if len(ed) < 2:
            ed = [tok.dec_bos, tok.dec_eos]
        if ed[-1] != tok.dec_eos:
            ed = ed[:-1] + [tok.dec_eos]
        dec_inp[i, : len(ed) - 1] = ed[:-1]
        dec_tgt[i, : len(ed) - 1] = ed[1:]
    return {"image": images, "ctc_target": ctc_target, "ctc_len": ctc_len,
            "dec_inp": dec_inp, "dec_tgt": dec_tgt}


def width_bucket_plan(rng: np.random.Generator, samples, cfg: CFG,
                      batch_size: int, full_width_prob: float = 0.25
                      ) -> List[Tuple[List[int], int]]:
    """One epoch's batch plan [(sample indices, pad width), ...], shuffled:
    samples grouped by the width bucket of their content, remainders filled
    by resampling within the group, a ``full_width_prob`` share padded to
    IMG_W. The same numpy RNG calls in the same order as the JAX package."""
    groups: Dict[int, List[int]] = {}
    for i, s in enumerate(samples):
        nw = content_width(np.asarray(s["image"]).shape, cfg.IMG_H, cfg.IMG_W)
        groups.setdefault(pick_width_bucket(cfg, nw), []).append(i)
    plan: List[Tuple[List[int], int]] = []
    for bw, idxs in groups.items():
        order = rng.permutation(len(idxs))
        for s0 in range(0, len(idxs), batch_size):
            chunk = [idxs[int(j)] for j in order[s0: s0 + batch_size]]
            if len(chunk) < batch_size:
                extra = rng.choice(idxs, size=batch_size - len(chunk),
                                   replace=len(idxs) < batch_size)
                chunk = chunk + [int(j) for j in extra]
            w = cfg.IMG_W if rng.random() < full_width_prob else bw
            plan.append((chunk, w))
    rng.shuffle(plan)
    return plan


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
def train_mesh(tc: TrainConfig):
    """The mesh of ``tc.n_devices`` (default: every rank) and
    ``tc.model_parallel``, or None for one device. More than one device
    needs the process group of ``parallel.initialize``."""
    rank, world = P.process_info()
    n = tc.n_devices if tc.n_devices is not None else world
    if n == 1 and tc.model_parallel == 1:
        return None
    if world == 1:
        raise RuntimeError(
            f"n_devices={tc.n_devices}, model_parallel={tc.model_parallel}: "
            "training on more than one device runs one process per device; "
            "call kiri_tpu_torch.parallel.initialize() in each (or start "
            "the run with torchrun --nproc-per-node N)")
    return P.make_mesh(n, tc.model_parallel)


class Trainer:
    """Recognizer training on one device, or on a mesh of ranks (see the
    module's docstring). ``device=None`` means the card; the model is made
    from scratch (``Recognizer.init_weights``, seeded by ``tc.seed``) unless
    one is given."""

    def __init__(self, cfg: CFG, tok: CharTokenizer, tc: TrainConfig,
                 model: Optional[Recognizer] = None,
                 total_steps: int = 10000, device=None):
        self.mesh = train_mesh(tc)
        self.cfg, self.tok, self.tc = cfg, tok, tc
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.COMPUTE_DTYPE]
        self.total_steps = total_steps
        if model is None:
            model = Recognizer(cfg, tok.vocab_size).init_weights(
                torch.Generator().manual_seed(tc.seed))
        self.model = model.to(self.device)
        if self.mesh is not None:
            self.model = P.shard_variables(self.model, self.mesh)
        specs = getattr(self.model, "shard_specs", {})
        decoder_only = tc.train_only == "decoder"
        self.trained: List[Tuple[str, torch.nn.Parameter]] = []
        for name, p in self.model.named_parameters():
            train = not decoder_only or name.split(".")[0] in DECODER_PARAM_KEYS
            p.requires_grad_(train)
            if train:
                # Zero, never None: AdamW skips a parameter without a
                # gradient, optax decays it.
                p.grad = torch.zeros_like(p)
                self.trained.append((name, p))
        self.sharded = [specs.get(n, P.Spec(())).dim is not None
                        and self.mesh.model_size > 1 for n, _ in self.trained]
        self.optimizer = make_optimizer([p for _, p in self.trained], tc,
                                        self.device)
        self.schedule = onecycle_schedule(total_steps, tc.lr,
                                          warmup_steps(tc, total_steps))
        self.gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.step = 0
        self.epoch = 0
        self.best_val_acc = 0.0
        self.last_ar_acc: Optional[float] = None
        self.history: List[Dict[str, float]] = []
        self._engine = None

    # -------------------------------------------------------------- stepping
    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items() if k != "text"}

    @property
    def is_writer(self) -> bool:
        """Whether this process writes files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def run_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One step on a ``collate`` batch (its forward and backward with
        TF32 off); returns its metrics (loss, ctc_loss, dec_loss, grad_norm
        before clipping). Over a mesh every rank passes the same global
        batch."""
        lr = float(np.float32(self.schedule(self.step)))
        tok, tc, mesh = self.tok, self.tc, self.mesh
        gen = self.gen
        if mesh is not None:
            if mesh.data_size > 1:
                batch, _ = P.pad_batch_to_devices(batch, mesh)
            n = len(batch["image"])
            lo, hi = P.local_batch_slice(n, mesh)
            batch = P.shard_batch_global(batch, mesh)
            gen = GlobalDraw(self.gen, lo, hi, n, mesh.model_index,
                             mesh.model_size)
        with no_tf32():
            loss, stats, metrics = hybrid_loss(
                self.model, self.to_device(batch), gen, cfg=self.cfg,
                dtype=self.dtype, dec_pad=tok.dec_pad,
                ctc_weight=tc.ctc_weight, dec_weight=tc.dec_weight,
                train_only=tc.train_only,
                dec_input_noise=tc.dec_input_noise, dec_vocab=tok.dec_vocab,
                mesh=mesh)
            loss.backward()
        grads = [p.grad for _, p in self.trained]
        P.sync_gradients(grads, mesh, self.sharded)
        metrics["grad_norm"] = clip_by_global_norm(grads, tc.grad_clip,
                                                   self.sharded, mesh)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        torch._foreach_zero_(grads)
        if stats is not None:
            self.model.stem.set_running_stats(stats)
        self.step += 1
        keys = sorted(metrics)
        values = torch.stack([metrics[k].detach().double() for k in keys])
        return dict(zip(keys, values.tolist()))

    # ------------------------------------------------------------ validation
    @torch.no_grad()
    def eval_ids(self, images: np.ndarray) -> np.ndarray:
        """CTC greedy ids [B, T] of u8 images, eval forward."""
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        mem = self.model.encode(x, self.dtype)
        return self.model.ctc_logits(mem).argmax(-1).cpu().numpy()

    def validate(self, val_batches: Iterable[Dict[str, Any]],
                 ar_sample_every: int = 10, verbose: bool = True) -> float:
        """CTC exact match against the canonical texts over all batches;
        AR decoding (``RecognizerEngine``, "decoder") of the whole first
        batch and the first line of every ``ar_sample_every``-th later one,
        its accuracy in ``last_ar_acc``. Returns the CTC accuracy."""
        correct = total = 0
        ar_imgs: List[np.ndarray] = []
        ar_texts: List[str] = []
        for bi, batch in enumerate(val_batches):
            imgs = batch["image"]
            texts = [self.tok.canonical_text(t) for t in batch["text"]]
            preds = self.tok.decode_ctc_batch(self.eval_ids(imgs))
            for p, t in zip(preds, texts):
                correct += int(p == t)
                total += 1
            if ar_sample_every and bi == 0:
                ar_imgs.append(np.asarray(imgs))
                ar_texts.extend(texts)
            elif ar_sample_every and bi % ar_sample_every == 0 and texts:
                ar_imgs.append(np.asarray(imgs[:1]))
                ar_texts.append(texts[0])
        acc = correct / max(1, total)

        self.last_ar_acc = None
        if ar_imgs:
            from ..engine import RecognizerEngine

            if self._engine is None:
                self._engine = RecognizerEngine(self.model, self.cfg,
                                                self.tok, self.device,
                                                mesh=self.mesh)
            results = self._engine.recognize_batch(
                np.concatenate(ar_imgs, axis=0), "decoder")
            ar_correct = sum(int(hyp == ref) for (hyp, _), ref
                             in zip(results, ar_texts))
            self.last_ar_acc = ar_correct / len(ar_texts)
            warning = ar_divergence_warning(acc, self.last_ar_acc)
            if warning and verbose:
                print(warning)
        return acc

    # ----------------------------------------------------------- checkpoints
    def opt_state(self, whole: bool = True) -> Dict[str, np.ndarray]:
        """The AdamW state by torch name, and the dropout generator's; over
        a mesh with ``whole`` the moments of sharded parameters are gathered
        whole (a collective of the model axis: every rank calls it)."""
        out = {"__generator__": self.gen.get_state().numpy()}
        specs = getattr(self.model, "shard_specs", {})
        for (name, p), split in zip(self.trained, self.sharded):
            st = self.optimizer.state.get(p)
            if st:
                for k in ("step", "exp_avg", "exp_avg_sq"):
                    v = st[k].detach().float()
                    if split and whole and k != "step":
                        v = P.join_shards(P.gather_tensor(
                            v, self.mesh.model_group, self.mesh.model_size,
                            self.mesh.model_index), specs[name])
                    out[f"{name}.{k}"] = v.cpu().numpy()
        return out

    def whole_model(self) -> Recognizer:
        """The model with whole parameters (gathered over the model axis:
        every rank calls it)."""
        if self.mesh is None or self.mesh.model_size == 1:
            return self.model
        return P.gather_variables(self.model, self.mesh)

    def save(self, path, vocab_path: str = "") -> None:
        """Write a checkpoint; over a mesh every rank calls it (the shards
        are gathered) and rank 0 writes."""
        model, opt = self.whole_model(), self.opt_state()
        if not self.is_writer:
            return
        save_checkpoint(path, model, self.cfg, vocab_path=vocab_path,
                        epoch=self.epoch, step=self.step,
                        best_val_acc=self.best_val_acc, opt_state=opt)

    def _local(self, name: str, value) -> torch.Tensor:
        """This rank's shard of a whole tensor of parameter ``name``."""
        t = torch.as_tensor(value)
        specs = getattr(self.model, "shard_specs", None)
        if not specs or self.mesh.model_size == 1:
            return t
        return P.local_shard(t, specs[name], self.mesh.model_index,
                             self.mesh.model_size)

    def load_weights(self, path) -> None:
        """Copy a recognizer file's tensors (any format of
        ``checkpoints.load_checkpoint``, read over this trainer's config)
        into the model, in place (this rank's shards over a mesh)."""
        sd, _, _ = read_checkpoint(path, self.cfg)
        load_state(self.model, {k: self._local(k, v) for k, v in sd.items()})

    def resume(self, path) -> bool:
        """Weights, counters, AdamW moments (where the file beside it holds
        every trained parameter's, at its shape) and the dropout generator
        of a checkpoint; False when ``path`` does not exist."""
        p = Path(path)
        if not p.exists():
            return False
        self.load_weights(p)
        meta = json.loads(Path(str(p)[: -len(".safetensors")]
                               + "_meta.json").read_text())
        self.epoch = int(meta.get("epoch", 0))
        self.step = int(meta.get("step", 0))
        self.best_val_acc = float(meta.get("best_val_acc", 0.0))
        saved = load_opt_state(p)
        if saved is None:
            return True
        state = {}
        for i, (name, prm) in enumerate(self.trained):
            keys = [f"{name}.{k}" for k in ("step", "exp_avg", "exp_avg_sq")]
            if not all(k in saved for k in keys):
                return True
            m1, m2 = (self._local(name, saved[k]) for k in keys[1:])
            if tuple(m1.shape) != tuple(prm.shape):
                return True
            state[i] = {"step": torch.tensor(float(saved[keys[0]])),
                        "exp_avg": m1, "exp_avg_sq": m2}
        sd = self.optimizer.state_dict()
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": sd["param_groups"]})
        self.gen.set_state(torch.from_numpy(saved["__generator__"]))
        return True


# ---------------------------------------------------------------------------
# High-level loop (the CLI's `train`)
# ---------------------------------------------------------------------------
def train_loop(cfg: CFG, tok: CharTokenizer, tc: TrainConfig,
               train_samples, val_samples, vocab_path: str = "",
               from_model: Optional[str] = None, verbose: bool = True,
               resume: bool = True, device=None) -> Trainer:
    """Train over sequences of {image u8 [H, W], text}; writes
    ``model_epoch_N``, ``latest`` (and ``model_step_N`` every
    ``save_steps``), ``model`` (the best by ``select_metric``) and
    ``history.json`` under ``tc.out_dir``."""
    # The OneCycle horizon is the plan's real step count: a throwaway plan.
    steps_per_epoch = max(1, len(width_bucket_plan(
        np.random.default_rng(tc.seed), train_samples, cfg, tc.batch_size)))
    total_steps = steps_per_epoch * tc.epochs
    trainer = Trainer(cfg, tok, tc, total_steps=total_steps, device=device)
    verbose = verbose and trainer.is_writer

    out = Path(tc.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    latest = out / "latest.safetensors"
    if from_model and Path(from_model).exists():
        trainer.load_weights(from_model)
        if verbose:
            print(f"🔥 Warm start from {from_model}")
    if resume and trainer.resume(latest) and verbose:
        print(f"▶ Resumed from {latest} (epoch {trainer.epoch}, step "
              f"{trainer.step})")

    rng = np.random.default_rng(tc.seed)
    n = len(train_samples)
    if verbose:
        print(f"📊 {n} train / {len(val_samples)} val samples; "
              f"{steps_per_epoch} steps/epoch x {tc.epochs} epochs")
        n_params = sum(p.numel() for p in trainer.model.parameters())
        print(f"🧮 {n_params / 1e6:.1f}M params")

    val_batches = []
    for i in range(0, len(val_samples), tc.batch_size):
        chunk = [val_samples[j] for j in
                 range(i, min(i + tc.batch_size, len(val_samples)))]
        vb = collate(chunk, tok, tc.max_seq_len, img_hw=(cfg.IMG_H, cfg.IMG_W))
        vb["text"] = [s["text"] for s in chunk]
        val_batches.append(vb)

    start_epoch = trainer.epoch
    for _ in range(start_epoch):   # the plans of the epochs already trained
        width_bucket_plan(rng, train_samples, cfg, tc.batch_size)
    for epoch in range(start_epoch, tc.epochs):
        trainer.epoch = epoch
        plan = width_bucket_plan(rng, train_samples, cfg, tc.batch_size)
        t0 = time.time()
        epoch_metrics: Dict[str, float] = {}
        n_steps = 0
        for bi, (idx, pad_w) in enumerate(plan):
            batch = collate([train_samples[int(i)] for i in idx], tok,
                            tc.max_seq_len, img_hw=(cfg.IMG_H, pad_w))
            m = trainer.run_step(batch)
            n_steps += 1
            for k, v in m.items():
                epoch_metrics[k] = epoch_metrics.get(k, 0.0) + v
            if verbose and tc.log_every and (bi + 1) % tc.log_every == 0:
                print(f"  e{epoch} s{bi + 1}/{len(plan)} "
                      f"loss={m['loss']:.4f} ctc={m.get('ctc_loss', 0):.4f} "
                      f"dec={m.get('dec_loss', 0):.4f}")
            if tc.save_steps and trainer.step % tc.save_steps == 0:
                trainer.save(out / f"model_step_{trainer.step}.safetensors",
                             vocab_path)
                trainer.save(latest, vocab_path)

        avg = {k: v / max(1, n_steps) for k, v in epoch_metrics.items()}
        row = {"epoch": epoch, **avg, "time_s": time.time() - t0}
        if val_batches and (epoch + 1) % tc.val_every == 0:
            acc = trainer.validate(val_batches, verbose=verbose)
            row["val_ctc_acc"] = acc
            if trainer.last_ar_acc is not None:
                row["val_ar_acc"] = trainer.last_ar_acc
            ar = trainer.last_ar_acc
            score = {"ctc": acc,
                     "ar": ar if ar is not None else acc,
                     "mean": (acc + ar) / 2 if ar is not None else acc,
                     }[tc.select_metric]
            if score > trainer.best_val_acc:
                trainer.best_val_acc = score
                trainer.save(out / "model.safetensors", vocab_path)
        trainer.history.append(row)
        if verbose:
            msg = f"Epoch {epoch}: loss={avg.get('loss', 0):.4f}"
            if "val_ctc_acc" in row:
                msg += f" val_acc={row['val_ctc_acc'] * 100:.2f}%"
            if "val_ar_acc" in row:
                msg += f" ar_acc={row['val_ar_acc'] * 100:.2f}%"
            print(msg + f" ({row['time_s']:.1f}s)")

        trainer.epoch = epoch + 1
        trainer.save(out / f"model_epoch_{epoch + 1}.safetensors", vocab_path)
        trainer.save(latest, vocab_path)
        if trainer.is_writer:
            (out / "history.json").write_text(json.dumps(trainer.history,
                                                         indent=2))
    return trainer
