"""The recognizer as an ``nn.Module``: CNN stem + Transformer encoder + CTC
head + Transformer decoder with its two output heads (the port of
``kiri_tpu/models/recognizer.py``).

Submodule and parameter names are the checkpoint's own torch names
(``stem.net.{0..11}``, ``enc.layers.i.*``, ``ctc_head.{0,2}``, ``mem_proj``,
``dec_emb``, ``dec.layers.i.*``, ``dec_ln``, ``dec_head``, ``lm_head``,
``dec_pos_enc.pe``), so ``load_state_dict(strict=True)`` takes a committed
``.safetensors`` file as it is. The forward math is the functions of
``layers.py`` over these parameters; the stem goes through
``kernels.stem.stem_fused`` on weights folded once (``Stem.folded``), and the
decoder runs on ``Recognizer.decoder_weights``: its matrices cast to the
compute dtype and the two output heads fused, once per (dtype, device).

Training (``train=True`` of ``encode``, and ``decoder_train_logits``) is a
separate forward that autograd can follow: the stem is not BN-folded (a conv
in the compute dtype, BatchNorm over the batch in float32, SiLU, then
Dropout2d), every parameter is cast on each call, and dropout draws from an
explicit ``torch.Generator`` at the rate the caller passes (the trainer's
``cfg.DROPOUT``). The flag is an argument, not ``module.training``: an
engine that validates the model under training calls ``.eval()`` on it.

Under a mesh (``kiri_tpu_torch.parallel.shard_variables``) the attentions,
FFNs and vocabulary heads hold this rank's shards and carry the mesh; the
heads' logits are gathered whole on every rank. The training stem's
BatchNorm statistics are then those of the global batch: each rank's sums
(of the values, then of the squared deviations from the global mean) are
added over the data axis, as ``kiri_tpu``'s jitted mean over a sharded
batch is.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.stem import (BN_EPS, STRIDES, FoldedStem, StemWeightCache,
                            stem_fused)
from ..ops.preprocess import normalize_u8
from ..weight_cache import WeightCache
from . import layers as L

STEM_CHANNELS = (48, 96, 160)   # the last block goes to ENC_DIM
BN_MOMENTUM = 0.1


class Stem(nn.Module):
    def __init__(self, enc_dim: int):
        super().__init__()
        chans = (1,) + STEM_CHANNELS + (enc_dim,)
        mods = []
        for i, stride in enumerate(STRIDES):
            mods += [nn.Conv2d(chans[i], chans[i + 1], 3, stride, 1,
                               bias=False),
                     nn.BatchNorm2d(chans[i + 1]), nn.SiLU()]
        self.net = nn.Sequential(*mods)
        self._folded = StemWeightCache()

    def folded(self, dtype: torch.dtype) -> FoldedStem:
        """The BN-folded weights for ``dtype`` on the parameters' device,
        folded once and again only after the parameters or buffers change."""
        return self._folded.get(self.net, dtype)

    def train_forward(self, x: torch.Tensor, drop: float,
                      gen: Optional[torch.Generator], mesh=None):
        """The training stem: x [B, H, W] in the compute dtype -> (NHWC
        [B, H/8, W/4, D], the four BatchNorms' new running (mean, var)).
        Each conv runs in x's dtype; BatchNorm normalizes by the batch's
        statistics in float32 (the global batch's over ``mesh``'s data
        axis, each rank holding as many rows); the running statistics take
        momentum 0.1 and the unbiased variance; Dropout2d drops whole
        channels at the end."""
        from ..parallel import data_sum

        h = x.unsqueeze(1)
        stats = []
        dp = 1 if mesh is None else mesh.data_size
        for i, stride in enumerate(STRIDES):
            conv, bn = self.net[3 * i], self.net[3 * i + 1]
            h = F.conv2d(h, conv.weight.to(h.dtype), stride=stride, padding=1)
            hf = L.wide(h)
            n = h.shape[0] * h.shape[2] * h.shape[3] * dp
            mean = data_sum(hf.sum(dim=(0, 2, 3)), mesh) / n
            var = data_sum(((hf - mean[:, None, None]) ** 2).sum(
                dim=(0, 2, 3)), mesh) / n
            inv = torch.rsqrt(var + BN_EPS) * bn.weight
            y = ((hf - mean[:, None, None]) * inv[:, None, None]
                 + bn.bias[:, None, None])
            h = F.silu(y.to(h.dtype))
            with torch.no_grad():
                stats.append((
                    (1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean,
                    (1 - BN_MOMENTUM) * bn.running_var
                    + BN_MOMENTUM * var * n / max(n - 1, 1)))
        h = L.dropout(h, drop, gen, (h.shape[0], h.shape[1], 1, 1))
        return h.permute(0, 2, 3, 1), stats

    @torch.no_grad()
    def set_running_stats(self, stats) -> None:
        """Write ``train_forward``'s new running statistics (in place, so
        the folded weights are made again)."""
        for i, (mean, var) in enumerate(stats):
            bn = self.net[3 * i + 1]
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)


class Attention(nn.Module):
    """Parameters of ``nn.MultiheadAttention`` (fused q/k/v projection).
    ``tp``: the mesh, where the projections are this rank's heads."""

    tp = None

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


class EncoderLayer(nn.Module):
    tp_ffn = None   # the mesh, where linear1 / linear2 are shards

    def __init__(self, dim: int, ff: int):
        super().__init__()
        self.self_attn = Attention(dim)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)


class DecoderLayer(nn.Module):
    tp_ffn = None

    def __init__(self, dim: int, ff: int):
        super().__init__()
        self.self_attn = Attention(dim)
        self.multihead_attn = Attention(dim)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)


class Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class PositionTable(nn.Module):
    def __init__(self, length: int, dim: int):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(L.sinusoid_table(length, dim))[None])


def _cast_tree(module: nn.Module, dtype: torch.dtype) -> SimpleNamespace:
    """A module's parameters under their own names, cast to ``dtype``: the
    matrices, and the biases that ``layers.dense`` then adds inside its
    matmul. LayerNorm's parameters stay float32, the type it runs in. A
    module's mesh (``tp``, ``tp_ffn``) comes along."""
    out = SimpleNamespace()
    keep = isinstance(module, nn.LayerNorm)
    for key in ("tp", "tp_ffn"):
        if getattr(module, key, None) is not None:
            setattr(out, key, getattr(module, key))
    for name, p in module.named_parameters(recurse=False):
        setattr(out, name, p.detach() if keep else p.detach().to(dtype))
    for name, child in module.named_children():
        setattr(out, name, _cast_tree(child, dtype))
    return out


class DecoderWeights(SimpleNamespace):
    """What the decoder runs on, made by ``Recognizer.decoder_weights``:
    ``emb`` [V, D] and ``pe`` [MAX_DEC_LEN + 10, D] (or None) in the compute
    dtype, ``layers`` (``_cast_tree`` of each decoder layer), ``dec_ln``, and
    the output heads as one linear ``head_w`` [V or 2V, D], ``head_b``: the
    decoder head's rows first, then the LM head's where the model has one
    and ``cfg.USE_LM`` is set (under a mesh, this rank's rows of each, and
    ``tp`` the mesh); ``vocab`` is V."""


@functools.lru_cache(maxsize=16)
def _pos_enc_2d(h: int, w: int, c: int) -> torch.Tensor:
    return torch.from_numpy(L.pos_enc_2d(h, w, c))


class Recognizer(nn.Module):
    """``vocab_size`` counts the tokenizer's characters (with <unk>): the
    CTC head has vocab_size + 2 classes and the decoder vocab_size + 3.
    ``ctc_head`` and ``lm_head`` (None: ``cfg.USE_CTC``, ``cfg.USE_LM``)
    say whether the model holds those heads; the LM head is used only
    where it exists and ``cfg.USE_LM`` is set."""

    def __init__(self, cfg, vocab_size: int, use_dec_pos_enc: bool = True,
                 ctc_head: Optional[bool] = None,
                 lm_head: Optional[bool] = None):
        super().__init__()
        d, dd = cfg.ENC_DIM, cfg.DEC_DIM
        self.enc_heads = cfg.ENC_HEADS
        self.dec_heads = cfg.DEC_HEADS
        self.use_lm = bool(cfg.USE_LM)
        self.max_dec_len = cfg.MAX_DEC_LEN
        self._decoder_weights = WeightCache()
        self.stem = Stem(d)
        self.enc_ln_in = nn.LayerNorm(d)
        self.enc = Stack(EncoderLayer(d, cfg.ENC_FF)
                         for _ in range(cfg.ENC_LAYERS))
        self.enc_ln = nn.LayerNorm(d)
        if cfg.USE_CTC if ctc_head is None else ctc_head:
            # Index 1 is the training-time Dropout, which holds no weights.
            self.ctc_head = nn.Sequential(nn.LayerNorm(d),
                                          nn.Dropout(cfg.DROPOUT),
                                          nn.Linear(d, vocab_size + 2))
        self.mem_proj = nn.Linear(d, dd, bias=False)
        self.dec_emb = nn.Embedding(vocab_size + 3, dd)
        if use_dec_pos_enc:
            self.dec_pos_enc = PositionTable(cfg.MAX_DEC_LEN + 10, dd)
        self.dec = Stack(DecoderLayer(dd, cfg.DEC_FF)
                         for _ in range(cfg.DEC_LAYERS))
        self.dec_ln = nn.LayerNorm(dd)
        self.dec_head = nn.Linear(dd, vocab_size + 3)
        if cfg.USE_LM if lm_head is None else lm_head:
            self.lm_head = nn.Linear(dd, vocab_size + 3)

    def encode(self, images: torch.Tensor, dtype: torch.dtype,
               train: bool = False, drop: float = 0.0,
               gen: Optional[torch.Generator] = None, mesh=None):
        """u8 [B, H, W] (or [B, 1, H, W]), or lines already normalized to
        [-1, 1], -> encoder memory [B, W/4, D] in ``dtype``: stem -> 2D
        position table -> mean over height -> LN -> encoder -> LN.

        ``train=True`` runs the training forward (``Stem.train_forward``,
        dropout at rate ``drop`` drawn from ``gen``) and returns (memory, the
        stem's new running statistics, of the global batch over ``mesh``'s
        data axis); otherwise the stem is ``stem_fused`` on the folded
        weights."""
        if images.dim() == 4:
            images = images[:, 0]
        x = (normalize_u8(images, dtype) if images.dtype == torch.uint8
             else images.to(dtype))
        if train:
            feat, stats = self.stem.train_forward(x, drop, gen, mesh)
        elif drop:
            raise ValueError("dropout belongs to the training forward "
                             "(train=True)")
        else:
            feat = stem_fused(x, self.stem.folded(dtype))
        _, h, w, c = feat.shape
        feat = feat + _pos_enc_2d(h, w, c).to(feat.device, dtype)
        seq = feat.mean(dim=1)
        seq = L.layer_norm(seq, self.enc_ln_in.weight, self.enc_ln_in.bias)
        for layer in self.enc.layers:
            seq = L.encoder_layer(layer, seq, self.enc_heads, drop, gen)
        mem = L.layer_norm(seq, self.enc_ln.weight, self.enc_ln.bias)
        return (mem, stats) if train else mem

    def ctc_logits(self, mem: torch.Tensor, drop: float = 0.0,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """CTC head (LN -> Dropout at rate ``drop`` -> Linear), float32
        logits [B, T, C] (float64 in a float64 run)."""
        ln, proj = self.ctc_head[0], self.ctc_head[2]
        h = L.layer_norm(mem, ln.weight, ln.bias)
        h = L.dropout(h, drop, gen)
        return L.wide(_vocab_head(h, proj.weight, proj.bias,
                                  getattr(proj, "tp", None)))

    def mem_project(self, mem: torch.Tensor) -> torch.Tensor:
        return L.dense(mem, self.mem_proj.weight)

    def decoder_train_logits(self, mem_proj: torch.Tensor,
                             tgt_ids: torch.Tensor, drop: float = 0.0,
                             gen: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
        """Teacher-forced decoder logits for training: tgt_ids [B, L]
        (bos-shifted inputs) over mem_proj [B, T, D] in the compute dtype ->
        float32 dec_head logits [B, L, V]. Causal mask, no key-padding mask;
        dropout at rate ``drop`` after the embedding and inside every
        layer."""
        dtype = mem_proj.dtype
        lt = tgt_ids.shape[1]
        x = self.dec_emb.weight.to(dtype)[tgt_ids.long()]
        if hasattr(self, "dec_pos_enc"):
            x = x + self.dec_pos_enc.pe[0, :lt].to(dtype)
        x = L.dropout(x, drop, gen)
        causal = torch.ones((lt, lt), dtype=torch.bool,
                            device=x.device).triu(1)
        for layer in self.dec.layers:
            x = L.decoder_layer(layer, x, mem_proj, self.dec_heads, causal,
                                drop, gen)
        x = L.layer_norm(x, self.dec_ln.weight, self.dec_ln.bias)
        return L.wide(_vocab_head(x, self.dec_head.weight, self.dec_head.bias,
                                  getattr(self.dec_head, "tp", None)))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> "Recognizer":
        """From-scratch weights with the JAX package's distributions: convs
        and linears (the attention projections too) uniform in +-1 /
        sqrt(fan in), biases likewise, the embedding standard normal, norms
        at 1 and 0, running statistics at 0 and 1. ``gen`` is a CPU
        generator."""
        def uniform(t: torch.Tensor, fan_in: int) -> None:
            bound = fan_in ** -0.5
            t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                uniform(m.weight, m.in_features)
                if m.bias is not None:
                    uniform(m.bias, m.in_features)
            elif isinstance(m, Attention):
                uniform(m.in_proj_weight, m.in_proj_weight.shape[1])
                uniform(m.in_proj_bias, m.in_proj_weight.shape[1])
            elif isinstance(m, nn.Conv2d):
                uniform(m.weight, m.weight[0].numel())
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen))
        return self

    # ----------------------------------------------------------- decoder
    def decoder_weights(self, dtype: torch.dtype) -> DecoderWeights:
        """The decoder's weights for ``dtype`` on the parameters' device,
        built once and again only after a parameter changes."""
        mods = [self.dec_emb, self.dec, self.dec_ln, self.dec_head]
        has_lm = self.use_lm and hasattr(self, "lm_head")
        if has_lm:
            mods.append(self.lm_head)
        tensors = [p for m in mods for p in m.parameters()]

        def build() -> DecoderWeights:
            heads = [self.dec_head] + ([self.lm_head] if has_lm else [])
            tp = getattr(self.dec_head, "tp", None)
            pe = None
            if hasattr(self, "dec_pos_enc"):
                pe = torch.from_numpy(L.sinusoid_table(
                    self.max_dec_len + 10, self.dec_emb.weight.shape[1])
                ).to(tensors[0].device, dtype)
            return DecoderWeights(
                emb=self.dec_emb.weight.detach().to(dtype), pe=pe,
                layers=[_cast_tree(m, dtype) for m in self.dec.layers],
                dec_ln=self.dec_ln,
                head_w=torch.cat([h.weight.detach() for h in heads]).to(dtype),
                head_b=torch.cat([h.bias.detach() for h in heads]).to(dtype),
                vocab=self.dec_head.weight.shape[0] * (
                    1 if tp is None else tp.model_size),
                has_lm=has_lm, tp=tp)
        return self._decoder_weights.lookup(tensors, dtype, build)

    def _heads(self, w: DecoderWeights, x: torch.Tensor
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """dec_ln -> fused output heads: float32 (dec_logits, lm_logits or
        None) over the last axis of x."""
        x = L.layer_norm(x, w.dec_ln.weight, w.dec_ln.bias)
        both = _vocab_head(x, w.head_w, w.head_b, w.tp,
                           2 if w.has_lm else 1).float()
        if w.has_lm:
            return both[..., :w.vocab], both[..., w.vocab:]
        return both, None

    def decoder_forward_heads(self, mem_proj: torch.Tensor,
                              tgt_ids: torch.Tensor
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One teacher-forced pass over whole sequences, both output heads.

        mem_proj [B, T, D] in the compute dtype, tgt_ids [B, L] decoder ids
        (bos first) -> (dec_logits [B, L, V], lm_logits [B, L, V] or None),
        float32: the next-token logits at every position.
        """
        dtype = mem_proj.dtype
        w = self.decoder_weights(dtype)
        lt = tgt_ids.shape[1]
        x = w.emb[tgt_ids.long()]
        if w.pe is not None:
            x = x + w.pe[:lt]
        causal = torch.ones((lt, lt), dtype=torch.bool,
                            device=x.device).triu(1)
        for layer in w.layers:
            x = L.decoder_layer(layer, x, mem_proj, self.dec_heads, causal)
        return self._heads(w, x)

    def decode_prepare(self, mem_proj: torch.Tensor
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each decoder layer's cross-attention K/V of the memory, computed
        once per line before the step loop."""
        w = self.decoder_weights(mem_proj.dtype)
        return [L.precompute_cross_kv(layer, mem_proj, self.dec_heads)
                for layer in w.layers]

    def init_decode_cache(self, batch: int, max_len: int, dtype: torch.dtype
                          ) -> torch.Tensor:
        d = self.dec_emb.weight.shape[1]
        hd = d // self.dec_heads
        layers = self.dec.layers
        heads = (layers[0].self_attn.in_proj_weight.shape[0] // 3 // hd
                 if len(layers) else self.dec_heads)   # this rank's heads
        return L.init_self_cache(len(self.dec.layers), batch, max_len, heads,
                                 hd, dtype, self.dec_emb.weight.device)

    def decoder_step(self, tok_ids: torch.Tensor, pos: int,
                     cache: torch.Tensor, cross_kvs
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One autoregressive step: tok_ids [B] at position ``pos`` (the
        host's step counter) -> float32 (dec_logits [B, V], lm_logits [B, V]
        or None). ``cache`` (``init_decode_cache``) is written in place at
        ``pos``; ``cross_kvs`` is ``decode_prepare``'s, of B rows or of B / K
        rows shared by the K consecutive beams of each line."""
        w = self.decoder_weights(cache.dtype)
        x = w.emb[tok_ids.long()][:, None]
        if w.pe is not None:
            x = x + w.pe[pos]
        for i, layer in enumerate(w.layers):
            ck, cv = cross_kvs[i]
            x = L.decoder_step_layer(layer, x, i, cache, pos, ck, cv,
                                     self.dec_heads)
        return self._heads(w, x[:, 0])


_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _vocab_head(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, tp=None, parts: int = 1) -> torch.Tensor:
    """``dense`` of an output head; with ``tp`` the head holds this rank's
    vocabulary rows (of each of ``parts`` fused heads) and the logits are
    gathered whole."""
    if tp is None:
        return L.dense(x, weight, bias)
    from ..parallel import copy_to_model, gather_from_model

    return gather_from_model(L.dense(copy_to_model(x, tp), weight, bias), tp,
                             parts)


def num_params(model: nn.Module) -> int:
    """Trainable values: what ``kiri_tpu`` counts as the leaves of
    ``variables["params"]`` (BatchNorm statistics and the decoder's
    position table, which are buffers, left out)."""
    return sum(p.numel() for p in model.parameters())


class KiriOCR:
    """Object facade over ``Recognizer`` for users of the reference's model
    class (``KiriOCR(cfg, tok)`` with ``.encode(images)``), as in
    ``kiri_tpu``. ``variables`` takes ``kiri_tpu``'s parameters as numpy
    (``{"params", "batch_stats"}``) and carries them across; without it the
    model starts from ``Recognizer.init_weights`` on a ``torch.Generator``
    seeded with ``seed``, whose values differ from ``kiri_tpu``'s JAX
    initializer. ``device=None`` means the card."""

    def __init__(self, cfg, tok, use_dec_pos_enc: bool = True,
                 variables=None, seed: int = 0, device=None):
        from ..checkpoints import build_model
        from ..convert import state_dict_from_jax
        from ..device import resolve_device

        self.cfg = cfg
        self.tok = tok
        self.use_dec_pos_enc = use_dec_pos_enc
        self.device = resolve_device(device)
        if variables is not None:
            model = build_model(state_dict_from_jax(
                variables, cfg.MAX_DEC_LEN, use_dec_pos_enc), cfg)
        else:
            model = Recognizer(cfg, tok.vocab_size, use_dec_pos_enc
                               ).init_weights(torch.Generator().manual_seed(
                                   seed))
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, path: str, cfg=None,
                        vocab_path: Optional[str] = None,
                        device=None) -> "KiriOCR":
        """Weights and config from a recognizer file in any format that
        ``checkpoints.load_checkpoint`` reads, the vocab from
        ``vocab_path`` or beside the file."""
        from ..checkpoints import find_vocab_file, load_checkpoint
        from ..tokenizer import CharTokenizer

        model, cfg, meta = load_checkpoint(path, cfg, device)
        vp = vocab_path or find_vocab_file(meta.get("vocab_path", ""), path)
        if not vp:
            raise FileNotFoundError(f"No vocab file found near {path}")
        self = cls.__new__(cls)
        self.cfg, self.tok = cfg, CharTokenizer(vp, cfg)
        self.use_dec_pos_enc = hasattr(model, "dec_pos_enc")
        self.device = next(model.parameters()).device
        self.model = model.eval()
        return self

    @torch.inference_mode()
    def encode(self, images_u8) -> torch.Tensor:
        """u8 [B, H, W] (numpy or torch) -> encoder memory [B, T, D] in the
        config's compute dtype, through the stem kernels."""
        x = torch.as_tensor(images_u8).to(self.device)
        return self.model.encode(x, _COMPUTE_DTYPES[self.cfg.COMPUTE_DTYPE])

    @torch.inference_mode()
    def ctc_logits(self, mem: torch.Tensor) -> torch.Tensor:
        return self.model.ctc_logits(mem)

    @torch.inference_mode()
    def mem_project(self, mem: torch.Tensor) -> torch.Tensor:
        return self.model.mem_project(mem)

    def num_params(self) -> int:
        return num_params(self.model)
