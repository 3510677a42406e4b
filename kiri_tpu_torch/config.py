"""Model / inference configuration, a copy of ``kiri_tpu.config.CFG``.

Field names and defaults are those of the JAX package, so checkpoint metas
written by either package load unchanged. The JAX package tuned the bucket
and beam knobs on a TPU; here they are only carried, and are re-measured on
the GPU before any of them is claimed.

One difference from the JAX package: ``from_dict`` turns every tuple-typed
field into a tuple (the JAX package converts only three bucket fields), so a
``BEAM_STEP_BUCKETS`` list read back from a saved meta leaves the frozen
``CFG`` hashable.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional


@dataclass(frozen=True)
class CFG:
    """Frozen (hashable); use ``cfg.replace(...)`` to derive variants."""

    # --- Model architecture ---
    IMG_H: int = 48
    IMG_W: int = 640
    MAX_DEC_LEN: int = 512
    UNK_TOKEN: str = "<unk>"
    COLLAPSE_WHITESPACE: bool = True
    UNICODE_NFC: bool = True
    # The model's token space is visual-order Khmer (pre-base vowels before
    # their base); the tokenizer reorders to logical Unicode at its boundary
    # (data/khmer_order.py).
    KHMER_VISUAL_ORDER: bool = False

    ENC_DIM: int = 256
    ENC_LAYERS: int = 4
    ENC_HEADS: int = 8
    ENC_FF: int = 1024
    DROPOUT: float = 0.15

    USE_DECODER: bool = True
    DEC_DIM: int = 256
    DEC_LAYERS: int = 3
    DEC_HEADS: int = 8
    DEC_FF: int = 1024

    USE_CTC: bool = True
    USE_LM: bool = True
    USE_LM_FUSION_EVAL: bool = True
    LM_FUSION_ALPHA: float = 0.35
    USE_FP16: bool = True
    USE_AUTOCAST: bool = True

    # --- Inference params ---
    CTC_FUSION_ALPHA: float = 0.5
    BEAM: int = 3
    BEAM_LENP: float = 0.8
    BEAM_UNROLL: int = 1
    BEAM_CHUNK: int = 16
    BEAM_STEP_BUCKETS: tuple = (16, 24, 32, 48, 64, 96, 128, 256, 512)

    EOS_LOGP_BIAS: float = 0.0
    EOS_LOGP_BOOST: float = 0.0
    EOS_BIAS_UNTIL_LEN: int = 2

    REPEAT_LAST_PENALTY: float = 3.0
    REPEAT_BIGRAM_PENALTY: float = 2.5
    REPEAT_TRIGRAM_PENALTY: float = 2.0
    UNK_LOGP_PENALTY: float = 10.0

    DEC_MAX_LEN_RATIO: float = 1.3
    DEC_MAX_LEN_PAD: int = 10
    MEM_MAX_LEN_RATIO: float = 1.0

    # Compute dtype of the forward paths ("bfloat16" or "float32").
    COMPUTE_DTYPE: str = "bfloat16"
    # Batch sizes are padded up to one of these buckets.
    BATCH_BUCKETS: tuple = (1, 2, 4, 8, 16, 32, 64, 128)
    STEP_BUCKETS: tuple = (32, 64, 128, 256, 512)
    # Width buckets for line images: a line is encoded at the smallest
    # bucket that holds its content width (IMG_W is always a bucket).
    WIDTH_BUCKETS: tuple = (160, 320, 480, 640)
    AUTO_CONF_THRESHOLD: float = 0.95
    SPEC_DECODE: bool = True
    SPEC_MAX_ROUNDS: int = 8
    ACCURATE_CTC_RESCORE: bool = True
    SPEC_BEAM: bool = False
    STREAM_WINDOW: int = 16

    def replace(self, **kw) -> "CFG":
        return dataclasses.replace(self, **kw)

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(self).items()}

    @classmethod
    def from_dict(cls, data: Optional[Dict[str, Any]]) -> "CFG":
        """Build a CFG from a (possibly partial) dict; unknown keys are
        ignored, and every tuple-typed field comes back as a tuple."""
        tuple_fields = {f.name for f in dataclasses.fields(cls)
                        if isinstance(f.default, tuple)}
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: tuple(v) if k in tuple_fields else v
              for k, v in (data or {}).items() if k in names}
        return cls(**kw)

    def save_json(self, path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load_json(cls, path) -> "CFG":
        return cls.from_dict(json.loads(Path(path).read_text()))
