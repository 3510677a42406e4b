"""Hand-written CUDA kernels of the port, each beside its plain torch version.

Each wrapper counts its kernel launches in a ``launches`` attribute, so a run
can show that the main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from .quant8 import q8_conv3x3, q8_linear, q8_stem01
from .resize import preprocess_lines
from .stem import stem_fused, stem_fused_f32

WRAPPERS = {"preprocess_lines": preprocess_lines, "stem_fused": stem_fused,
            "stem_fused_f32": stem_fused_f32, "q8_stem01": q8_stem01,
            "q8_conv3x3": q8_conv3x3, "q8_linear": q8_linear}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
