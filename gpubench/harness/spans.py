"""The idle of a traced slice put to the program's own spans.

``trace.parse`` files each idle gap of the device under the innermost host
range open at its middle; the program's spans (``kiri_tpu_torch``'s
``utils/profiling.annotate``: ``engine.*``, ``decode.*``, ``detect.*`` and
the pipeline's stages) are such ranges. A program that records none of its
dotted spans (one older than them) gives nothing to read.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

#: The first word of every dotted span of the program.
PROGRAM = ("engine.", "decode.", "detect.")


def idle_share(rec: Dict, names: Tuple[str, ...] = (),
               prefixes: Tuple[str, ...] = ()) -> Optional[float]:
    """The slice's idle seconds under the spans ``names`` and under any
    span starting with one of ``prefixes``, in % of the slice's length;
    None where no slice was traced or the program has no spans."""
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    idle = tr["idle"]
    if not any(k.startswith(PROGRAM) for k in idle):
        return None
    s = sum(v for k, v in idle.items()
            if k in names or (prefixes and k.startswith(prefixes)))
    return 100.0 * s / tr["window_s"]
