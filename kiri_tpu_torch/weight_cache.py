"""Tensors derived from a module's parameters (folded, fused or cast to the
compute dtype), built once per (dtype, device) and not once per call."""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch


class WeightCache:
    """What ``build()`` made of ``tensors``, per (dtype, device), rebuilt
    when one of the tensors was written in place (``load_state_dict``) or
    replaced (``.to()``).

    A tensor made under ``torch.inference_mode`` carries no version counter:
    an in-place write to one, which torch allows only inside inference mode,
    goes unseen. Replace such a tensor (``param.data = new``) instead of
    writing into it."""

    def __init__(self) -> None:
        self._entries: Dict[Tuple[torch.dtype, torch.device],
                            Tuple[tuple, Any]] = {}

    def lookup(self, tensors: Sequence[torch.Tensor], dtype: torch.dtype,
               build: Callable[[], Any]) -> Any:
        state = tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                      for t in tensors)
        key = (dtype, tensors[0].device)
        hit = self._entries.get(key)
        if hit is None or hit[0] != state:
            with torch.no_grad():
                hit = (state, build())
            self._entries[key] = hit
        return hit[1]
