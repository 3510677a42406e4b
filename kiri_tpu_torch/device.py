"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device with no card present raises:
    the port never carries on on the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matmuls in full float32 for the scope:
    cuDNN's and cuBLAS's TF32 flags off (PyTorch leaves cuDNN's on by
    default), both restored after."""
    b, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    before = mm.allow_tf32
    mm.allow_tf32 = False
    try:
        with b.flags(enabled=b.enabled, benchmark=b.benchmark,
                     deterministic=b.deterministic, allow_tf32=False):
            yield
    finally:
        mm.allow_tf32 = before
