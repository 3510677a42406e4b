"""The port's entry points (``kiri_tpu_torch/entry.py``, the counterpart of
``__graft_entry__.py``): ``entry()``'s flagship forward on the CPU, and
``dryrun_multichip`` over gloo ranks it starts itself (model axis 2 where
the rank count is even), and in place at one device."""
from __future__ import annotations

import numpy as np
import torch

from kiri_tpu_torch.entry import dryrun_multichip, entry


def test_entry_forward_on_the_cpu():
    fn, (model, images) = entry(device="cpu")
    assert images.shape == (8, 48, 640) and images.dtype == np.uint8
    ctc, memp = fn(model, images)
    assert tuple(ctc.shape[:2]) == (8, 160) and ctc.dtype == torch.float32
    assert tuple(memp.shape) == (8, 160, 256)
    assert bool(ctc.isfinite().all()) and bool(memp.float().isfinite().all())
    # The same weights and lines give the same answer (seeded).
    ctc2, _ = entry(device="cpu")[0](model, images)
    torch.testing.assert_close(ctc, ctc2, rtol=0, atol=0)


def test_dryrun_multichip_over_two_gloo_ranks(capsys):
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): mesh={'data': 1, 'model': 2}" in out
    assert "infer=4 rows OK" in out


def test_dryrun_multichip_on_one_device(capsys):
    dryrun_multichip(1, device="cpu")
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
