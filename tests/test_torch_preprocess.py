"""kiri_tpu_torch's line preprocessing (plain version and the CPU dispatch
of the kernel wrapper) and host helpers against kiri_tpu's."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.kernels import resize as JR
from kiri_tpu.ops import decode as JD
from kiri_tpu.ops import preprocess as JP
from kiri_tpu_torch.config import CFG
from kiri_tpu_torch.kernels.resize import (pack_crops, preprocess_lines,
                                           preprocess_lines_plain)
from kiri_tpu_torch.ops import preprocess as P


@pytest.fixture()
def crops():
    """The crops of tests/test_kernels.py plus a dark crop, a small crop
    (cubic upscale on both axes) and a wide one whose width clips."""
    rng = np.random.default_rng(0)
    shapes = [(30, 200), (60, 90), (48, 640), (20, 500), (100, 40)]
    out = [rng.integers(0, 255, s, np.uint8) for s in shapes]
    out.append(rng.integers(0, 60, (40, 100), np.uint8))     # dark
    out.append(rng.integers(0, 255, (12, 7), np.uint8))      # tiny upscale
    out.append(rng.integers(0, 255, (32, 1100), np.uint8))   # clips at 640
    return out


def test_pack_crops_matches_kiri_tpu(crops):
    buf, sizes = pack_crops(crops)
    jbuf, jsizes = JR.pack_crops(crops)
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(sizes, jsizes)


@pytest.mark.parametrize("out_w", [160, 640])
@pytest.mark.parametrize("linear", [False, True])
def test_plain_matches_ref_and_pallas(crops, out_w, linear):
    buf, sizes = pack_crops(crops)
    lin = np.zeros(len(crops), bool)
    if linear:
        lin[::2] = True
    sizes3 = np.concatenate([sizes, lin[:, None].astype(np.int32)], axis=1)
    got = preprocess_lines(torch.from_numpy(buf), torch.from_numpy(sizes3),
                           48, out_w).numpy()
    np.testing.assert_array_equal(got, preprocess_lines_plain(
        torch.from_numpy(buf), torch.from_numpy(sizes3), 48, out_w).numpy())
    ref = np.asarray(JR.preprocess_lines_ref(
        jnp.asarray(buf), jnp.asarray(sizes), 48, out_w,
        linear_mask=jnp.asarray(lin)))
    np.testing.assert_allclose(got, ref, atol=2e-3)
    pallas = np.asarray(JR.preprocess_lines_tpu(
        jnp.asarray(buf), jnp.asarray(sizes), 48, out_w, interpret=True,
        linear_mask=jnp.asarray(lin)))
    np.testing.assert_allclose(got, pallas, atol=2e-3)
    # The dark crop was inverted; the wide crop has no pad columns at 640.
    assert got[5][:, :10].mean() > 0.4
    if out_w == 640:
        assert not np.any(got[7] == np.float32((128 / 255 - 0.5) / 0.5))


def test_host_helpers_match_kiri_tpu():
    cfg, jcfg = CFG(), JCFG()
    for shape in [(48, 640), (30, 200), (100, 40), (20, 5000), (0, 10)]:
        assert P.content_width(shape, 48, 640) == JP.content_width(
            shape, 48, 640)
    assert P.width_buckets(cfg) == JP.width_buckets(jcfg)
    for w in [1, 159, 160, 161, 479, 640, 700]:
        assert P.pick_width_bucket(cfg, w) == JP.pick_width_bucket(jcfg, w)
    for n in [1, 3, 64, 65, 128, 129, 300]:
        assert P.pick_batch_bucket(cfg, n) == JD.pick_batch_bucket(jcfg, n)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_normalize_u8_matches_kiri_tpu(dtype, jdtype):
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    got = P.normalize_u8(torch.from_numpy(x), dtype)
    assert got.dtype == dtype and got.shape == x.shape
    want = np.asarray(JP.normalize_u8(jnp.asarray(x), jdtype), np.float32)
    np.testing.assert_array_equal(got.float().numpy(), want[:, 0])


def _edge_crops():
    """Crops of one row, one column, one pixel and two pixels a side, taller
    than 256 px (one also wider than the CUDA kernel's 3072-column strip),
    bright and dark."""
    rng = np.random.default_rng(7)
    shapes = [(1, 200), (40, 1), (1, 1), (2, 2), (300, 500), (400, 30),
              (257, 3100)]
    out = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    return out + [np.ascontiguousarray(c // 3) for c in out]


@pytest.mark.parametrize("out_hw", [(48, 640), (20, 50)])
@pytest.mark.parametrize("linear", [False, True])
def test_edge_shapes_match_ref(out_hw, linear):
    """h or w of 1, crops taller than 256 px: the port's plain version (and
    the wrapper's CPU dispatch) against ``preprocess_lines_ref`` within
    2e-3 normalized units (~0.26 of a u8 grey level; summation order)."""
    crops = _edge_crops()
    buf, sizes = pack_crops(crops)
    lin = np.full(len(crops), linear)
    sizes3 = np.concatenate([sizes, lin[:, None].astype(np.int32)], axis=1)
    got = preprocess_lines(torch.from_numpy(buf), torch.from_numpy(sizes3),
                           *out_hw).numpy()
    assert got.shape == (len(crops),) + out_hw and np.isfinite(got).all()
    ref = np.asarray(JR.preprocess_lines_ref(
        jnp.asarray(buf), jnp.asarray(sizes), *out_hw,
        linear_mask=jnp.asarray(lin)))
    np.testing.assert_allclose(got, ref, atol=2e-3)
    # A 1 x 1 crop fills its nw = out_h columns with its own (inverted when
    # dark) value and pads the rest with 128.
    pad = (128 / 255 - 0.5) / 0.5
    for i in (2, 9):
        v = float(crops[i][0, 0])
        v = 255.0 - v if v < 127 else v
        np.testing.assert_allclose(got[i][:, : out_hw[0]],
                                   (v / 255 - 0.5) / 0.5, atol=2e-3)
        np.testing.assert_allclose(got[i][:, out_hw[0]:], pad, atol=1e-6)


def test_wrapper_checks_its_arguments_on_the_cpu_too():
    """The CPU dispatch takes what the plain version takes; padded lines of
    size (1, 1), as ``recognize_crops`` pads a batch, come out as lines."""
    buf = torch.zeros((2, 8, 8), dtype=torch.uint8)
    sizes = torch.ones((2, 3), dtype=torch.int32)
    out = preprocess_lines(buf, sizes, 48, 640)
    assert out.shape == (2, 48, 640) and bool(out.isfinite().all())
    # A dark 1 x 1 crop is inverted to white: 48 columns of 1.0, then pad.
    assert bool((out[:, :, :48] == 1.0).all())
