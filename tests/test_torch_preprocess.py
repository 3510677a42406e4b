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
