"""The pieces of kiri_tpu_torch's bf16 tensor-core stem that run on the CPU:
the packed weight layout, the tile plan (of the float32 kernel too), the fused conv0 -> conv1 tile with
its edge zeroing (emulated in plain torch, tile by tile, as the CUDA kernel
computes it), and the folded-weight cache of ``Recognizer.encode``."""
from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kiri_tpu.models import recognizer as R
from kiri_tpu.train.checkpoints import load_checkpoint as j_load
from kiri_tpu_torch.checkpoints import load_checkpoint
from kiri_tpu_torch.kernels.stem import (F32_TILES, MMA_CHANNELS,
                                         MMA_TILES, STRIDES,
                                         fold_stem_weights,
                                         pack_stem_weights, stem_mma_layer,
                                         tile_plan, unpack_stem_weights)
from kiri_tpu_torch.models.recognizer import Stem
from kiri_tpu_torch.smoke import load_smoke_lines

REPO = Path(__file__).resolve().parent.parent
WIDTHS = (160, 320, 480, 640)      # the width buckets
RAGGED = (52, 636)                 # no multiple of any tile


def _random_stem(seed: int) -> Stem:
    """A Stem (ENC_DIM 256) with seeded numpy weights and BN statistics."""
    rng = np.random.default_rng(seed)
    stem = Stem(MMA_CHANNELS[-1]).eval()
    sd = {}
    for k, v in stem.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(
                (np.abs(rng.normal(0, 1, v.shape)) + 0.5).astype(np.float32))
        elif v.dim() == 4:
            fan_in = v.shape[1] * 9
            sd[k] = torch.from_numpy(rng.normal(
                0, (2.0 / fan_in) ** 0.5, v.shape).astype(np.float32))
        elif k.endswith(".weight"):
            sd[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(
                rng.normal(0, 0.3, v.shape).astype(np.float32))
    stem.load_state_dict(sd, strict=True)
    return stem


@pytest.fixture(scope="module")
def stem():
    return _random_stem(0)


# ------------------------------------------------------------- (a) packing
@pytest.mark.parametrize("layer", [1, 2, 3])
def test_pack_unpack_is_bit_exact(stem, layer):
    """Tolerance 0: packing only moves values."""
    with torch.inference_mode():
        w = fold_stem_weights(stem.net, torch.bfloat16)[2 * layer]
    packed = pack_stem_weights(w)
    cin, cout = MMA_CHANNELS[layer - 1], MMA_CHANNELS[layer]
    assert packed.shape == (9 * cin // 16, 2, cout // 8, 8, 8)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    # Element [step, half, group, channel, k] is folded row
    # step*16 + half*8 + k, column group*8 + channel.
    assert packed[5, 1, 5, 3, 6] == w[5 * 16 + 8 + 6, 5 * 8 + 3]
    flat = packed.reshape(-1)
    assert flat[((0 * 2 + 1) * (cout // 8) + 4) * 64 + 2 * 8 + 7] == w[15, 34]
    assert torch.equal(unpack_stem_weights(packed).view(torch.int16),
                       w.view(torch.int16))
    with pytest.raises(ValueError):
        pack_stem_weights(w[:24])
    with pytest.raises(ValueError):
        pack_stem_weights(w[:, :7])


# ----------------------------------------------------------- (c) tile plan
@pytest.mark.parametrize("w, tiles", [
    *(pytest.param(w, MMA_TILES, id=str(w)) for w in WIDTHS + RAGGED),
    *(pytest.param(w, F32_TILES, id=f"f32-{w}") for w in WIDTHS + RAGGED)])
@pytest.mark.parametrize("layer", [1, 2, 3])
def test_tile_plan_covers_every_output_pixel_once(layer, w, tiles):
    """Both kernels' plans: bf16 (``MMA_TILES``) and float32
    (``F32_TILES``)."""
    h = 48
    for i in range(1, layer):                    # this layer's input size
        h, w = (h - 1) // STRIDES[i][0] + 1, (w - 1) // STRIDES[i][1] + 1
    sh, sw = STRIDES[layer]
    ho, wo = (h - 1) // sh + 1, (w - 1) // sw + 1
    th, tw = tiles[layer][:2]
    assert th * tw % 64 == 0 and tw % 8 == 0     # whole warpgroups of pixels
    hits = np.zeros((ho, wo), np.int32)
    for t in tile_plan(layer, h, w, tiles):
        assert 0 < t.oy1 - t.oy0 <= th and 0 < t.ox1 - t.ox0 <= tw
        hits[t.oy0:t.oy1, t.ox0:t.ox1] += 1
        # The patch holds every input pixel the 3x3 taps of the tile read.
        assert t.iy0 == t.oy0 * sh - 1 and t.ix0 == t.ox0 * sw - 1
        assert t.iy0 + t.ph >= (t.oy1 - 1) * sh + 2
        assert t.ix0 + t.pw >= (t.ox1 - 1) * sw + 2
    assert (hits == 1).all()


# ------------------------------------------- (b) the fused conv0->conv1 tile
def _fused_tiles(x, folded, zero_outside=True):
    """conv0 -> conv1 of ``stem_plain`` computed tile by tile as the CUDA
    kernel does: conv0 on the tile's patch (with its own halo of the line,
    zeros outside the line), patch positions outside the image set to 0,
    one rounding to x's dtype, conv1 on the patch."""
    b, h, w = x.shape
    w0, b0, w1, b1 = folded[:4]
    k0 = w0.reshape(3, 3, 1, -1).permute(3, 2, 0, 1).float()
    k1 = w1.reshape(3, 3, w0.shape[1], -1).permute(3, 2, 0, 1).float()
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.zeros((b, w1.shape[1], ho, wo), dtype=x.dtype)
    xf = x.float().unsqueeze(1)
    for t in tile_plan(1, h, w):
        # Strip of the line: the patch plus conv0's halo, zero outside.
        ys = torch.arange(t.iy0 - 1, t.iy0 + t.ph + 1)
        xs = torch.arange(t.ix0 - 1, t.ix0 + t.pw + 1)
        iny, inx = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
        strip = xf[:, :, ys.clamp(0, h - 1)][:, :, :, xs.clamp(0, w - 1)]
        strip = strip * (iny[:, None] & inx[None, :])
        patch = F.silu(F.conv2d(strip, k0) + b0[None, :, None, None])
        if zero_outside:
            patch = patch * (iny[1:-1, None] & inx[None, 1:-1])
        patch = patch.to(x.dtype).float()
        y = F.silu(F.conv2d(patch, k1, stride=2) + b1[None, :, None, None])
        out[:, :, t.oy0:t.oy1, t.ox0:t.ox1] = y[
            :, :, : t.oy1 - t.oy0, : t.ox1 - t.ox0].to(x.dtype)
    return out.permute(0, 2, 3, 1)


def _first_two_layers(x, folded):
    """conv0 and conv1 of ``stem_plain`` (NHWC)."""
    h = x.unsqueeze(1)
    for i in range(2):
        w, b = folded[2 * i], folded[2 * i + 1]
        k = w.reshape(3, 3, w.shape[0] // 9, -1).permute(3, 2, 0, 1)
        h = F.conv2d(h.float(), k.float(), stride=STRIDES[i], padding=1)
        h = F.silu(h + b[None, :, None, None]).to(x.dtype)
    return h.permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [52, 160, 636])
def test_fused_tile_equals_first_two_layers(stem, w, dtype):
    """Every tile of a [3, 48, W] input. float32: the tile sums the same
    432 products as the whole-image convolution, in whatever order the CPU
    convolution takes for each shape, so 2e-6 of a unit-scale output (a few
    float32 ulps); bfloat16: the same after one rounding, where a float32
    ulp can flip a bf16 rounding, so at most 1 bf16 ulp (2^-7 relative) on
    at most 1 value in 10^4 and bit for bit elsewhere."""
    x = torch.from_numpy(np.random.default_rng(w).uniform(
        -1, 1, (3, 48, w)).astype(np.float32)).to(dtype)
    with torch.inference_mode():
        folded = fold_stem_weights(stem.net, dtype)
        want = _first_two_layers(x, folded)
        got = _fused_tiles(x, folded)
    assert got.shape == want.shape == (3, 24, (w - 1) // 2 + 1, 96)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-6 * max(1.0, float(want.abs().max()))
    else:
        flipped = diff > 0
        assert float(flipped.float().mean()) <= 1e-4
        assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-30).all())


@pytest.mark.parametrize("w", [52, 160])
def test_fused_tile_without_edge_zeroing_differs(stem, w):
    """conv1's SAME padding is zeros in conv0's output, not conv0 of the
    padding (SiLU(bias) != 0): without the zeroing the edge pixels move by
    far more than the tolerance above, the interior by nothing."""
    x = torch.from_numpy(np.random.default_rng(w).uniform(
        -1, 1, (3, 48, w)).astype(np.float32))
    with torch.inference_mode():
        folded = fold_stem_weights(stem.net, torch.float32)
        want = _first_two_layers(x, folded)
        got = _fused_tiles(x, folded, zero_outside=False)
    diff = (got - want).abs()
    assert float(diff[:, 0].max()) > 1e-3        # top row
    assert float(diff[:, :, 0].max()) > 1e-3     # left column
    assert float(diff[:, 1:-1, 1:-1].max()) <= 2e-6 * float(want.abs().max())


# ------------------------------------------------------ (d) the fold cache
@pytest.fixture()
def model():
    model, _, _ = load_checkpoint(str(REPO / "models" / "model.safetensors"),
                                  device="cpu")
    return model


def test_encode_folds_once(model, monkeypatch):
    from kiri_tpu_torch.kernels import stem as S

    calls = []
    real = S.fold_stem_weights
    monkeypatch.setattr(S, "fold_stem_weights",
                        lambda net, dtype: calls.append(dtype) or real(net, dtype))
    imgs = torch.from_numpy(load_smoke_lines()[0]["imgs"][:2, :, :160])
    with torch.inference_mode():
        a = model.encode(imgs, torch.float32)
        first = model.stem.folded(torch.float32)
        b = model.encode(imgs, torch.float32)
    assert calls == [torch.float32]
    assert model.stem.folded(torch.float32) is first
    assert torch.equal(a, b)


def test_cache_is_invalidated_when_the_weights_change(model):
    imgs = torch.from_numpy(load_smoke_lines()[0]["imgs"][:2, :, :160])
    with torch.inference_mode():
        before = model.encode(imgs, torch.float32)
        old = model.stem.folded(torch.float32)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(3)
    for i in range(4):
        k = f"stem.net.{3 * i + 1}.running_mean"
        sd[k] = sd[k] + torch.from_numpy(
            rng.normal(0, 0.2, sd[k].shape).astype(np.float32))
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        after = model.encode(imgs, torch.float32)
        new = model.stem.folded(torch.float32)
    assert new is not old
    assert not torch.equal(new[1], old[1])
    assert float((after - before).abs().max()) > 1e-3
    # Replaced parameters (``.to()``) are seen as well.
    model.double().float()
    with torch.inference_mode():
        assert model.stem.folded(torch.float32) is not new
        np.testing.assert_allclose(model.encode(imgs, torch.float32).numpy(),
                                   after.numpy(), atol=1e-6)


def test_cache_entries_do_not_mix(model):
    with torch.inference_mode():
        f32 = model.stem.folded(torch.float32)
        bf16 = model.stem.folded(torch.bfloat16)
    assert f32 is not bf16
    assert f32[2].dtype == torch.float32 and bf16[2].dtype == torch.bfloat16
    assert f32[0].dtype == bf16[0].dtype == torch.float32    # conv0 stays f32
    assert all(t.device.type == "cpu" for t in (*f32, *bf16))
    assert model.stem.folded(torch.float32) is f32
    assert model.stem.folded(torch.bfloat16) is bf16
    # The CPU route never packs: that is the bf16 kernel's layout.
    with torch.inference_mode():
        model.encode(torch.zeros((1, 48, 160), dtype=torch.uint8),
                     torch.bfloat16)
    assert bf16.packed is None and f32.packed is None


def test_mma_layer_takes_only_a_folded_stem(stem):
    """A plain tuple has nowhere to keep the packed weights: refused before
    anything is built or launched."""
    with torch.inference_mode():
        folded = fold_stem_weights(stem.net, torch.bfloat16)
    x = torch.zeros((1, 48, 160), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="FoldedStem"):
        stem_mma_layer(1, x, tuple(folded))
    with pytest.raises(ValueError, match="CUDA"):
        stem_mma_layer(1, x, folded)             # a CPU tensor: no launch
    assert folded.packed is None


# --------------------------------------------- (e) encode against kiri_tpu
def test_encode_with_cached_weights_matches_kiri_tpu():
    """4 smoke lines sliced to the 320 bucket, float32, twice (the second
    call reads the cache): encoder memory within 1e-4 of kiri_tpu's, the
    bound of tests/test_torch_layers.py and tests/test_torch_checkpoint.py."""
    ckpt = str(REPO / "models" / "model.safetensors")
    variables, jcfg, _ = j_load(ckpt)
    jcfg = jcfg.replace(COMPUTE_DTYPE="float32")
    model, _, _ = load_checkpoint(ckpt, device="cpu")
    imgs = np.ascontiguousarray(load_smoke_lines()[0]["imgs"][8:12, :, :320])
    want = np.asarray(jax.jit(lambda v, x: R.encode(v, x, jcfg)[0])(
        variables, imgs))
    with torch.inference_mode():
        for _ in range(2):
            got = model.encode(torch.from_numpy(imgs), torch.float32)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
