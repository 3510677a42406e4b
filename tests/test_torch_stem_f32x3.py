"""The pieces of kiri_tpu_torch's float32 (3xTF32) stem kernel that run on
the CPU: the tf32 split, the packed weight layout, the tiles'
shared-memory budget, the kernel's arithmetic emulated in torch against
``stem_plain`` and kiri_tpu's XLA stem, the recognizer's texts with that
emulated stem, and the build digest over the kernels' headers."""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_decoder_layers import few_torch_threads  # noqa: F401

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.models import recognizer as R
from kiri_tpu.train.checkpoints import load_checkpoint as j_load
from kiri_tpu_torch.checkpoints import load_checkpoint
from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.kernels import build
from kiri_tpu_torch.kernels import stem as S
from kiri_tpu_torch.kernels.stem import (F32_TILES, MMA_CHANNELS, STRIDES,
                                         pack_tf32_weights, split_tf32,
                                         stem_fused_f32, stem_plain,
                                         unpack_tf32_weights)
from kiri_tpu_torch.ops.preprocess import normalize_u8
from kiri_tpu_torch.smoke import load_smoke_lines

REPO = Path(__file__).resolve().parent.parent
CKPT = str(REPO / "models" / "model.safetensors")
LOW13 = 0x1FFF                     # mantissa bits a tf32 value leaves zero


def _rna_reference(t: np.ndarray) -> np.ndarray:
    """float32 -> tf32 (11 significant bits), to nearest, ties away from
    zero, computed in float64 from the binary exponent (exact)."""
    m, e = np.frexp(t.astype(np.float64))          # |m| in [0.5, 1)
    r = np.floor(np.abs(m) * 2.0 ** 11 + 0.5)      # ties away from zero
    return np.copysign(np.ldexp(r, e - 11), t).astype(np.float32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


# ------------------------------------------------------------ (a) the split
def test_split_tf32_rounds_as_cvt_rna_and_keeps_float32():
    rng = np.random.default_rng(0)
    vals = [rng.normal(0, 1, 4000) * 10.0 ** rng.uniform(-20, 20, 4000)]
    # Ties: the 13 dropped bits are exactly half a tf32 ulp (0x1000), on
    # both signs; with an even and an odd kept mantissa. Exponents where lo
    # too is a normal number (the stem's values are far inside).
    base = rng.integers(0x10000000, 0x70000000, 500, dtype=np.int64)
    ties = (base & ~LOW13) | 0x1000
    vals.append(ties.astype(np.uint32).view(np.float32))
    vals.append((ties | 0x80000000).astype(np.uint32).view(np.float32))
    # Binade edges: powers of two, the values just below them (a rounding
    # that carries into the exponent) and just above, and +-0.
    p2 = np.float32(2.0) ** np.arange(-100, 100, dtype=np.float32)
    vals += [p2, -p2, np.nextafter(p2, np.float32(0)),
             np.nextafter(p2, np.float32(np.inf)),
             np.array([0.0, -0.0, 1.0 - 2.0 ** -12, 1.0 - 2.0 ** -24],
                      np.float32)]
    t = torch.from_numpy(np.concatenate(vals).astype(np.float32))
    hi, lo = split_tf32(t)
    assert bool((_bits(hi) & LOW13 == 0).all())
    assert bool((_bits(lo) & LOW13 == 0).all())
    np.testing.assert_array_equal(_bits(hi).numpy(), _bits(torch.from_numpy(
        _rna_reference(t.numpy()))).numpy())
    # The tie cases round away from zero: up in magnitude.
    n = len(vals[0])
    assert bool((hi[n:n + 1000].abs() > t[n:n + 1000].abs()).all())
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2.0 ** -21 * t.double().abs()).all())
    assert torch.equal(_bits(split_tf32(torch.zeros(3))[0]),
                       torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        split_tf32(t.double())


# ------------------------------------------------------------ (b) packing
@pytest.mark.parametrize("layer", [1, 2, 3])
def test_pack_unpack_tf32_is_bit_exact(layer):
    """Tolerance 0: packing splits once and then only moves values."""
    cin, cout = MMA_CHANNELS[layer - 1], MMA_CHANNELS[layer]
    th, tw, nb, cc, nst = F32_TILES[layer]
    rng = np.random.default_rng(layer)
    w = torch.from_numpy(rng.normal(0, 0.1, (9 * cin, cout)).astype(
        np.float32))
    packed = pack_tf32_weights(w, cc, nb)
    taps, steps = 9 * cin // cc, cc // 8          # taps of all chunks
    assert packed.shape == (cout // nb, taps, 2, steps, 2, nb // 8, 8, 4)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    hi, lo = split_tf32(w)
    # Element [block, chunk * 9 + tap, half, step, k half, group, channel, k]
    # is row tap * cin + chunk * cc + step * 8 + k half * 4 + k and column
    # block * nb + group * 8 + channel of hi (half 0) or lo (half 1).
    for blk, chunk, tap, half, step, kh, grp, ch, k in (
            (cout // nb - 1, cin // cc - 1, 8, 1, steps - 1, 1, nb // 8 - 1,
             7, 3), (0, 1, 4, 0, 0, 1, 2, 5, 1)):
        row = tap * cin + chunk * cc + step * 8 + kh * 4 + k
        col = blk * nb + grp * 8 + ch
        assert packed[blk, chunk * 9 + tap, half, step, kh, grp, ch, k] == \
            (hi, lo)[half][row, col]
    # A ring stage, a row of 3 taps of a chunk of the last channel block, is
    # one contiguous run of the flat tensor.
    flat, tap = packed.reshape(-1), 2 * steps * 2 * nb * 8 * 4 // 8
    first = (cout // nb - 1) * taps + 3
    assert torch.equal(flat[first * tap:(first + 3) * tap],
                       packed[-1, 3:6].reshape(-1))
    h2, l2 = unpack_tf32_weights(packed)
    assert torch.equal(_bits(h2), _bits(hi)) and torch.equal(_bits(l2),
                                                              _bits(lo))
    with pytest.raises(ValueError):
        pack_tf32_weights(w[:-9], cc, nb)              # Cin not in chunks
    with pytest.raises(ValueError):
        pack_tf32_weights(w, cc, nb - 8 if nb > 8 else 7)
    with pytest.raises(ValueError):
        pack_tf32_weights(w.double(), cc, nb)


# ------------------------------------------------ (c) channels and budget
# (The float32 tile plan is held by test_torch_stem_tiles.py's
# test_tile_plan_covers_every_output_pixel_once.)
@pytest.mark.parametrize("layer", [1, 2, 3])
def test_f32_tiles_fit_one_block(layer):
    """The kernel's static_asserts, checked where no nvcc runs: two chunk
    patches and the weight ring (and for layer 1 conv0's two strips) within
    the 232,448 bytes of shared memory a block may take, a patch pixel an
    odd number of 16-byte units (ldmatrix rows on all banks), a ring of at
    least 2 stages of 3 taps copied at most 3 ahead (one chunk's stages)."""
    th, tw, nb, cc, nst = F32_TILES[layer]
    assert MMA_CHANNELS[layer] % nb == 0 and MMA_CHANNELS[layer - 1] % cc == 0
    sh, sw = STRIDES[layer]
    ph, pw = (th - 1) * sh + 3, (tw - 1) * sw + 3
    pitch = cc * 4 + 16
    patch = ph * sw * ((pw + sw - 1) // sw) * pitch
    stage = 3 * 2 * (cc // 8) * 8 * nb * 4
    strips = 2 * (((ph + 2) * (pw + 2) + 3) // 4 * 4) * 4 if layer == 1 else 0
    assert 2 * patch + nst * stage + strips <= 232448
    assert (pitch // 16) % 2 == 1 and 2 <= nst <= 4
    # The output of a warp's 8 staged rows fits where it is staged.
    assert th * tw // 16 * 8 * (nb * 4 + 32) <= (patch if layer == 1 else
                                                 2 * patch + nst * stage)


def test_f32_wrapper_takes_only_cuda_tensors():
    """On a CPU tensor the float32 wrapper raises before anything is built
    or launched; only ``stem_fused`` serves the CPU, through the plain
    version."""
    model, _, _ = load_checkpoint(CKPT, device="cpu")
    with torch.inference_mode():
        folded = model.stem.folded(torch.float32)
    x = torch.zeros((1, 48, 160))
    before = stem_fused_f32.launches
    with pytest.raises(ValueError, match="CUDA"):
        stem_fused_f32(x, folded)
    assert stem_fused_f32.launches == before and folded.packed is None
    assert torch.equal(S.stem_fused(x, folded), stem_plain(x, folded))


# ----------------------------------------- (d) the kernel's arithmetic
def _split_np(t: np.ndarray):
    hi, lo = split_tf32(torch.from_numpy(np.ascontiguousarray(t, np.float32)))
    return hi.numpy(), lo.numpy()


def stem_f32x3_emulated(x: torch.Tensor, folded) -> torch.Tensor:
    """The float32 kernel's arithmetic in plain torch: conv0 in float32;
    convs 1-3 with input and weights split into tf32 hi and lo halves (by
    bit masking, ``split_tf32``) and three products summed in float32, the
    small terms first: a_lo*w_hi + a_hi*w_lo, then a_hi*w_hi."""
    h = x.unsqueeze(1).float()
    for i, stride in enumerate(STRIDES):
        w, b = folded[2 * i], folded[2 * i + 1]
        cin, cout = w.shape[0] // 9, w.shape[1]

        def conv(a, k):
            k = k.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
            return F.conv2d(a, k, stride=stride, padding=1)

        if i == 0:
            y = conv(h, w.float())
        else:
            (a_hi, a_lo), (w_hi, w_lo) = split_tf32(h), split_tf32(w)
            y = conv(a_lo, w_hi) + conv(a_hi, w_lo)
            y = y + conv(a_hi, w_hi)
        h = F.silu(y + b[None, :, None, None])
    return h.permute(0, 2, 3, 1).contiguous()


@pytest.fixture(scope="module")
def ckpt_model():
    model, _, _ = load_checkpoint(CKPT, device="cpu")
    return model


def test_emulated_kernel_matches_plain_and_kiri_tpu(ckpt_model,
                                                    few_torch_threads):
    """16 smoke lines at width 640, the committed checkpoint: the 3xTF32
    emulation within 2e-5 of ``stem_plain`` (float32, the same folded
    weights) and of kiri_tpu's ``R.stem_forward`` at float32, as close as
    ``stem_plain`` is to the latter (tests/test_torch_stem.py); a single
    TF32 pass is not."""
    d, _ = load_smoke_lines()
    u8 = torch.from_numpy(np.ascontiguousarray(d["imgs"][::4]))
    x = normalize_u8(u8, torch.float32)
    with torch.inference_mode():
        folded = ckpt_model.stem.folded(torch.float32)
        got = stem_f32x3_emulated(x, folded)
        plain = stem_plain(x, folded)
    variables, _, _ = j_load(CKPT)
    want, _ = R.stem_forward(variables["params"]["stem"],
                             variables["batch_stats"]["stem"],
                             jnp.asarray(x.numpy())[..., None],
                             JCFG(COMPUTE_DTYPE="float32"), train=False)
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == plain.shape == want.shape == (16, 6, 160, 256)
    assert float((got - plain).abs().max()) <= 2e-5
    assert float((got - want).abs().max()) <= 2e-5
    # The same without the small terms: one TF32 pass, far outside.
    with torch.inference_mode():
        one = [t if i % 2 or i == 0 else split_tf32(t)[0]
               for i, t in enumerate(folded)]
        h = x.unsqueeze(1)
        for i, stride in enumerate(STRIDES):
            w, b = one[2 * i], one[2 * i + 1]
            k = w.reshape(3, 3, w.shape[0] // 9, -1).permute(3, 2, 0, 1)
            a = h if i == 0 else split_tf32(h)[0]
            h = F.silu(F.conv2d(a, k, stride=stride, padding=1)
                       + b[None, :, None, None])
    assert float((h.permute(0, 2, 3, 1) - plain).abs().max()) > 1e-3


def _rz32(v: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_stage_partial_sums_bound_rounding_toward_zero(ckpt_model, layer):
    """A check of the model behind the kernel's accumulation, not of the
    kernel: if the tensor cores round each wgmma's float32 sum toward zero,
    then over 256 output pixels of the smoke lines, in the kernel's
    reduction order (chunk, tap, channel) and k8 steps of three products,
    one accumulator over the whole reduction drifts far past float32's own
    error, while partial sums per stage of the kernel's ring (a row of 3
    taps), added in float32 with rounding to nearest, stay within twice
    it."""
    d, _ = load_smoke_lines()
    x = normalize_u8(torch.from_numpy(np.ascontiguousarray(d["imgs"][:2])),
                     torch.float32)
    with torch.inference_mode():
        folded = ckpt_model.stem.folded(torch.float32)
        h = x.unsqueeze(1)
        for i in range(layer):                   # this layer's input
            w, b = folded[2 * i], folded[2 * i + 1]
            k = w.reshape(3, 3, w.shape[0] // 9, -1).permute(3, 2, 0, 1)
            h = F.silu(F.conv2d(h, k, stride=STRIDES[i], padding=1)
                       + b[None, :, None, None])
    th, tw, nb, cc, nst = F32_TILES[layer]
    cin = h.shape[1]
    cols = F.unfold(h, 3, padding=1, stride=STRIDES[layer])   # (c, dy, dx)
    cols = cols.reshape(2, cin, 9, -1).permute(0, 3, 2, 1).reshape(
        -1, 9 * cin).numpy()                                  # (dy, dx, c)
    a = cols[np.random.default_rng(layer).choice(len(cols), 256, False)]
    order = [tap * cin + c * cc + j for c in range(cin // cc)
             for tap in range(9) for j in range(cc)]
    a, w = a[:, order], folded[2 * layer].numpy()[order]
    ref = a.astype(np.float64) @ w.astype(np.float64)
    (a_hi, a_lo), (w_hi, w_lo) = _split_np(a), _split_np(w)
    steps_a_stage = 3 * cc // 8
    one = np.zeros(ref.shape, np.float32)
    total = np.zeros(ref.shape, np.float32)
    part = np.zeros(ref.shape, np.float32)
    for s in range(a.shape[1] // 8):
        k = slice(8 * s, 8 * s + 8)
        for p, q in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)):
            prod = p[:, k].astype(np.float64) @ q[k].astype(np.float64)
            one = _rz32(one + prod)
            part = _rz32(part + prod)
        if (s + 1) % steps_a_stage == 0:
            total, part = total + part, np.zeros_like(part)
    f32 = np.abs((a @ w).astype(np.float32) - ref).max()
    assert np.abs(total - ref).max() <= 2 * f32
    assert np.abs(one - ref).max() > 5 * f32


# ----------------------------------------- (e) texts with the emulated stem
def test_ctc_texts_with_emulated_stem_match_kiri_tpu(monkeypatch,
                                                     few_torch_threads):
    """encode + greedy CTC over the 64 smoke lines, width-bucketed, with the
    emulated float32 kernel in place of the stem: kiri_tpu's stored float32
    texts line for line, confidences within 1e-4 (the CPU bound of
    tests/test_torch_engine.py's live comparison)."""
    from kiri_tpu_torch.models import recognizer

    calls = []

    def emulated(x, folded):
        calls.append(x.shape)
        return stem_f32x3_emulated(x, folded)

    monkeypatch.setattr(recognizer, "stem_fused", emulated)
    eng = RecognizerEngine.from_checkpoint(CKPT, device="cpu")
    eng = RecognizerEngine(eng.model, eng.cfg.replace(COMPUTE_DTYPE="float32"),
                           eng.tok, device="cpu")
    d, _ = load_smoke_lines()
    res = eng.recognize_batch(d["imgs"], "ctc", d["widths"])
    assert calls and sum(s[0] for s in calls) >= 64
    assert [t for t, _ in res] == [str(t) for t in d["batch_texts_f32"]]
    np.testing.assert_allclose([c for _, c in res], d["batch_conf_f32"],
                               atol=1e-4)


# ----------------------------------------------------- the build's digest
def test_build_digest_covers_every_header(tmp_path, monkeypatch):
    """A library's name changes when its source or any ``*.h`` or ``*.cuh``
    under ``csrc/`` changes, so that an edited shared header rebuilds every
    library; other files do not count."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("#define A 1\n")
    (tmp_path / "tiles.h").write_text("#define B 1\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "deep.cuh").write_text("#define C 1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._lib_path("k")
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk_")
    (tmp_path / "notes.txt").write_text("not a header")
    assert build._lib_path("k") == first
    seen = {first}
    for name in ("shared.cuh", "tiles.h", "sub/deep.cuh", "k.cu"):
        path = tmp_path / name
        path.write_text(path.read_text() + "// edited\n")
        now = build._lib_path("k")
        assert now not in seen, name
        seen.add(now)
    # The real sources: every library of the repository hashes its headers.
    monkeypatch.undo()
    assert {p.name for p in build._headers()} >= {"stem_mma_tiles.h",
                                                  "stem_f32x3_tiles.h"}
