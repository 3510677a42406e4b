"""The int8 kernels' layouts and tile walks, emulated in plain torch on the
CPU (``csrc/q8_stem.cu``, ``csrc/q8_gemm.cu`` run only on the card):

* ``pack_q8_weights`` / ``unpack_q8_weights``: a bit-exact round trip, and
  every weight byte where an 8-bit ``wgmma`` descriptor reads it; the
  wrappers pack a weight tensor once, and again after it is written to;
* the tile plans of the three stem launches cover every output pixel once,
  at the bucket widths and at ragged ones, and the persistent split covers
  every tile once;
* the patch geometry (``Cfg`` of ``q8_stem.cu``): each lane's ldmatrix
  address at each k32 step points at its pixel's tap and channels, and
  each layer's shared memory fits;
* conv0 computed into conv1's int8 patch tile by tile (the rounding to the
  compute dtype, conv1's quantization, zeros outside the image), then
  conv1 over the patch by the kernel's k32 steps on the padded, packed
  weights: bit for bit ``q8_stem01_plain``, in float32 and bfloat16; with
  conv0 of the padding in place of the zeros it differs;
* the padded reduction of each conv gives the unpadded sums;
* the GEMM's walk (row blocks quantized once into the A layout, N in
  chunks, K in stages, both operands read through descriptor offsets)
  equals ``q8_linear_plain`` bit for bit;
* ``Q8Encoder`` runs the stem in 3 launches a forward.

All comparisons are exact: the sums are integers, the epilogues are the
same float32 operations in the same order.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kiri_tpu_torch.kernels import build
from kiri_tpu_torch.kernels import quant8 as K
from kiri_tpu_torch.kernels.stem import MMA_CHANNELS, STRIDES, tile_plan

SMEM_MAX = 232448          # a block's dynamic shared memory on an H100
SMEM_SM = 233472           # an SM's, of which each block reserves 1 KB
WIDTHS = (160, 320, 480, 640, 52, 636)
DTYPES = (torch.float32, torch.bfloat16)


class Geom:
    """``Cfg`` of ``csrc/q8_stem.cu`` for stem layer ``layer``."""

    def __init__(self, layer: int):
        self.cin, self.cout = MMA_CHANNELS[layer - 1:layer + 1]
        self.sh, self.sw = STRIDES[layer]
        self.th, self.tw, self.nst, self.sps, self.minb = K.Q8_TILES[layer]
        self.m = self.th * self.tw
        self.ph = (self.th - 1) * self.sh + 3
        self.pw = (self.tw - 1) * self.sw + 3
        self.pwp = -(-self.pw // self.sw)
        self.cpt = self.cin // 16
        self.pitch = self.cin + (0 if self.cpt % 2 else 16)
        self.patch_bytes = -(-self.ph * self.sw * self.pwp * self.pitch
                             // 128) * 128
        self.steps = (9 * self.cpt + 1) // 2
        self.stage_bytes = self.sps * 32 * self.cout
        self.ring_bytes = self.nst * self.stage_bytes

    def patch_off(self, py, pc):
        return ((py * self.sw + pc % self.sw) * self.pwp
                + pc // self.sw) * self.pitch

    def tap_off(self, dy, dx):
        return ((dy * self.sw + dx % self.sw) * self.pwp
                + dx // self.sw) * self.pitch

    def chunk_off(self, j):
        j = min(j, 9 * self.cpt - 1)
        tap = j // self.cpt
        return self.tap_off(tap // 3, tap % 3) + (j % self.cpt) * 16

    def a_pixel(self, m):
        ty, tx = divmod(m, self.tw)
        return (ty * self.sh * self.sw * self.pwp + tx) * self.pitch

    def opitch(self, dtype):
        return self.cout * torch.empty((), dtype=dtype).element_size() + 16


def _rng(seed):
    return np.random.default_rng(seed)


def persistent_runs(tiles, sms):
    """The tiles of each block of ``launch_stem01``'s persistent launch over
    ``tiles`` tiles on ``sms`` SMs: one block an SM, each a run of
    consecutive tiles."""
    per = -(-tiles // sms)
    return [range(s, min(s + per, tiles)) for s in range(0, tiles, per)]


def conv_chunks(cin):
    """The reduction of a 3x3 conv over ``cin`` channels as ``q8_stem.cu``
    walks it (``Cfg::chunk_off``): (dy, dx, first channel) of each
    16-channel chunk, two chunks a k32 step, the last repeated (it meets
    zero weights) to a whole step."""
    per = cin // 16
    real = [(t // 3, t % 3, 16 * c) for t in range(9) for c in range(per)]
    return real + real[-1:] * (len(real) % 2)


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))


# ------------------------------------------------------------- the header
def test_header_is_parsed():
    text = (build.CSRC / "q8_tiles.h").read_text()
    assert sorted(K.Q8_TILES) == [1, 2, 3]
    assert "#define KIRI_Q8_GEMM " + ", ".join(map(str, K.Q8_GEMM)) in text
    assert {p.name for p in build._headers()} >= {"q8_tiles.h",
                                                  "q8_wgmma.cuh"}
    assert "q8_stem" in build.SOURCES and "q8_gemm" in build.SOURCES


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("layer", [1, 2, 3])
def test_stem_tiles_fit(layer, dtype):
    """Pixel tiles of whole warpgroups and ldmatrix phases, an odd pitch in
    16-byte units, whole ring stages, and the shared memory of MINB blocks
    an SM."""
    g = Geom(layer)
    assert g.m % 64 == 0 and g.tw % 8 == 0
    assert (g.pitch // 16) % 2 == 1 and g.pitch % 16 == 0
    out = g.m // 2 * g.opitch(dtype)          # 8 rows a warp at a time
    if layer == 1:
        w_bytes = g.steps * 32 * g.cout
        words = -(-(g.ph + 2) * ((g.pw + 1) // 2) // 32) * 32
        smem = w_bytes + 2 * g.patch_bytes + out + 2 * words * 4
        static = 4 * 2 * g.cout + 4 * 6 * g.cin   # conv0's parameters
        assert w_bytes == 43008 and g.steps == 14
    else:
        assert g.steps % g.sps == 0 and g.steps // g.sps >= g.nst >= 2
        smem = max(g.patch_bytes + g.ring_bytes, out)
        static = 4 * (g.cin + 2 * g.cout)
    assert smem <= SMEM_MAX
    assert g.minb * (smem + static + 1024) <= SMEM_SM


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("k,n", [(256, 768), (256, 256), (256, 1024),
                                 (1024, 256)])
def test_gemm_fits(k, n, dtype):
    """The encoder's shapes: 3 blocks an SM at K = 256, 2 at K = 1024 in
    bfloat16 (the rows, the ring, 8 staged rows a warp, scale and bias)."""
    bm, nc, sps, nst = K.Q8_GEMM
    assert bm == 64 and nc % 8 == 0 and nc <= 256 and nst >= 3
    size = torch.empty((), dtype=dtype).element_size()
    np_ = -(-n // nc) * nc
    smem = bm * k + nst * sps * 32 * nc + bm // 2 * (nc * size + 16) + 8 * np_
    assert smem <= SMEM_MAX
    blocks_per_sm = SMEM_SM // (smem + 1024)
    assert blocks_per_sm >= (3 if k == 256 else
                             2 if dtype == torch.bfloat16 else 1)


# ------------------------------------------------------------- the weights
@pytest.mark.parametrize("n,k,nc,align", [
    (96, 432, None, 32), (160, 864, None, 32), (256, 1440, None, 32),
    (768, 256, 128, 64), (256, 1024, 128, 64), (40, 72, 128, 64),
    (24, 8, 8, 32)])
def test_pack_q8_weights_round_trip_and_layout(n, k, nc, align):
    rng = _rng(n + k)
    w = _int8(rng, (n, k))
    p = K.pack_q8_weights(w, nc, align)
    nc = nc or n
    kp, chunks = -(-k // align) * align, -(-n // nc)
    assert p.shape == (chunks, kp // 32, 2, nc // 8, 8, 16)
    assert p.dtype == torch.int8 and p.is_contiguous()
    assert torch.equal(K.unpack_q8_weights(p, n, k), w)
    # Byte (column j, k) sits where a descriptor of the step reads it:
    # chunk j // nc, step k // 32, then k half (lbo = nc * 16 bytes), group
    # of 8 columns (sbo = 128), row of the core matrix (16 bytes), byte.
    flat = p.reshape(-1)
    jj, kk = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    c, jn = jj // nc, jj % nc
    off = ((c * (kp // 32) + kk // 32) * 32 * nc + (kk // 16 % 2) * nc * 16
           + (jn // 8) * 128 + (jn % 8) * 16 + kk % 16)
    assert torch.equal(flat[torch.from_numpy(off.reshape(-1))],
                       w.reshape(-1))
    # The padding is zeros.
    full = K.unpack_q8_weights(p, chunks * nc, kp)
    assert not full[n:].any() and not full[:, k:].any()


def test_pack_q8_weights_rejects_what_does_not_split():
    with pytest.raises(ValueError):
        K.pack_q8_weights(torch.zeros((12, 32), dtype=torch.int8))
    with pytest.raises(ValueError):
        K.pack_q8_weights(torch.zeros((16, 32), dtype=torch.float32))


@pytest.mark.parametrize("pack", [K.pack_q8_weights, K.pack_q8_linear])
def test_wrappers_pack_each_weight_tensor_once(pack):
    """The wrappers' packed weights: made once for a weight tensor, again
    after an in-place write to it, and dropped with it."""
    w = _int8(_rng(7), (256, 256))
    first = K._packed(w, pack)
    assert torch.equal(first, pack(w))
    assert K._packed(w, pack) is first
    other = w.clone()
    assert K._packed(other, pack) is not first
    w[0, 0] = -w[0, 0] - 1
    again = K._packed(w, pack)
    assert again is not first and torch.equal(again, pack(w))
    keys = [k for k in K._PACKS if k[0] in (id(w), id(other))]
    del w, other
    assert not any(k in K._PACKS for k in keys)
    with torch.inference_mode():
        frozen = _int8(_rng(8), (256, 256))
    assert K._packed(frozen, pack) is K._packed(frozen, pack)


# -------------------------------------------------------------- tile walks
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("layer", [1, 2, 3])
def test_q8_tile_plan_covers_every_pixel_once(layer, w):
    h = 48
    for i in range(1, layer):                   # the input of conv `layer`
        h, w = (h - 1) // STRIDES[i][0] + 1, (w - 1) // STRIDES[i][1] + 1
    sh, sw = STRIDES[layer]
    ho, wo = (h - 1) // sh + 1, (w - 1) // sw + 1
    hits = np.zeros((ho, wo), np.int32)
    g = Geom(layer)
    for t in tile_plan(layer, h, w, K.Q8_TILES):
        hits[t.oy0:t.oy1, t.ox0:t.ox1] += 1
        assert (t.ph, t.pw) == (g.ph, g.pw)
        # The patch holds every input pixel the tile's outputs read.
        assert t.iy0 <= t.oy0 * sh - 1 and t.ix0 <= t.ox0 * sw - 1
        assert t.iy0 + t.ph >= (t.oy1 - 1) * sh + 2
        assert t.ix0 + t.pw >= (t.ox1 - 1) * sw + 2
    assert (hits == 1).all()


@pytest.mark.parametrize("tiles,sms", [(7680, 132), (60, 132), (131, 132),
                                       (133, 132), (1, 132), (1000, 7)])
def test_persistent_runs_cover_every_tile_once(tiles, sms):
    runs = persistent_runs(tiles, sms)
    per = -(-tiles // sms)
    assert len(runs) <= sms
    assert [t for r in runs for t in r] == list(range(tiles))
    assert all(len(r) == per for r in runs[:-1]) and 0 < len(runs[-1]) <= per


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_ldmatrix_addresses_reach_each_tap(layer):
    """Lane l of warp w at k32 step s reads 16 bytes at a_pixel + chunk_off
    (2s + l // 16): pixel 16w + l % 16 of the tile, the tap and channels of
    that chunk of the reduction (``conv_chunks``), in a patch laid out by
    ``patch_off``; the 8 rows of each ldmatrix phase fall in 8 different
    groups of 4 banks."""
    g = Geom(layer)
    chunks = conv_chunks(g.cin)
    assert len(chunks) == 2 * g.steps
    where = {}
    for py in range(g.ph):
        for pc in range(g.pw):
            for c in range(0, g.cin, 16):
                where[g.patch_off(py, pc) + c] = (py, pc, c)
    for m in range(g.m):
        ty, tx = divmod(m, g.tw)
        for j, (dy, dx, c) in enumerate(chunks):
            assert where[g.a_pixel(m) + g.chunk_off(j)] == (
                ty * g.sh + dy, tx * g.sw + dx, c)
    for m0 in range(0, g.m, 8):
        for j in range(len(chunks)):
            units = {(g.a_pixel(m) + g.chunk_off(j)) // 16 % 8
                     for m in range(m0, m0 + 8)}
            assert len(units) == 8


# ---------------------------------------------------- the padded reduction
def _walk_sums(xq, wq, cin, stride):
    """The conv's sums as the kernel takes them: the reduction in 16-byte
    chunks (``conv_chunks``, the last repeated to a whole k32 step), times
    the packed weights of each step (zeros past K), step by step."""
    b, h, w, _ = xq.shape
    sh, sw = stride
    ho, wo = (h - 1) // sh + 1, (w - 1) // sw + 1
    xp = F.pad(xq.double(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + sh * (ho - 1) + 1:sh,
                         dx:dx + sw * (wo - 1) + 1:sw, c:c + 16]
                      for dy, dx, c in conv_chunks(cin)], -1)
    packed = K.pack_q8_weights(wq)
    steps = packed.shape[1]
    wk = K.unpack_q8_weights(packed, wq.shape[0], steps * 32).double()
    acc = torch.zeros(b, ho, wo, wq.shape[0], dtype=torch.float64)
    for s in range(steps):
        acc += cols[..., 32 * s:32 * s + 32] @ wk[:, 32 * s:32 * s + 32].t()
    return acc


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_padded_reduction_gives_the_unpadded_sums(layer):
    rng = _rng(layer)
    cin, cout = MMA_CHANNELS[layer - 1:layer + 1]
    xq = _int8(rng, (2, 9, 21, cin))
    xq[0, 0, 0] = 127
    wq = _int8(rng, (cout, 9 * cin))
    got = _walk_sums(xq, wq, cin, STRIDES[layer])
    want = K.q8_conv_acc(xq, wq, STRIDES[layer])
    assert torch.equal(got, want)
    if layer == 1:                   # 27 chunks: one padded half step
        assert K.pack_q8_weights(wq).shape[1] * 32 == 448


# ------------------------------------------------ conv0 inside conv1's tile
def _stem_inputs(seed, b, w, dtype):
    """u8 lines and conv0/conv1 weights and scales of the size of the
    port's stem, conv0's correction as ``Q8Encoder._correction`` makes it."""
    rng = _rng(seed)
    h = 48
    x = torch.from_numpy(rng.integers(0, 256, (b, h, w), dtype=np.uint8))
    x[0, :, :3] = 255                           # bright and dark edges
    x[-1, -2:] = 0
    w0 = _int8(rng, (48, 9))
    scale0 = torch.from_numpy(rng.uniform(2e-5, 8e-5, 48).astype(np.float32))
    bias0 = torch.from_numpy(rng.normal(0, 0.3, 48).astype(np.float32))
    wf = torch.from_numpy(rng.normal(0, 0.3, (9, 48)).astype(np.float32))
    half = torch.full((1, 1, h, w), K.f32(0.5 / 127.5))
    corr = F.conv2d(half, wf.reshape(3, 3, 1, 48).permute(3, 2, 0, 1),
                    padding=1)[0].permute(1, 2, 0).contiguous()
    w1 = _int8(rng, (96, 432))
    scale1 = torch.from_numpy(rng.uniform(1e-4, 4e-4, 96).astype(np.float32))
    bias1 = torch.from_numpy(rng.normal(0, 0.3, 96).astype(np.float32))
    inv1 = torch.from_numpy(rng.uniform(40, 160, 48).astype(np.float32))
    return (x, w0, scale0, bias0, corr, w1, scale1, bias1, inv1, dtype)


def _fused_emulation(args, zero_edges=True):
    """``q8_stem01_kernel`` tile by tile: conv0 of each patch pixel from the
    u8 strip (int8(u8 - 128), zeros outside the line), (acc * scale +
    corr) + bias, SiLU, the rounding to the compute dtype and conv1's
    quantization into an int8 patch, positions outside the image zeros
    (``zero_edges``; else conv0 of the padding, corr clamped to the
    image); then conv1 over the patch by k32 steps on the packed weights,
    acc * scale + bias, SiLU, the compute dtype."""
    x, w0, scale0, bias0, corr, w1, scale1, bias1, inv1, dtype = args
    b, h, w = x.shape
    g = Geom(1)
    xi = (x.to(torch.int16) - 128).to(torch.int8)
    # conv0's sums over an extended grid: position (y, x) of the image at
    # [y + e, x + e], far enough out for any tile's overhang.
    e = g.ph + g.pw
    xp = F.pad(xi.double(), (e + 1, e + 1, e + 1, e + 1))
    w0k = w0.double().reshape(48, 1, 3, 3)
    acc0 = F.conv2d(xp.unsqueeze(1), w0k)          # [B, 48, H+2e, W+2e]
    acc0 = acc0.permute(0, 2, 3, 1).float()
    ys = torch.arange(-e, h + e).clamp(0, h - 1)
    xs = torch.arange(-e, w + e).clamp(0, w - 1)
    corr_ext = corr[ys][:, xs]
    y0 = F.silu((acc0 * scale0 + corr_ext) + bias0).to(dtype)
    q0 = K.quantize(y0, inv1)
    if zero_edges:
        inside = torch.zeros(h + 2 * e, w + 2 * e, dtype=torch.bool)
        inside[e:e + h, e:e + w] = True
        q0 = q0 * inside[None, :, :, None]
    chunks = conv_chunks(48)
    packed = K.pack_q8_weights(w1)
    wk = K.unpack_q8_weights(packed, 96, packed.shape[1] * 32).double()
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = torch.empty((b, ho, wo, 96), dtype=dtype)
    for t in tile_plan(1, h, w, K.Q8_TILES):
        patch = q0[:, t.iy0 + e:t.iy0 + e + g.ph, t.ix0 + e:t.ix0 + e + g.pw]
        cols = torch.cat([patch[:, dy:dy + 2 * (g.th - 1) + 1:2,
                                dx:dx + 2 * (g.tw - 1) + 1:2, c:c + 16]
                          for dy, dx, c in chunks], -1).double()
        acc = torch.zeros(b, g.th, g.tw, 96, dtype=torch.float64)
        for s in range(len(chunks) // 2):
            acc += cols[..., 32 * s:32 * s + 32] @ wk[:, 32 * s:32 * s
                                                      + 32].t()
        y = F.silu(acc.float() * scale1 + bias1).to(dtype)
        oh, ow = t.oy1 - t.oy0, t.ox1 - t.ox0
        out[:, t.oy0:t.oy1, t.ox0:t.ox1] = y[:, :oh, :ow]
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,w", [(2, 52), (1, 160), (1, 66)])
def test_fused_tile_equals_two_plain_convs(b, w, dtype):
    args = _stem_inputs(w, b, w, dtype)
    want = K.q8_stem01_plain(*args)
    got = _fused_emulation(args)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(K.q8_stem01(*args), want)     # the CPU wrapper


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fused_tile_without_edge_zeroing_differs(dtype):
    """Zeros outside the image are conv1's padding; conv0 of the padding
    would change every output pixel on the border."""
    args = _stem_inputs(7, 1, 52, dtype)
    want = K.q8_stem01_plain(*args)
    bad = _fused_emulation(args, zero_edges=False)
    diff = (bad != want).any(-1)
    assert diff[0].any() and diff[-1].any()
    assert diff[:, 0].any() and diff[:, -1].any()
    assert not diff[1:-1, 1:-1].any()


# ------------------------------------------------------------- the GEMM
def _gemm_emulation(x, inv, w, scale, bias):
    """``q8_gemm_kernel`` block by block: the block's BM rows quantized
    once into the A layout (k32 step, k half at lbo = BM * 16, group of 8
    rows at sbo = 128, row, 16 bytes), then N in chunks of NC columns and
    K in stages of SPS steps, each product reading A and the packed B
    through descriptor offsets; acc * scale + bias per chunk, the columns
    past N dropped."""
    bm, nc, sps, _ = K.Q8_GEMM
    m, k = x.shape
    n = w.shape[0]
    packed = K.pack_q8_linear(w)
    chunks, steps = packed.shape[:2]
    kp = steps * 32
    bflat = packed.reshape(-1).to(torch.int64)
    out = torch.empty((m, n), dtype=x.dtype)
    rr, kk = np.meshgrid(np.arange(bm), np.arange(32), indexing="ij")
    a_off = torch.from_numpy((kk // 16) * bm * 16 + (rr // 8) * 128
                             + (rr % 8) * 16 + kk % 16)
    jj, kb = np.meshgrid(np.arange(nc), np.arange(32), indexing="ij")
    b_off = torch.from_numpy((kb // 16) * nc * 16 + (jj // 8) * 128
                             + (jj % 8) * 16 + kb % 16)
    sc = F.pad(scale, (0, chunks * nc - n))
    bi = None if bias is None else F.pad(bias, (0, chunks * nc - n))
    for m0 in range(0, m, bm):
        rows = F.pad(x[m0:m0 + bm], (0, kp - k, 0, bm - len(x[m0:m0 + bm])))
        xq = K.quantize(rows, inv)                       # [BM, Kp]
        xs = torch.empty(steps * bm * 32, dtype=torch.int64)
        for s in range(steps):
            xs[s * bm * 32 + a_off.reshape(-1)] = xq[:, 32 * s:32 * s
                                                     + 32].reshape(-1).long()
        for c in range(chunks):
            acc = torch.zeros((bm, nc), dtype=torch.float64)
            for s in range(steps):                # stages of sps steps
                a = xs[s * bm * 32 + a_off].double()            # [BM, 32]
                bt = bflat[(c * steps + s) * nc * 32 + b_off].double()
                acc += a @ bt.t()
            y = acc.float() * sc[c * nc:(c + 1) * nc]
            if bi is not None:
                y = y + bi[c * nc:(c + 1) * nc]
            cols = min(nc, n - c * nc)
            out[m0:m0 + bm, c * nc:c * nc + cols] = y[:len(x[m0:m0 + bm]),
                                                      :cols].to(x.dtype)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,k,n,with_bias", [
    (37, 256, 768, True), (130, 1024, 256, True), (64, 256, 1024, False),
    (5, 72, 40, True)])
def test_gemm_walk_equals_plain(m, k, n, with_bias, dtype):
    rng = _rng(m + k + n)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(
        dtype)
    w = _int8(rng, (n, k))
    inv = K.f32(127 / 3.1)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, n).astype(np.float32))
    bias = (torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
            if with_bias else None)
    want = K.q8_linear_plain(x, inv, w, scale, bias)
    got = _gemm_emulation(x, inv, w, scale, bias)
    assert torch.equal(got, want)
    assert torch.equal(K.q8_linear(x, inv, w, scale, bias), want)


# -------------------------------------------------------------- Q8Encoder
def test_q8encoder_runs_the_stem_in_three_launches(monkeypatch, tmp_path):
    """Each int8 forward with the stem quantized calls ``q8_stem01`` once
    and ``q8_conv3x3`` twice (conv2, conv3), and the encoder's matmuls 4 a
    layer."""
    from test_torch_decoder_layers import make_small_model

    from kiri_tpu_torch.ops import quant8 as TQ

    *_, model, cfg, _ = make_small_model(tmp_path, 0, IMG_W=64,
                                         COMPUTE_DTYPE="float32")
    calls = {"q8_stem01": 0, "q8_conv3x3": 0, "q8_linear": 0}
    for name in calls:
        real = getattr(TQ, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(TQ, name, spy)
    imgs = _rng(0).integers(0, 256, (2, 48, 64), np.uint8)
    q = TQ.Q8Encoder(model, cfg, device="cpu")
    q.calibrate(imgs)
    q(imgs)
    assert calls == {"q8_stem01": 1, "q8_conv3x3": 2,
                     "q8_linear": 4 * cfg.ENC_LAYERS}
