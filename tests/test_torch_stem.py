"""kiri_tpu_torch's stem (plain version, BN fold, CPU dispatch of the kernel
wrapper) against kiri_tpu's XLA stem and its Pallas kernel."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiri_tpu.config import CFG as JCFG
from kiri_tpu.kernels.stem import fold_stem_weights as j_fold
from kiri_tpu.kernels.stem import stem_fused_tpu
from kiri_tpu.models import recognizer as R
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu_torch.convert import state_dict_from_jax
from kiri_tpu_torch.kernels.stem import fold_stem_weights, stem_fused, stem_plain
from kiri_tpu_torch.models.recognizer import Stem


@pytest.fixture(scope="module")
def stems(tmp_path_factory):
    """(kiri_tpu stem params, stats, the port's Stem) with non-trivial BN
    statistics, so the fold itself is exercised."""
    tmp = tmp_path_factory.mktemp("stem")
    (tmp / "v.json").write_text(json.dumps({"<unk>": 0, "a": 1}))
    cfg = JCFG(COMPUTE_DTYPE="float32")
    variables = R.init_recognizer(jax.random.PRNGKey(0), cfg,
                                  JTok(str(tmp / "v.json"), cfg))
    rng = np.random.default_rng(1)
    for i in range(4):
        bn = variables["batch_stats"]["stem"][f"bn{i}"]
        bn["mean"] = rng.normal(0, 0.3, bn["mean"].shape).astype(np.float32)
        bn["var"] = (np.abs(rng.normal(0, 1, bn["var"].shape)) + 0.5
                     ).astype(np.float32)
        p = variables["params"]["stem"][f"bn{i}"]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, {
        k: variables[k] for k in ("params", "batch_stats")}))
    stem = Stem(cfg.ENC_DIM)
    stem.load_state_dict({k[len("stem."):]: v for k, v in sd.items()
                          if k.startswith("stem.")}, strict=True)
    return (variables["params"]["stem"], variables["batch_stats"]["stem"],
            stem.eval())


def _jax_stem(stems, x, dtype=jnp.float32):
    p, s, _ = stems
    out, _ = R.stem_forward(p, s, jnp.asarray(x, dtype)[..., None],
                            JCFG(COMPUTE_DTYPE="float32"), train=False)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("w", [160, 320, 480, 640])
def test_stem_plain_matches_xla_stem(stems, w):
    x = np.random.default_rng(w).standard_normal((2, 48, w)).astype(np.float32)
    with torch.inference_mode():
        folded = fold_stem_weights(stems[2].net, torch.float32)
        got = stem_plain(torch.from_numpy(x), folded).numpy()
    assert got.shape == (2, 6, w // 4, 256)
    np.testing.assert_allclose(got, _jax_stem(stems, x), atol=2e-5, rtol=1e-5)


def test_stem_plain_all_zero_image(stems):
    """Pure bias/SiLU propagation from the zero edge."""
    x = np.zeros((1, 48, 160), np.float32)
    with torch.inference_mode():
        got = stem_fused(torch.from_numpy(x),
                         fold_stem_weights(stems[2].net, torch.float32))
    np.testing.assert_allclose(got.numpy(), _jax_stem(stems, x), atol=2e-5,
                               rtol=1e-5)


def test_stem_plain_matches_pallas_kernel(stems):
    p, s, stem = stems
    x = np.random.default_rng(5).standard_normal((1, 48, 160)).astype(
        np.float32)
    want = stem_fused_tpu(jnp.asarray(x), j_fold(p, s, jnp.float32),
                          interpret=True, w_tiles=1)
    with torch.inference_mode():
        got = stem_plain(torch.from_numpy(x),
                         fold_stem_weights(stem.net, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_matches_kiri_tpu(stems, dtype):
    p, s, stem = stems
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_fold(p, s, jdt)
    with torch.inference_mode():
        got = fold_stem_weights(stem.net, dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == (torch.float32 if i % 2 or i == 0 else dtype)
        w = np.asarray(w, np.float32).reshape(tuple(g.shape))
        # bf16 weights may round one ulp (2^-8) apart after the fold.
        rtol = 1e-6 if g.dtype == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=1e-6)


def test_stem_bf16_plain_rounds_like_the_kernel(stems):
    """bf16: the port rounds each layer's float32 sum once to bf16 and keeps
    conv0's weights in float32; the XLA stem in bf16 rounds conv0's weights
    and each conv's output before the bias, so agreement is to bf16 scale."""
    x = np.random.default_rng(9).standard_normal((1, 48, 160)).astype(
        np.float32)
    with torch.inference_mode():
        got = stem_plain(torch.from_numpy(x).bfloat16(),
                         fold_stem_weights(stems[2].net, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref = _jax_stem(stems, x, jnp.bfloat16)
    assert np.abs(got.float().numpy() - ref).max() <= 0.05 * np.abs(ref).max()
