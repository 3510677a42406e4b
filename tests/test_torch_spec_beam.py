"""The certificate-gated speculative beam of kiri_tpu_torch (``cfg.SPEC_BEAM``:
``ops/decode.beam_spec_certificate``, ``RecognizerEngine.beam_device_spec``
and ``beam_device_bucketed``) on the CPU at float32.

The certificate against kiri_tpu's on the committed checkpoint, live: with
LM fusion on (the checkpoint's setting) it certifies no line, as kiri_tpu's
docstring records; with ``USE_LM_FUSION_EVAL=False`` it certifies most, and
the bool vectors are equal in both. ``"beam"`` under ``SPEC_BEAM=True``
reads exactly as the step-loop beam, on the small random model (no row
certified) and on the checkpoint with fusion off (most rows certified), on
a batch of 3, where kiri_tpu's ``SPEC_BEAM`` branch raises IndexError (it
indexes the padding rows), and of 8."""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads, make_small_model  # noqa: F401

from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu.ops import decode as JD
from kiri_tpu.tokenizer import CharTokenizer as JTok
from kiri_tpu.train.checkpoints import find_vocab_file as j_vocab
from kiri_tpu.train.checkpoints import load_checkpoint as j_load
from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.ops import decode as D
from kiri_tpu_torch.smoke import load_smoke_lines

REPO = Path(__file__).resolve().parent.parent
CKPT = str(REPO / "models" / "model.safetensors")
# The setting in which the certificate certifies lines of the checkpoint.
NO_FUSION = dict(USE_LM_FUSION_EVAL=False)


@pytest.fixture(scope="module")
def ckpt():
    """(kiri_tpu's variables, cfg and tokenizer, the port's engine) at
    float32, and 8 smoke lines."""
    variables, jcfg, meta = j_load(CKPT)
    jcfg = jcfg.replace(COMPUTE_DTYPE="float32")
    jtok = JTok(j_vocab(meta["vocab_path"], CKPT), jcfg)
    eng = RecognizerEngine.from_checkpoint(CKPT, device="cpu")
    eng = RecognizerEngine(eng.model, eng.cfg.replace(COMPUTE_DTYPE="float32"),
                           eng.tok, device="cpu")
    return variables, jcfg, jtok, eng, load_smoke_lines()[0]["imgs"][:8]


def _certify_jax(jeng, imgs):
    memp, ctc, ids, conf, est, n = jeng.encode_batch(imgs)
    est_np = np.asarray(est)
    tl = jnp.asarray(np.where(est_np > 0, est_np, 0).astype(np.int32))
    l_cap = jeng._step_cap(est_np, n, memp.shape[1])
    tok = jeng.tok
    ids_kw = dict(eos_id=tok.dec_eos, unk_dec_id=tok.unk_id + tok.dec_offset,
                  dec_offset=tok.dec_offset)
    spec = JD.spec_decode(jeng.variables, memp, ids, tl, conf, cfg=jeng.cfg,
                          l_cap=l_cap, bos_id=tok.dec_bos,
                          max_rounds=jeng.cfg.SPEC_MAX_ROUNDS, **ids_kw)
    return np.asarray(JD.beam_spec_certificate(
        jeng.variables, memp, ctc, tl, spec.tokens, spec.lengths,
        cfg=jeng.cfg, k_beam=jeng.cfg.BEAM, l_cap=l_cap, **ids_kw))


def _certify(eng, imgs):
    e = eng._encode_u8(imgs)
    est_np = e.est.numpy()
    tl = torch.from_numpy(np.where(est_np > 0, est_np, 0).astype(np.int32))
    l_cap = eng._step_cap(est_np, e.n, e.memp.shape[1])
    with torch.inference_mode():
        spec = D.spec_decode(eng.model, e.memp, e.ids, tl, e.conf,
                             cfg=eng.cfg, l_cap=l_cap,
                             max_rounds=eng.cfg.SPEC_MAX_ROUNDS, **eng._ids)
        return D.beam_spec_certificate(
            eng.model, e.memp, e.ctc, tl, spec.tokens, spec.lengths,
            cfg=eng.cfg, k_beam=eng.cfg.BEAM, l_cap=l_cap,
            eos_id=eng.tok.dec_eos, unk_dec_id=eng._ids["unk_dec_id"],
            dec_offset=eng.tok.dec_offset).numpy()


@pytest.mark.parametrize("fusion", [True, False])
def test_certificate_matches_kiri_tpu(ckpt, fusion):
    variables, jcfg, jtok, eng, imgs = ckpt
    over = dict(USE_LM_FUSION_EVAL=fusion)
    want = _certify_jax(JEngine(variables, jcfg.replace(**over), jtok), imgs)
    got = _certify(RecognizerEngine(eng.model, eng.cfg.replace(**over),
                                    eng.tok, device="cpu"), imgs)
    assert got.dtype == bool and got.shape == (8,)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 0 if fusion else got.sum() >= 6


def test_certificate_is_off_where_its_argument_does_not_hold(ckpt):
    _, _, _, eng, imgs = ckpt
    for over in (dict(BEAM=1), dict(EOS_LOGP_BOOST=0.5),
                 dict(EOS_LOGP_BIAS=-1.0), dict(BEAM_LENP=-0.2)):
        e = RecognizerEngine(eng.model, eng.cfg.replace(**NO_FUSION, **over),
                             eng.tok, device="cpu")
        assert not _certify(e, imgs[:2]).any()


@pytest.mark.parametrize("n", [3, 8])
def test_spec_beam_reads_as_the_step_loop_on_the_checkpoint(ckpt, n):
    variables, jcfg, jtok, eng, imgs = ckpt
    cfg = eng.cfg.replace(**NO_FUSION)
    step = RecognizerEngine(eng.model, cfg, eng.tok, device="cpu")
    spec = RecognizerEngine(eng.model, cfg.replace(SPEC_BEAM=True), eng.tok,
                            device="cpu")
    want = step.recognize_batch(imgs[:n], "beam")
    got = spec.recognize_batch(imgs[:n], "beam")
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want],
                               atol=1e-4)
    assert spec.certified_rows >= n - 2
    if n == 8:
        ref = JEngine(variables, jcfg.replace(**NO_FUSION), jtok)
        assert [t for t, _ in want] == [t for t, _ in
                                        ref.recognize_batch(imgs, "beam")]
    else:
        ref_spec = JEngine(variables, jcfg.replace(**NO_FUSION,
                                                   SPEC_BEAM=True), jtok)
        with pytest.raises(IndexError):
            ref_spec.recognize_batch(imgs[:n], "beam")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    variables, jcfg, jtok, model, cfg, tok = make_small_model(
        tmp_path_factory.mktemp("small"))
    return RecognizerEngine(model, cfg, tok, device="cpu")


@pytest.fixture(scope="module")
def imgs_small():
    return np.random.default_rng(4).integers(0, 255, (8, 48, 160),
                                             dtype=np.uint8)


@pytest.mark.parametrize("n", [3, 8])
def test_spec_beam_reads_as_the_step_loop_on_the_small_model(
        small, imgs_small, n):
    spec = RecognizerEngine(small.model, small.cfg.replace(SPEC_BEAM=True),
                            small.tok, device="cpu")
    want = small.recognize_batch(imgs_small[:n], "beam")
    got = spec.recognize_batch(imgs_small[:n], "beam")
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([c for _, c in got], [c for _, c in want],
                               atol=1e-4)
    widths = np.asarray([160, 60, 100, 160, 30, 96, 160, 64][:n])
    assert [t for t, _ in spec.recognize_batch(imgs_small[:n], "beam",
                                               widths)] == [
        t for t, _ in small.recognize_batch(imgs_small[:n], "beam", widths)]


def test_beam_device_bucketed_covers_every_row_once(small, imgs_small):
    """Chunks of 2 rows sorted by budget, each with its own step bucket:
    every row once, and the texts of one beam search over the batch."""
    e = small._encode_u8(imgs_small[:7])
    est_np = e.est.numpy()[:7].copy()
    est_np[[1, 4]] = (0, 9)       # a line without an estimate, a long one
    launched = small.beam_device_bucketed(e.memp, e.ctc, est_np, e.conf,
                                          chunk=2)
    rows = np.concatenate([r for r, _ in launched])
    assert sorted(rows.tolist()) == list(range(7)) and len(launched) == 4
    budgets = D.max_decode_steps_host(small.cfg, est_np, e.memp.shape[1])
    for r, dec in launched:
        assert dec.tokens.shape[0] in small.cfg.BATCH_BUCKETS
        assert list(budgets[r]) == sorted(budgets[r])
    texts = {}
    for r, dec in launched:
        for i, t in zip(r, small._decode_texts(dec.tokens[:len(r)].numpy(),
                                               dec.lengths.numpy())):
            texts[int(i)] = t
    l_cap = small._step_cap(est_np, 7, e.memp.shape[1])
    tl = torch.from_numpy(est_np.astype(np.int32))
    one = small._launch_beam(e.memp[:7], e.ctc[:7], tl, e.conf[:7], l_cap,
                             l_cap, small.cfg.BEAM)
    assert [texts[i] for i in range(7)] == small._decode_texts(
        one.tokens.numpy(), one.lengths.numpy())
