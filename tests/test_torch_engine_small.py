"""kiri_tpu_torch's RecognizerEngine against kiri_tpu's engine, both live on
the CPU at float32 over the small random model of
tests/test_torch_decoder_layers.py: every decoder method (plain batch,
width-bucketed, crops), the step-loop fallback, the raw selection and 4-bit
uploads. Texts must be equal, confidences agree within 1e-4."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads, make_small_model  # noqa: F401

from kiri_tpu import engine as JE
from kiri_tpu.engine import RecognizerEngine as JEngine
from kiri_tpu_torch import engine as E
from kiri_tpu_torch.engine import RecognizerEngine


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """kiri_tpu's engine and the port's over one small random model, whose
    random CTC drafts rarely agree with its decoder."""
    variables, jcfg, jtok, model, cfg, tok = make_small_model(
        tmp_path_factory.mktemp("small"), EOS_LOGP_BIAS=6.0,
        EOS_LOGP_BOOST=2.0, EOS_BIAS_UNTIL_LEN=7)
    return variables, jcfg, jtok, model, cfg, tok


def _small_inputs(n, seed=9):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (n, 48, 160), dtype=np.uint8)
    widths = np.asarray([160, 96, 160, 64, 160, 90, 30][:n], np.int32)
    crops = [rng.integers(0, 255, (h, w), dtype=np.uint8)
             for h, w in ((30, 90), (48, 200), (64, 120))]
    return imgs, widths, crops


def _check_live(ours, ref):
    assert [t for t, _ in ours] == [t for t, _ in ref]
    np.testing.assert_allclose([c for _, c in ours], [c for _, c in ref],
                               atol=1e-4)


@pytest.mark.parametrize("method,path", [
    ("decoder", "batch"), ("decoder", "bucketed"), ("decoder", "crops"),
    ("beam", "bucketed"), ("beam", "crops"), ("auto", "batch"),
    ("auto", "bucketed")])
def test_small_model_matches_kiri_tpu_engine(small, method, path):
    variables, jcfg, jtok, model, cfg, tok = small
    imgs, widths, crops = _small_inputs(5)
    jeng = JEngine(variables, jcfg, jtok)
    eng = RecognizerEngine(model, cfg, tok, device="cpu")
    if path == "batch":        # 3 lines: no batch bucket
        ours = eng.recognize_batch(imgs[:3], method)
        ref = jeng.recognize_batch(imgs[:3], method)
    elif path == "bucketed":
        ours = eng.recognize_batch(imgs, method, widths)
        ref = jeng.recognize_batch(imgs, method, widths=widths)
    else:
        ours = eng.recognize_crops(crops, method)
        ref = jeng.recognize_crops(crops, method)
    _check_live(ours, ref)
    assert any(t for t, _ in ours)


def test_small_model_fallback_matches_kiri_tpu_engine(small):
    """One round is never enough for a random draft: every row goes through
    ``_step_redecode`` and still reads as kiri_tpu's engine reads it, which
    is what the unbounded drafted loop gives without the rescore."""
    variables, jcfg, jtok, model, cfg, tok = small
    imgs, widths, _ = _small_inputs(5)
    one = dict(SPEC_MAX_ROUNDS=1, ACCURATE_CTC_RESCORE=False)
    eng = RecognizerEngine(model, cfg.replace(**one), tok, device="cpu")
    ours = eng.recognize_batch(imgs, "decoder", widths)
    assert eng.fallback_rows == 5
    _check_live(ours, JEngine(variables, jcfg.replace(**one), jtok
                              ).recognize_batch(imgs, "decoder",
                                                widths=widths))
    free = RecognizerEngine(model, cfg.replace(ACCURATE_CTC_RESCORE=False),
                            tok, device="cpu")
    _check_live(ours, free.recognize_batch(imgs, "decoder", widths))
    assert free.fallback_rows == 0
    off = RecognizerEngine(model, cfg.replace(SPEC_DECODE=False), tok,
                           device="cpu")
    _check_live(ours, off.recognize_batch(imgs, "decoder", widths))


def test_single_hyp_raw_selection_with_and_without_the_draft(small):
    """Greedy streaming's selection (argmax of the raw logits): the drafted
    loop, the step loop and the step loop over gathered rows agree."""
    _, _, _, model, cfg, tok = small
    imgs, _, _ = _small_inputs(4)
    outs = []
    for spec in (True, False):
        eng = RecognizerEngine(
            model, cfg.replace(SPEC_DECODE=spec, SPEC_MAX_ROUNDS=0), tok,
            device="cpu")
        e = eng._encode_u8(imgs)
        tl = e.est.clamp(min=0)
        outs.append(eng._launch_single_hyp(e.memp, e.ctc, e.ids, tl, e.conf,
                                           16, 16, raw_select=True))
    assert torch.equal(outs[0].tokens, outs[1].tokens)
    assert torch.equal(outs[0].lengths, outs[1].lengths)
    fb = eng._step_redecode(e, tl.numpy(), [2, 0, 3], 16, raw_select=True)
    assert fb.tokens.shape[0] == 4
    assert torch.equal(fb.tokens[:3], outs[1].tokens[[2, 0, 3]])


def test_upload_bits4_matches_kiri_tpu_pack4_path(small):
    variables, jcfg, jtok, model, cfg, tok = small
    imgs, widths, _ = _small_inputs(5)
    packed = E.pack4(imgs)
    np.testing.assert_array_equal(packed, JE.pack4(imgs))
    assert packed.shape == (5, 48, 80) and packed.dtype == np.uint8
    levels = E._unpack4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(
        levels, np.asarray(JE._unpack4(jnp.asarray(packed))))
    assert set(np.unique(levels)) <= set(range(0, 256, 17))
    eng = RecognizerEngine(model, cfg, tok, device="cpu", upload_bits=4)
    jeng = JEngine(variables, jcfg, jtok, upload_bits=4)
    _check_live(eng.recognize_batch(imgs, "ctc", widths),
                jeng.recognize_batch(imgs, "ctc", widths=widths))
    # The packed upload is the 16-level image, in every method: it reads as
    # the quantized lines read through the 8-bit upload, and not as the
    # unquantized ones.
    full = RecognizerEngine(model, cfg, tok, device="cpu")
    for method in ("decoder", "beam"):
        _check_live(eng.recognize_batch(imgs, method, widths),
                    full.recognize_batch(levels, method, widths))
    a, b = eng.encode_batch(imgs)[1], full.encode_batch(imgs)[1]
    assert float((a - b).abs().max()) > 1e-4
