"""kiri_tpu_torch on the committed checkpoint at float32 on the CPU, against
kiri_tpu's answers stored with the smoke lines
(``scripts/make_torch_smoke_lines.py``): the one-shot streams of "ctc",
"decoder" and "beam" on 6 lines (3 Khmer), every key of every record equal
and ``confidence`` within 1e-4 (a beam record's ``token`` under the port's
rule, see tests/test_torch_stream.py); ``enhance_lines`` on the 16 noisy
crops (u8 and small-noisy flags identical) and ``recognize_crops(...,
enhance=True, sharpen=mask)`` for "ctc" and "decoder"; and "beam" under
``SPEC_BEAM=True`` on 8 lines."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from test_torch_stream import assert_records_equal

from kiri_tpu_torch.engine import RecognizerEngine
from kiri_tpu_torch.kernels.resize import enhance_lines, pack_crops
from kiri_tpu_torch.smoke import load_smoke_lines, noisy_crops

REPO = Path(__file__).resolve().parent.parent
CKPT = str(REPO / "models" / "model.safetensors")


@pytest.fixture(scope="module")
def smoke():
    return load_smoke_lines()


@pytest.fixture(scope="module")
def engine():
    eng = RecognizerEngine.from_checkpoint(CKPT, device="cpu")
    return RecognizerEngine(eng.model, eng.cfg.replace(COMPUTE_DTYPE="float32"),
                            eng.tok, device="cpu")


@pytest.fixture(scope="module")
def six(smoke):
    """Three Khmer and three English smoke lines."""
    d, _ = smoke
    kh = [any(0x1780 <= ord(c) <= 0x17FF for c in str(t)) for t in d["texts"]]
    return ([i for i, k in enumerate(kh) if k][:3]
            + [i for i, k in enumerate(kh) if not k][:3])


@pytest.mark.parametrize("method", ["ctc", "decoder", "beam"])
def test_streams_match_stored_kiri_tpu_records(engine, smoke, six, method):
    d, _ = smoke
    stored = json.loads(str(d["stream_records_f32"]))[method]
    ref = [stored[i] for i in six]
    ours = engine.stream_records_batch(d["imgs"][six], method)
    assert_records_equal(ours, ref, method == "beam", tol=1e-4)
    assert [r[-1]["text"] for r in ours] == [r[-1]["text"] for r in ref]
    assert sum(len(r) for r in ours) > 6 * 3


def test_enhance_lines_matches_stored_kiri_tpu_output(smoke):
    d, _ = smoke
    crops, sharpen = noisy_crops(d)
    buf, sizes = pack_crops(crops)
    out, small_noisy = enhance_lines(torch.from_numpy(buf),
                                     torch.from_numpy(sizes),
                                     torch.from_numpy(sharpen))
    flat = np.concatenate([o[:h, :w].ravel()
                           for o, (h, w) in zip(out.numpy(), sizes)])
    np.testing.assert_array_equal(flat, d["noisy_enhanced_flat"])
    np.testing.assert_array_equal(small_noisy.numpy(),
                                  d["noisy_small_noisy"])
    assert small_noisy.sum() == 4


@pytest.mark.parametrize("method", ["ctc", "decoder"])
def test_enhanced_crops_match_stored_kiri_tpu_answers(engine, smoke, method):
    d, _ = smoke
    crops, sharpen = noisy_crops(d)
    res = engine.recognize_crops(crops, method, enhance=True, sharpen=sharpen)
    key = f"crops_enhance_{method}"
    assert [t for t, _ in res] == [str(t) for t in d[f"{key}_texts_f32"]]
    np.testing.assert_allclose([c for _, c in res], d[f"{key}_conf_f32"],
                               atol=1e-4)


def test_spec_beam_matches_stored_kiri_tpu_answers(engine, smoke):
    d, _ = smoke
    eng = RecognizerEngine(engine.model, engine.cfg.replace(SPEC_BEAM=True),
                           engine.tok, device="cpu")
    res = eng.recognize_batch(d["imgs"][:8], "beam")
    assert [t for t, _ in res] == [str(t) for t in
                                   d["batch_spec_beam_texts_f32"][:8]]
    np.testing.assert_allclose([c for _, c in res],
                               d["batch_spec_beam_conf_f32"][:8], atol=1e-4)
    assert eng.certified_rows == 0     # LM fusion on: nothing certifies
