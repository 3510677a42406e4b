"""DB detection from a ``.onnx`` graph in kiri_tpu_torch against kiri_tpu on
the CPU: the PP-OCR det graph of the smoke fixture
(``kiri_tpu_torch.smoke.build_ppocr_det``, conditioned) over committed
pages, through ``DBDetector`` per page and batched (u16 maps within 8
counts, the card's DB rule; quads and scores as kiri_tpu's where the map's
margin from the threshold exceeds that), through ``TextDetector`` and
``OCR``; the small ink graph of tests/test_onnx_import.py; and the stored
answers of ``smoke_models.npz`` (kiri_tpu's) for the port on the same
pages. cv2 runs with IPP off (see tests/test_torch_imgproc.py)."""
from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np
import pytest
from test_torch_decoder_layers import few_torch_threads  # noqa: F401
from torch_pages import small_ckpt  # noqa: F401

from kiri_tpu.detect import TextDetector as JTextDetector
from kiri_tpu.detect.db import DBDetector as JDBDetector
from kiri_tpu.ops.preprocess import invert_if_dark
from kiri_tpu.utils import onnx_pb as jpb
from kiri_tpu_torch import smoke as S
from kiri_tpu_torch.detect import TextDetector
from kiri_tpu_torch.detect.db import DBDetector

MAP_TOL = 8


@pytest.fixture(scope="module", autouse=True)
def no_ipp():
    before = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(before)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    data = S.build_ppocr_det(seed=S.ONNX_SEED, conditioned=True,
                             head_gain=S.ONNX_HEAD_GAIN,
                             head_bias=S.ONNX_HEAD_BIAS)
    p = tmp_path_factory.mktemp("onnx") / "det.onnx"
    p.write_bytes(data)
    return str(p)


@pytest.fixture(scope="module")
def pages():
    return [p["image"] for p in S.load_smoke_pages()["pages"]]


@pytest.fixture(scope="module")
def stored():
    return S.load_smoke_models()


@pytest.fixture(scope="module")
def dets(graph):
    return DBDetector(graph, device="cpu"), JDBDetector(graph)


def _wire(det, page):
    canvas, (nh, nw), _ = det._resize_image(invert_if_dark(
        det._to_gray(page)))
    return canvas, (nh, nw)


@pytest.mark.parametrize("i", [S.ONNX_PAGES[0], S.ONNX_PAGES[1]])
def test_map_and_quads_equal_kiri_tpu(dets, pages, stored, i):
    det, jdet = dets
    canvas, (nh, nw) = _wire(det, pages[i])
    got = det.forward_wire(canvas[None]).numpy()[0].astype(np.int64)
    want = np.asarray(jdet._fwd(jdet.variables, canvas)).astype(np.int64)
    assert np.abs(got - want).max() <= MAP_TOL
    # The stored map is kiri_tpu's (made on a CPU, maybe another one).
    assert np.abs(want - stored[f"onnx_map_{i}"]).max() <= MAP_TOL
    margin = stored[f"onnx_margin_{i}"]
    assert margin[0] > MAP_TOL and margin[1] > MAP_TOL / 65535
    ours, ref = det.detect_text(pages[i]), jdet.detect_text(pages[i])
    assert len(ours) == len(ref) > 0
    for (q, s), (jq, js) in zip(ours, ref):
        assert np.array_equal(q, jq)
        assert abs(s - js) <= MAP_TOL / 65535
    assert [[q.tolist(), pytest.approx(s, abs=MAP_TOL / 65535)]
            for q, s in ours] == stored["onnx_quads"][str(i)]


def test_batched_equals_per_page(dets, pages):
    det, _ = dets
    imgs = [pages[i] for i in S.ONNX_PAGES]
    batched = det.detect_text_batch(imgs)
    for img, res in zip(imgs, batched):
        one = det.detect_text(img)
        assert len(one) == len(res)
        for (q, s), (bq, bs) in zip(one, res):
            assert np.array_equal(q, bq) and s == bs
    maps = det.predict_maps_batch([invert_if_dark(det._to_gray(p))
                                   for p in imgs])
    for img, (prob, info) in zip(imgs, maps):
        p1, info1 = det.predict_maps(invert_if_dark(det._to_gray(img)))
        assert info == info1 and np.array_equal(prob, p1)


def test_text_detector_facade_and_downsample(graph, pages):
    i = S.ONNX_PAGES[1]
    ours = TextDetector("db", graph, device="cpu")
    ref = JTextDetector("db", graph)
    assert ours.db_detector.onnx is not None and ours.db_detector.net is None
    assert ours.detect_lines(pages[i]) == ref.detect_lines(pages[i])
    objs = [b.bbox for b in ours.detect_lines_objects_batch(
        [pages[i], pages[S.ONNX_PAGES[0]]])[0]]
    assert objs == ref.detect_lines(pages[i])
    ds = DBDetector(graph, device="cpu", det_map_downsample=2)
    jds = JDBDetector(graph, det_map_downsample=2)
    canvas, _ = _wire(ds, pages[i])
    got = ds.forward_wire(canvas[None]).numpy()[0].astype(np.int64)
    want = np.asarray(jds._fwd(jds.variables, canvas)).astype(np.int64)
    assert got.shape == (canvas.shape[0] // 2, canvas.shape[1] // 2)
    assert np.abs(got - want).max() <= MAP_TOL


def test_ocr_pages_equal_stored(graph, pages, stored):
    """``OCR(det_model_path=det.onnx)`` in float32 "fast" gives kiri_tpu's
    stored boxes and texts (confidences within 1e-4), per page and
    pooled."""
    from kiri_tpu_torch.pipeline import OCR

    OCR._model_cache.clear()
    ocr = OCR(det_model_path=graph, decode_method="fast", use_fp16=False,
              device="cpu")
    imgs = [pages[i] for i in S.ONNX_OCR_PAGES]
    per_page = [ocr.process_document(im) for im in imgs]
    for got, want in zip(per_page, stored["onnx_ocr"]):
        assert [(r["box"], r["text"], r["line_number"]) for r in got] == [
            (r["box"], r["text"], r["line_number"]) for r in want]
        for r, w in zip(got, want):
            assert abs(r["confidence"] - w["confidence"]) <= 1e-4
            assert abs(r["det_confidence"] - w["det_confidence"]) <= 1e-4
    # The pooled path's batched detection gives the per-page results.
    for got, want in zip(ocr.process_documents(imgs), per_page):
        assert [(r["box"], r["text"]) for r in got] == [
            (r["box"], r["text"]) for r in want]
        for r, w in zip(got, want):
            assert abs(r["confidence"] - w["confidence"]) <= 1e-4


def test_tiny_ink_graph(tmp_path):
    """The ink graph of tests/test_onnx_import.py (conv -> sigmoid): the
    same map as kiri_tpu, ink high and paper low, and the batch path."""
    w = np.full((1, 3, 3, 3), -1.0, np.float32)
    b = np.array([-10.0], np.float32)
    nodes = [jpb.write_node("Conv", ["x", "w", "b"], ["l"],
                            kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
             jpb.write_node("Sigmoid", ["l"], ["p"])]
    path = tmp_path / "tiny_db.onnx"
    path.write_bytes(jpb.write_model(nodes, {"w": w, "b": b},
                                     [("x", [None, 3, None, None])],
                                     [("p", [None, 1, None, None])]))
    det = DBDetector(str(path), device="cpu")
    jdet = JDBDetector(str(path))
    page = np.full((96, 128), 255, np.uint8)
    page[40:56, 30:100] = 0
    prob, info = det.predict_maps(page)
    jprob, jinfo = jdet.predict_maps(page)
    assert info == jinfo == (96, 128, 96, 128)
    assert np.abs(prob - jprob).max() * 65535 <= MAP_TOL
    assert prob[46, 60] > 0.9 and prob[10, 10] < 0.1
    assert len(list(det._iter_maps_batch([page, page]))) == 2
    assert [q.tolist() for q in det.detect(page)] == [
        q.tolist() for q in jdet.detect(page)]


def test_missing_onnx_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        DBDetector(str(tmp_path / "absent.onnx"), device="cpu")


def test_predict_cli_with_pt_model_and_onnx_detector(graph, pages, tmp_path,
                                                     small_ckpt):
    """``predict --model <.pt> --det-model <.onnx>`` in both command lines
    writes the same results."""
    import json

    import torch

    from kiri_tpu import cli as jcli
    from kiri_tpu_torch import cli as tcli
    from kiri_tpu_torch.checkpoints import read_safetensors
    from torch_pages import same_dicts

    src = Path(small_ckpt)
    meta = json.loads((src.parent / "model_meta.json").read_text())
    pt = tmp_path / "model.pt"
    torch.save({"config": meta["config"], "model": {
        k: torch.from_numpy(v) for k, v in read_safetensors(src).items()},
        "vocab_path": str(src.parent / "vocab.json")}, str(pt))
    page = tmp_path / "page.png"
    cv2.imwrite(str(page), pages[S.ONNX_OCR_PAGES[1]])
    args = [str(page), "--model", str(pt), "--det-model", graph,
            "--decode-method", "fast", "--device", "cpu", "--no-render"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jcli.main(["predict", *args, "-o", str(jdir)])
    assert tcli.main(["predict", *args, "-o", str(tdir)]) == 0
    got = json.loads((tdir / "ocr_results.json").read_text())
    same_dicts(got, json.loads((jdir / "ocr_results.json").read_text()))
    assert len(got) > 0
