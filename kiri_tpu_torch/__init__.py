"""kiri_tpu_torch: the PyTorch + CUDA port of kiri_tpu for NVIDIA Hopper.

``OCR`` (``pipeline.py``) reads pages: DB (a native checkpoint or a PP-OCR
``.onnx`` graph, ``utils/onnx_import.py``) or CRAFT detection
(``detect/``, the nets on the card and the geometry on the host,
``native/``) or the classic-CV detector's lines or words
(``detect/legacy.py``, on the host), crops preprocessed on the host
(``ops/preprocess.py``, cv2-free) or by the preprocess kernel, and
``engine.RecognizerEngine`` in every decode method, whose encoder runs the
hand-written stem kernels; ``KiriOCR`` is the model-class facade and
``cli.py`` the command line. Recognizer files load in every format of
``checkpoints.py``; a repo id (``"org/name"``) is looked up on the
Hugging Face hub. The package imports neither ``jax`` nor ``kiri_tpu``;
the names below are imported on first use, as in ``kiri_tpu``, so
``import kiri_tpu_torch`` works without CUDA.
"""
__version__ = "0.1.0"

_LAZY = {
    "OCR": ("kiri_tpu_torch.pipeline", "OCR"),
    "CFG": ("kiri_tpu_torch.config", "CFG"),
    "CharTokenizer": ("kiri_tpu_torch.tokenizer", "CharTokenizer"),
    "TextDetector": ("kiri_tpu_torch.detect", "TextDetector"),
    "DocumentRenderer": ("kiri_tpu_torch.renderer", "DocumentRenderer"),
    "TextBox": ("kiri_tpu_torch.detect.base", "TextBox"),
    "DetectionLevel": ("kiri_tpu_torch.detect.base", "DetectionLevel"),
    "KiriOCR": ("kiri_tpu_torch.models.recognizer", "KiriOCR"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'kiri_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals().keys()) + list(_LAZY.keys()))
