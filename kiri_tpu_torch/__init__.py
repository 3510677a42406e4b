"""kiri_tpu_torch: the PyTorch + CUDA port of kiri_tpu for NVIDIA Hopper.

``OCR`` (``pipeline.py``) reads pages: DB or CRAFT detection (``detect/``,
the nets on the card and the geometry on the host, ``native/``) or the
classic-CV detector's lines or words (``detect/legacy.py``, on the host),
crops preprocessed on the host (``ops/preprocess.py``, cv2-free) or by the
preprocess kernel, and ``engine.RecognizerEngine`` in every decode method,
whose encoder runs the hand-written stem kernels; ``cli.py`` is its command
line. The package imports neither ``jax`` nor
``kiri_tpu``; ``OCR`` is imported on first use, so ``import kiri_tpu_torch``
works without CUDA.
"""


def __getattr__(name):
    if name == "OCR":
        from .pipeline import OCR

        return OCR
    raise AttributeError(f"module 'kiri_tpu_torch' has no attribute {name!r}")
