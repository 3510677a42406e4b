"""kiri_tpu_torch: the PyTorch + CUDA port of kiri_tpu for NVIDIA Hopper.

This slice runs line recognition in CTC mode (``engine.RecognizerEngine``)
with the committed checkpoint, through hand-written CUDA kernels for the
line preprocessing and the conv stem. The package imports neither ``jax``
nor ``kiri_tpu``.
"""
