"""edl_tpu_torch — the PyTorch/CUDA port of ``edl_tpu``.

The JAX package beside it is the reference; this package mirrors its
module paths and holds each ported module to it (tests/test_torch_*.py).
It imports torch and never jax, and nothing from ``edl_tpu``. Entry
points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: Llama serving through the continuous-batching engine
(``serving.engine``), with prefill attention on the hand-written Hopper
kernel ``ops/csrc/flash_fwd.cu``; one-card training of Llama, CTR,
fit_a_line, ResNet and BERT (``train.trainer``); exports and the
scoring consumer of every ported family (``runtime.export``,
``runtime.predict``). ``python -m edl_tpu_torch serve`` and
``python -m edl_tpu_torch predict`` are the command-line entries.
"""
