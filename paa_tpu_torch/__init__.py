"""paa_tpu_torch — the PyTorch/CUDA port of ``paa_tpu``.

The JAX package ``paa_tpu`` stays the reference; this package computes the
same attack step with plain PyTorch around hand-written CUDA kernels for the
H100 (``paa_tpu_torch/csrc``). It never imports ``jax``, ``flax`` or
``optax``; it reuses only ``paa_tpu``'s numpy-only modules
(``ops.iso226``, ``ops.text``, ``models.checkpoint_io``, ``data.synthetic``).
"""
