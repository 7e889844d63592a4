"""paa_tpu_torch — the PyTorch/CUDA port of ``paa_tpu``.

The JAX package ``paa_tpu`` stays the reference; this package runs the same
attack — the step, the loop and the ``run_attack`` entry point — with plain
PyTorch around hand-written CUDA kernels for the H100
(``paa_tpu_torch/csrc``). It never imports ``jax``, ``flax`` or ``optax``;
it reuses only ``paa_tpu``'s modules that import none of them (``ops.iso226``,
``ops.text``, ``ops.wer``, ``models.checkpoint_io``, ``data.synthetic``,
``data.datasets`` and the JAX-free ``train`` helpers).
"""
