"""paa_tpu_torch — the PyTorch/CUDA port of ``paa_tpu``.

The JAX package ``paa_tpu`` stays the reference; this package runs the same
attack — the step, the loop and the ``run_attack`` entry point — with plain
PyTorch around hand-written CUDA kernels for the H100
(``paa_tpu_torch/csrc``). It imports nothing of ``paa_tpu`` and never
``jax``, ``flax`` or ``optax``: the modules of ``paa_tpu`` that need no JAX
(``ops.iso226``, ``ops.text``, ``ops.wer``, ``models.checkpoint_io``,
``data.synthetic``, ``data.datasets``, ``data.flac`` and the ``train``
helpers) have their own copies here, and their C helpers build into
``build/paa_tpu_torch/``.
"""
