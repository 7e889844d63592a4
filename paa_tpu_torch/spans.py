"""Named ranges of the program's work, on the profiler's clock.

Each span is a ``torch.profiler.record_function`` range, so it lands in the
same Kineto trace as the device's kernels and copies (``run_attack
--profile`` writes it), on the device trace's clock. With no profiler
running :func:`span` opens nothing and costs under a microsecond of host
time, where entering and leaving a ``record_function`` costs about 14 (torch
2.13 on a CPU host). A span is always closed before a ``yield`` or a return.
"""

from __future__ import annotations

import contextlib

import torch

SPANS = (
    "paa.feed",  # forming a batch on the device
    "paa.fe",  # FeatureExtractor.forward
    "paa.pos_conv",  # PositionalConvEmbedding.forward, inside paa.encoder
    "paa.encoder",  # Encoder.forward, ConformerEncoder.forward
    "paa.attention",  # the model's call into the attention kernels
    "paa.relpos",  # the relative conformer's biased queries and tables, inside paa.encoder
    "paa.conv_module",  # ConvolutionModule.forward, inside paa.encoder (the conformer)
    "paa.dwconv",  # inside paa.conv_module: the depthwise conv call
    "paa.ctc",  # the CTC loss of a microbatch or an eval batch
    "paa.update",  # the optimizer update and the projection of a step
    "paa.score",  # the host's scoring of an epoch's or a pass's batches
    "paa.score.wait",  # inside paa.score: a read of the device
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """The range ``name`` (one of :data:`SPANS`) while a profiler runs; else
    a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
