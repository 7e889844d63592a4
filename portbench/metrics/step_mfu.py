"""The batches' FLOPs (portbench/counts.py) over the traced window's seconds at
the bf16 peak, in %."""

from portbench.counts import PEAK_BF16_FLOPS as PEAK


def read(s: dict):
    return 100.0 * s["batch_flops"] * s["batches"] / (s["window_s"] * PEAK)
