"""Time cuDNN's depthwise conv of the conformer's conv module on a GPU.

    python3 tools/dwconv_ab.py [--iters N]

At one microbatch of the conformer attack cell, (32, 1024, 999) in bf16 with
31 taps and one group a channel, it times with CUDA events over N calls after
a warm-up: ``F.conv1d``'s forward and ``conv1d_input``'s input gradient on a
contiguous (B, C, T) tensor and on the (B, T, C) view the model hands over
(``layout``), and the model's own ``_DepthwiseConvFn`` forward and backward
together. Beside each: the bytes bound (input and output once, bf16, at
3.35 TB/s) and its share of it, the output's strides, and the bf16
forward's relative error against float32. One JSON line with the card's
name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paa_tpu_torch.models import wav2vec2_conformer  # noqa: E402

B, C, T, K = 32, 1024, 999, 31


def timed(fn, iters: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    bound_ms = 2 * B * C * T * 2 / 3.35e12 * 1e3
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn(C, 1, K, generator=gen, device=dev) * K ** -0.5).bfloat16()
    b = (torch.randn(C, generator=gen, device=dev) * 0.02).bfloat16()
    out = {"card": card.strip(), "shape": [B, C, T, K], "bound_ms": bound_ms}
    for layout in ("BCT", "BTC_view"):
        shape = (B, C, T) if layout == "BCT" else (B, T, C)
        x = torch.randn(shape, generator=gen, device=dev).bfloat16()
        g = torch.randn(shape, generator=gen, device=dev).bfloat16()
        if layout == "BTC_view":
            x, g = x.transpose(1, 2), g.transpose(1, 2)
        fwd = timed(lambda: F.conv1d(x, w, b, padding=K // 2, groups=C), args.iters)
        dgrad = timed(lambda: torch.nn.grad.conv1d_input((B, C, T), w, g, padding=K // 2,
                                                         groups=C), args.iters)
        y = F.conv1d(x, w, b, padding=K // 2, groups=C)
        out[layout] = {"fwd_ms": fwd, "dgrad_ms": dgrad, "out_strides": list(y.stride()),
                       "fwd_bound_pct": 100 * bound_ms / fwd,
                       "dgrad_bound_pct": 100 * bound_ms / dgrad}
    x = torch.randn(B, T, C, generator=gen, device=dev).bfloat16().requires_grad_()

    def module_path():
        y = wrapper(x, w, b, K // 2)
        y.backward(torch.ones_like(y))

    wrapper = wav2vec2_conformer._DepthwiseConvFn.apply
    out["module_fwd_bwd_ms"] = timed(module_path, args.iters)
    x32 = torch.randn(B, C, T, generator=gen, device=dev)
    ref = F.conv1d(x32, w.float(), b.float(), padding=K // 2, groups=C)
    got = F.conv1d(x32.bfloat16(), w, b, padding=K // 2, groups=C).float()
    out["bf16_rel_err"] = float((got - ref).norm() / ref.norm())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
