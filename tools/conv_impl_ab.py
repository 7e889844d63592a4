"""Time the feature extractor's conv lowerings on a GPU, layer by layer.

    python3 tools/conv_impl_ab.py [base|lv60] [--impls conv,hybrid,...] [--iters N]

For ``base`` (wav2vec2-base, one microbatch of 64 × 10 s) and ``lv60``
(wav2vec2-large-lv60, one microbatch of 32 × 20 s, as phase 5 splits its
64 rows in two), random weights from seed 0 stored in bf16, bf16 compute,
and each lowering of ``--impls`` (``Wav2Vec2Config.conv_impl``, all five by
default) it prints one JSON line:

  * per conv layer, at the input one forward of the feature extractor gives
    it: the conv alone (``models/wav2vec2.py:feature_conv``, no bias) forward
    and its input gradient (``torch.autograd.grad`` with respect to the
    layer's input, a random output gradient), ms a call by CUDA events over
    ``--iters`` calls, the memory the gradient call allocates above what was
    allocated before it (GiB), and the FLOPs a conv needs, 2·B·T_out·C_out·
    C_in·k, beside the time that takes at the bf16 dense peak (989 TFLOP/s);
  * the whole feature extractor (convs, bias, norms, GELU): forward with
    grad on and its backward to the waveform, ms by CUDA events around each
    over ``--iters`` rounds, and the peak of those rounds.

``chip_smoke.py`` calls ``with_config`` (phases 11 and 12) and
``fe_times`` (phase 12). Needs one CUDA device; it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paa_tpu_torch import runtime  # noqa: E402
from paa_tpu_torch.models import wav2vec2  # noqa: E402

IMPLS = ("conv", "hybrid", "pairdot", "im2col", "tapdot")
PRESETS = {  # name: (model, microbatch rows, samples)
    "base": ("wav2vec2-base", 64, 160_000),
    "lv60": ("wav2vec2-large-lv60", 32, 320_000),
}
PEAK_BF16 = 989e12


def with_config(base: wav2vec2.Wav2Vec2ForCTC, **over) -> wav2vec2.Wav2Vec2ForCTC:
    """``base``'s weights, the same tensors, under its config with ``over``."""
    with torch.device("meta"):
        model = wav2vec2.Wav2Vec2ForCTC(dataclasses.replace(base.cfg, **over))
    model.load_state_dict(base.state_dict(), assign=True)
    return model.requires_grad_(False).eval()


def fe_input(model, audio: torch.Tensor) -> torch.Tensor:
    """The waveform as the feature extractor sees it: normalised per row
    where the model does it, in the compute dtype."""
    if model.cfg.do_normalize:
        var, mu = torch.var_mean(audio, dim=-1, correction=0, keepdim=True)
        audio = (audio - mu) * torch.rsqrt(var + 1e-7)
    return audio.to(model.cfg.dtype)


def _events_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fe_times(model, audio: torch.Tensor, iters: int = 3) -> dict:
    """The whole feature extractor on ``audio`` (B, T) float32: forward with
    grad on and its backward to its input, ms a round each by CUDA events
    (one warm-up round first), and the peak of the rounds (GiB)."""
    fe = model.wav2vec2.feature_extractor
    x = fe_input(model, audio).requires_grad_(True)
    gy = None
    fwd = bwd = 0.0
    dev = audio.device
    for i in range(iters + 1):
        if i == 1:
            torch.cuda.reset_peak_memory_stats(dev)
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        y = fe(x)
        e[1].record()
        if gy is None:
            gy = torch.randn(y.shape, dtype=y.dtype, device=dev,
                             generator=torch.Generator(dev).manual_seed(1))
        (dx,) = torch.autograd.grad(y, x, gy)
        e[2].record()
        torch.cuda.synchronize()
        if i:
            fwd += e[0].elapsed_time(e[1]) / iters
            bwd += e[1].elapsed_time(e[2]) / iters
        del y, dx
    return {"fe_fwd_ms": fwd, "fe_bwd_ms": bwd,
            "fe_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def layer_times(model, audio: torch.Tensor, iters: int) -> list[dict]:
    """Each conv layer alone, at the input one forward gives it."""
    impl = model.cfg.conv_impl
    layers = model.wav2vec2.feature_extractor.conv_layers
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda _m, args: inputs.append(args[0]))
             for m in layers]
    with torch.no_grad():
        model.wav2vec2.feature_extractor(fe_input(model, audio))
    for h in hooks:
        h.remove()
    rows = []
    dev = audio.device
    for i, (layer, x) in enumerate(zip(layers, inputs)):
        w = layer.conv.weight.to(x.dtype)
        s = layer.stride
        x = x.detach().requires_grad_(True)
        with torch.no_grad():
            y = wav2vec2.feature_conv(impl, x, w, s)
        gy = torch.randn(y.shape, dtype=y.dtype, device=dev,
                         generator=torch.Generator(dev).manual_seed(i))
        del y
        with torch.no_grad():
            fwd_ms = _events_ms(lambda: wav2vec2.feature_conv(impl, x, w, s), iters)
        y = wav2vec2.feature_conv(impl, x, w, s)
        torch.autograd.grad(y, x, gy, retain_graph=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dgrad_ms = _events_ms(lambda: torch.autograd.grad(y, x, gy, retain_graph=True), iters)
        extra = (torch.cuda.max_memory_allocated(dev) - before) / 2**30
        O, C, k = layer.conv.weight.shape
        B = x.shape[0]
        T = x.shape[2] if impl == "conv" else x.shape[1]
        L = (T - k) // s + 1
        flops = 2.0 * B * L * O * C * k
        rows.append({"layer": i, "B": B, "T_in": T, "T_out": L, "C_in": C, "C_out": O,
                     "k": k, "s": s, "fwd_ms": fwd_ms, "dgrad_ms": dgrad_ms,
                     "dgrad_alloc_gib": extra, "gflop": flops / 1e9,
                     "peak_bound_ms": flops / PEAK_BF16 * 1e3})
        del y, gy
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", nargs="?", default="base", choices=sorted(PRESETS))
    ap.add_argument("--impls", default=",".join(IMPLS),
                    help="comma-separated lowerings, of " + ", ".join(IMPLS))
    ap.add_argument("--iters", type=int, default=10, help="calls a layer timing averages")
    args = ap.parse_args()
    impls = args.impls.split(",")
    if any(i not in IMPLS for i in impls):
        ap.error(f"--impls: each of {IMPLS}")
    if not torch.cuda.is_available():
        print("conv_impl_ab.py: no CUDA device", file=sys.stderr)
        return 1
    dev = runtime.require_cuda()
    name, B, T = PRESETS[args.preset]
    base = wav2vec2.init_model(wav2vec2.get_config(name), seed=0)
    base = base.cast_param_storage(torch.bfloat16).to(dev)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32) * 0.1).to(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for impl in impls:
        model = with_config(base, conv_impl=impl)
        rows = layer_times(model, audio, args.iters)
        torch.cuda.empty_cache()
        fe = fe_times(model, audio)
        torch.cuda.empty_cache()
        print(json.dumps({"preset": args.preset, "model": name, "conv_impl": impl, "batch": B,
                          "samples": T, "card": card, "torch": torch.__version__,
                          "fwd_ms": sum(r["fwd_ms"] for r in rows),
                          "dgrad_ms": sum(r["dgrad_ms"] for r in rows), **fe,
                          "layers": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
