"""Time the encoder LayerNorm's forward and backward routes on a GPU.

    python3 tools/layernorm_ab.py [--iters N]

At lv60's and base's shapes in bf16 ((32, 999, 1024), one microbatch of
phase 5, and (64, 499, 768), phase 4) it times, with CUDA events over N calls
after a warm-up:

  * ``stock``: ``F.layer_norm`` on a float32 copy, cast back (the port's
    LayerNorm before ``_LayerNormFn``), forward and autograd's backward
    (its ``x.float()`` and ``.to`` casts included);
  * ``lean``: ``_LayerNormFn``'s forward, and three backward routes on its
    saved x̂ and 1/std: ``aten_f32`` (``native_layer_norm_backward`` on x̂
    in float32 with mean 0 and 1/std 1, then × 1/std written in the input's
    dtype: the port's), ``aten_bf16`` (the same on x̂ and g in bf16, a
    second rounding of dx) and ``plain`` (the formula in elementwise passes).

Each backward's dx is held against the formula in float64 on the same x̂,
1/std and g (max |error| / max |dx|). It prints one JSON line with the card's
name and power limit, and the bytes each route must move at the least.
Needs one CUDA device; it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paa_tpu_torch import runtime  # noqa: E402
from paa_tpu_torch.models import wav2vec2  # noqa: E402

SHAPES = {"lv60": (32, 999, 1024), "base": (64, 499, 768)}
EPS = 1e-5


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bwd_plain(g, xhat, rstd, weight):
    xf, gf = xhat.float(), g.float()
    dxhat = gf.mul_(weight)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xf).mean(-1, keepdim=True)
    return dxhat.sub_(m1).sub_(xf.mul_(m2)).mul_(rstd).to(xhat.dtype)


def bwd_aten(g, xhat, rstd, weight, dtype):
    H = xhat.shape[-1]
    dxhat = torch.ops.aten.native_layer_norm_backward(
        g.to(dtype), xhat.to(dtype), [H], torch.zeros_like(rstd), torch.ones_like(rstd),
        weight, None, [True, False, False])[0]
    return torch.mul(dxhat, rstd, out=torch.empty_like(xhat))


def bwd_f64(g, xhat, rstd, weight):
    xf, dxhat = xhat.double(), g.double() * weight.double()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xf).mean(-1, keepdim=True)
    return (dxhat - m1 - xf * m2) * rstd.double()


def case(shape, dev, iters: int) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    H = shape[-1]
    # a residual stream's scale, its mean off 0
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    weight = 1 + 0.1 * torch.randn(H, generator=gen, device=dev)
    bias = 0.1 * torch.randn(H, generator=gen, device=dev)
    n = x.numel()
    out = {"shape": list(shape), "dtype": "bfloat16"}

    def stock():
        xs = x.detach().requires_grad_(True)
        y = F.layer_norm(xs.float(), (H,), weight, bias, EPS).to(x.dtype)
        return xs, y

    out["stock_fwd_ms"] = time_ms(lambda: F.layer_norm(x.float(), (H,), weight, bias, EPS)
                                  .to(x.dtype), iters)
    xs, y = stock()
    out["stock_bwd_ms"] = time_ms(lambda: torch.autograd.grad(y, xs, g, retain_graph=True),
                                  iters)

    class Ctx:  # _LayerNormFn.forward's context, outside autograd
        def save_for_backward(self, *t):
            self.saved = t

    ctx = Ctx()
    out["lean_fwd_ms"] = time_ms(lambda: wav2vec2._LayerNormFn.forward(ctx, x, weight, bias, EPS),
                                 iters)
    xhat, rstd, _ = ctx.saved
    want = bwd_f64(g, xhat, rstd, weight)
    routes = {"aten_f32": lambda: bwd_aten(g, xhat, rstd, weight, torch.float32),
              "aten_bf16": lambda: bwd_aten(g, xhat, rstd, weight, torch.bfloat16),
              "plain": lambda: bwd_plain(g, xhat, rstd, weight)}
    for name, fn in routes.items():
        try:
            dx = fn()
        except RuntimeError as e:  # a route the card's build does not take
            out[f"{name}_error"] = str(e).splitlines()[0][:200]
            continue
        err = float((dx.double() - want).abs().max() / want.abs().max())
        out[f"{name}_bwd_ms"] = time_ms(fn, iters)
        out[f"{name}_rel_err"] = err
    # the least time at 3.35 TB/s, each tensor read or written once in bf16:
    # forward x → out (and x̂ for the lean one), backward (x̂,) g → dx
    bound = lambda tensors: tensors * 2 * n / 3.35e12 * 1e3
    out.update(stock_fwd_bound_ms=bound(2), lean_fwd_bound_ms=bound(3), bwd_bound_ms=bound(3))
    # the port's route agrees with the formula as the plain route computes it
    d_port = wav2vec2._LayerNormFn.backward(type("C", (), {
        "saved_tensors": (xhat, rstd, weight),
        "needs_input_grad": (True, False, False, False)})(), g)[0]
    out["port_is_aten_f32"] = bool(torch.equal(d_port, routes["aten_f32"]()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("layernorm_ab.py: no CUDA device", file=sys.stderr)
        return 1
    dev = runtime.require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      **{k: case(v, dev, args.iters) for k, v in SHAPES.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
