"""Profile one step of the PyTorch/CUDA port at full width on a GPU.

    python3 tools/profile_torch_step.py [base|lv60|pretrain] [--trace PATH]

``base`` and ``lv60`` build the attack configuration of ``chip_smoke.py``'s
phase 4 (B=64 × 10 s, A=1) or phase 5 (B=64 × 20 s, A=2) from seed 0 —
random weights, bf16, fletcher_munson PGD. ``pretrain`` builds phase 8 (a):
a pretraining step of wav2vec2-base (random weights from seed 5, bf16
compute, float32 parameters, every parameter's gradient, clip and Adam) on
the first batch of 32 of its synthetic corpus (512 clips); it also times
each convolution's weight gradient and input gradient alone (CUDA events,
10 calls of ``aten.convolution_backward``) at the shapes the step gives it.
Each runs one warm-up step, times two steps on the host clock, then runs
one step under ``torch.profiler``. It prints one JSON line: the step time,
the device's busy share in the profiled step (the union of kernel
intervals over the step's span in the trace), kernel time by group, and
the top kernels by total device time. ``--trace`` keeps the Chrome trace at
PATH. Needs one CUDA device; it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paa_tpu_torch import runtime  # noqa: E402
from paa_tpu_torch.attack import optimizers, step  # noqa: E402
from paa_tpu_torch.config import AttackConfig, ConstraintParams  # noqa: E402
from paa_tpu_torch.models import wav2vec2  # noqa: E402
from paa_tpu_torch.ops import psycho, text  # noqa: E402
from paa_tpu_torch.train import pretrain  # noqa: E402

PRESETS = {  # name: (model, batch, samples, accum_steps)
    "base": ("wav2vec2-base", 64, 160_000, 1),
    "lv60": ("wav2vec2-large-lv60", 64, 320_000, 2),
}
# chip_smoke.py phase 8 (a): its clips' length comes from the corpus
PRETRAIN = pretrain.PretrainConfig(model="wav2vec2-base", batch_size=32, steps=4,
                                   warmup_steps=2, eval_every=4, synthetic_samples=512)

# Kernel-name groups, first match wins.
GROUPS = (
    ("attention K1 (attn_fwd_sm90)", ("attn_fwd_sm90",)),
    ("attention K2 dk/dv (attn_bwd_dkdv_sm90)", ("attn_bwd_dkdv_sm90",)),
    ("attention K2 dq (attn_bwd_dq_sm90)", ("attn_bwd_dq_sm90",)),
    ("attention K2 prep (attn_bwd_prep)", ("attn_bwd_prep",)),
    ("K3 fm_norm", ("fm_",)),
    ("convolutions: weight gradients (cuDNN wgrad)", ("wgrad",)),
    ("convolutions: input gradients (cuDNN dgrad)", ("dgrad",)),
    ("convolutions: forward and other (cuDNN)", ("fprop", "implicit", "conv", "cudnn")),
    ("matmuls (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet")),
    ("elementwise, reductions and copies", ("elementwise", "reduce", "copy", "Copy", "cat",
                                            "norm", "softmax", "index", "fill")),
)


def group_of(name: str) -> str:
    for label, keys in GROUPS:
        if any(k in name for k in keys):
            return label
    return "other"


def busy_share(trace_path: str) -> tuple[float, float, float]:
    """(kernel time ms, union of kernel intervals ms, span ms) of the trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel")
    total = sum(b - a for a, b in spans)
    union, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                union += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        union += cur_b - cur_a
    return total / 1e3, union / 1e3, (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0


def attack_step(preset: str, dev):
    """Phase 4's or 5's attack step: (one_step, description)."""
    name, B, T, accum = PRESETS[preset]
    model = wav2vec2.init_model(wav2vec2.get_config(name), seed=0)
    model = model.cast_param_storage(torch.bfloat16).to(dev)
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", lr=1e-4,
                       accum_steps=accum, model_name=name)
    tables = psycho.build_tables(cfg, dev)
    cparams = ConstraintParams.create(device=dev)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32) * 0.1).to(dev)
    labels, pads = (torch.from_numpy(a).to(dev) for a in
                    text.encode_batch(["the quick brown fox jumps over the lazy dog"] * B))
    weights = torch.ones(B, device=dev)
    p = torch.zeros((1, T), device=dev)
    opt = optimizers.init_opt_state(cfg, p)
    train = step.make_train_step(cfg, model, tables)

    def one_step():
        nonlocal p, opt
        p, opt, _ = train(p, opt, audio, labels, pads, weights, cparams, cfg.lr)

    return one_step, {"model": name, "batch": B, "samples": T, "accum_steps": accum}


def conv_grad_ms(model, audio, iters: int = 10) -> dict:
    """Each convolution's weight gradient and input gradient alone, at the
    input one forward gives it and a random output gradient: ms per call."""
    inputs = {}
    layers = {f"fe_conv_{i}": layer for i, layer in enumerate(model.wav2vec2.feature_extractor
                                                                .conv_layers)}
    layers["pos_conv"] = model.wav2vec2.encoder.pos_conv_embed
    hooks = [m.register_forward_pre_hook(lambda m, args, name=name: inputs.update({name: args[0]}))
             for name, m in layers.items()]
    with torch.no_grad():
        model(audio)
    for h in hooks:
        h.remove()
    out = {}
    for name, m in layers.items():
        x = inputs[name].detach()
        conv = m.conv
        if name == "pos_conv":  # (B, T, H) → (B, H, T)
            x = x.transpose(1, 2)
        w = conv.weight.detach().to(x.dtype)
        stride, padding, groups = conv.stride[0], conv.padding[0], conv.groups
        gy = torch.randn_like(torch.nn.functional.conv1d(x, w, None, stride, padding, 1, groups))
        row = {"x": list(x.shape), "w": list(w.shape), "groups": groups}
        for what, mask in (("wgrad_ms", [False, True, False]), ("dgrad_ms", [True, False, False])):
            call = lambda: torch.ops.aten.convolution_backward(
                gy, x, w, None, [stride], [padding], [1], False, [0], groups, mask)
            call()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                call()
            end.record()
            torch.cuda.synchronize()
            row[what] = start.elapsed_time(end) / iters
        out[name] = row
    return out


def pretrain_step(dev):
    """Phase 8 (a)'s pretraining step: (one_step, description)."""
    cfg = PRETRAIN
    pipe = pretrain.build_corpus(cfg)
    batch = next(pipe.train.batches(cfg.batch_size, shuffle_rng=np.random.default_rng((cfg.seed, 0)),
                                    drop_remainder=True))
    audio, labels, pads = (torch.from_numpy(a).to(dev)
                           for a in (batch.audio, batch.labels, batch.label_paddings))
    model = wav2vec2.init_model(wav2vec2.get_config(cfg.model), seed=cfg.seed).to(dev)
    train = pretrain.make_pretrain_step(model, cfg)
    state = pretrain.init_opt_state(list(model.parameters()))

    def one_step():
        nonlocal state
        state, _ = train(state, audio, labels, pads)

    info = {"model": cfg.model, "batch": cfg.batch_size, "samples": pipe.audio_len,
            "frames": model.cfg.feat_extract_output_length(pipe.audio_len), "accum_steps": 1,
            "conv_grads_ms": conv_grad_ms(model, audio)}
    return one_step, info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset", nargs="?", default="lv60", choices=sorted(PRESETS) + ["pretrain"])
    ap.add_argument("--trace", default=None, help="keep the Chrome trace here")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step.py: no CUDA device", file=sys.stderr)
        return 1
    dev = runtime.require_cuda()
    one_step, info = (pretrain_step(dev) if args.preset == "pretrain"
                      else attack_step(args.preset, dev))

    one_step()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        one_step()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        kernel_ms, busy_ms, span_ms = busy_share(trace)
        by_name = collections.Counter()
        calls = collections.Counter()
        with open(trace) as f:
            for e in json.load(f)["traceEvents"]:
                if e.get("ph") == "X" and e.get("cat") == "kernel":
                    by_name[e["name"]] += e["dur"] / 1e3
                    calls[e["name"]] += 1
        if args.trace:
            os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
            shutil.copy(trace, args.trace)
    groups = collections.Counter()
    for k, ms in by_name.items():
        groups[group_of(k)] += ms
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(json.dumps({
        "preset": args.preset, **info, "card": smi, "step_s": step_s, "profiled_span_ms": span_ms,
        "kernel_ms": kernel_ms, "busy_ms": busy_ms,
        "busy_share": busy_ms / span_ms if span_ms else None,
        "groups_ms": dict(groups.most_common()),
        "top_kernels": [{"name": k[:120], "ms": ms, "calls": calls[k]}
                        for k, ms in by_name.most_common(args.top)],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
