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
Each runs one warm-up step, times ``--steps`` (2) on the host clock, then runs
one step under ``torch.profiler``, in ``portbench``'s window scope and ending
in a synchronize. It prints one JSON line: the step time, the profiled
step's window and the device's busy time and share in it
(``portbench/trace.py:summarize``), kernel time by group, the top kernels by
total device time, and the device time by model scope and kind
(``by_scope_ms``, ``portbench/spans.py:charge``'s rule): each device
operation is charged to the innermost module scope around its launch, one
of the backward to the scope of the forward operation that made its
autograd node (linked by sequence number), each instant once, and split by
kind (GELU, copies and casts, LayerNorm, reductions, other elementwise,
matmul, conv, attention). ``--remat POLICY`` (and
``--remat_ffn``, ``--remat_fe N`` for feature-extractor remat saving N
layers) profiles the attack step under that remat setting; ``--conv_impl``
and ``--fused_qkv`` under that model option (``Wav2Vec2Config``). An attack
step also reports its peak before the feature extractor's first conv
layer's backward and from it on. ``--trace``
keeps the Chrome trace at PATH. Needs one CUDA device; it never runs on
the CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import inspect
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
from paa_tpu_torch.ops.kernels import pos_conv  # noqa: E402
from paa_tpu_torch.train import pretrain  # noqa: E402
from portbench import spans, trace  # noqa: E402

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
    ("K5 positional conv (pos_conv_kernel)", ("pos_conv_kernel",)),
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


# The model scopes of ``by_scope_ms``: (owner, attribute, label). Each is
# wrapped in a ``record_function`` of its label for the profiled step only.
SCOPES = (
    (wav2vec2.Wav2Vec2ForCTC, "forward", "model: normalize, lm_head"),
    (wav2vec2.ConvLayer, "forward", "feature extractor: conv, bias, GELU"),
    (wav2vec2, "fe_norm_gelu", "feature extractor: bias, LayerNorm, GELU (K6 in bf16)"),
    (wav2vec2.FeatureProjection, "forward", "feature projection"),
    (wav2vec2.PositionalConvEmbedding, "forward", "positional conv"),
    (wav2vec2.EncoderLayer, "forward", "encoder layer: residual adds"),
    (wav2vec2.SelfAttention, "forward", "attention block"),
    (wav2vec2.FeedForward, "forward", "FFN"),
    (wav2vec2, "_layer_norm", "_layer_norm (encoder, feature projection)"),
)
OUTSIDE = "outside the model: CTC, update, projection"
# kernel kinds, first match wins (lower-cased kernel name)
KINDS = (
    ("attention", ("attn_",)), ("K3", ("fm_",)), ("K5", ("pos_conv_kernel",)),
    ("K6", ("fe_norm_",)),
    ("conv", ("wgrad", "dgrad", "fprop", "conv",
                                                          "cudnn", "implicit")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet")), ("GELU", ("gelu",)),
    ("LayerNorm kernels", ("layer_norm", "layernorm", "gammabeta")),
    ("copies and casts", ("copy", "memcpy", "memset")), ("reductions", ("reduce",)),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for label, keys in KINDS:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


@contextlib.contextmanager
def scoped_model():
    """Wrap each of :data:`SCOPES` in a ``record_function`` of its label."""
    saved = []
    for owner, attr, label in SCOPES:
        fn = inspect.getattr_static(owner, attr)
        inner = fn.__func__ if isinstance(fn, (classmethod, staticmethod)) else fn
        if isinstance(fn, classmethod):  # autograd.Function.apply
            def wrapped(cls, *a, _f=inner, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _f(cls, *a, **k)
            new = classmethod(wrapped)
        else:
            def wrapped(*a, _f=inner, _label=label, **k):
                with torch.profiler.record_function(_label):
                    return _f(*a, **k)
            new = wrapped
        saved.append((owner, attr, fn, attr in vars(owner)))
        setattr(owner, attr, new)
    try:
        yield
    finally:
        for owner, attr, fn, own in reversed(saved):
            if own:
                setattr(owner, attr, fn)
            else:  # inherited (autograd.Function.apply)
                delattr(owner, attr)


def by_scope_ms(events: list) -> dict:
    """Device ms by (scope, kind) over the trace's window: ``portbench``'s
    charge rule (``portbench/spans.py:charge``) with the labels of
    :data:`SCOPES`, so that each instant of device time is charged once."""
    labels = {label for _, _, label in SCOPES}
    w = spans.window(events)
    out = collections.defaultdict(lambda: collections.defaultdict(float))
    for label, e, a, b in spans.charge(events, labels.__contains__, w["ts"], w["ts"] + w["dur"]):
        out[OUTSIDE if label == trace.OUTSIDE else label][kind_of(e["name"])] += (b - a) / 1e3
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1]))
            for k, v in sorted(out.items(), key=lambda kv: -sum(kv[1].values()))}


def attack_step(preset: str, dev, overrides: dict):
    """Phase 4's or 5's attack step, the model config with ``overrides``:
    (one_step, description)."""
    name, B, T, accum = PRESETS[preset]
    model = wav2vec2.init_model(wav2vec2.get_config(name, **overrides), seed=0)
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

    return one_step, {"model": name, "batch": B, "samples": T, "accum_steps": accum,
                      **overrides, **fe_layer0_backward_peak(one_step, model, dev)}


def fe_layer0_backward_peak(one_step, model, dev) -> dict:
    """One more step, its peak split at the feature extractor's first conv
    layer, whose backward comes last in each microbatch's: the peak from a
    microbatch's forward to that backward, and from there to the
    microbatch's end (GiB). A tensor hook on the layer's output marks the
    point; it keeps nothing alive. Not with feature-extractor remat, which
    would run the layer twice (a checkout from before it has no such field)."""
    if getattr(model.cfg, "remat_feature_extractor", False):
        return {}
    peak = {"before": 0, "inside": 0}
    state = {"part": "before"}

    def close(part):
        peak[part] = max(peak[part], torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)

    def at_forward(_module, _args):
        close(state["part"])
        state["part"] = "before"

    def at_layer0_grad(_grad):
        close("before")
        state["part"] = "inside"

    def mark(_module, _args, out):  # returns None: the output stays as it is
        out.register_hook(at_layer0_grad)

    layer0 = model.wav2vec2.feature_extractor.conv_layers[0]
    hooks = [model.register_forward_pre_hook(at_forward), layer0.register_forward_hook(mark)]
    torch.cuda.reset_peak_memory_stats(dev)
    one_step()
    torch.cuda.synchronize()
    close(state["part"])
    for h in hooks:
        h.remove()
    return {"peak_before_fe_layer0_backward_gib": peak["before"] / 2**30,
            "peak_from_fe_layer0_backward_gib": peak["inside"] / 2**30}


def conv_grad_ms(model, audio, iters: int = 10) -> dict:
    """Each convolution's weight gradient and input gradient alone, at the
    input one forward gives it and a random output gradient: ms per call.
    The positional conv's input gradient in bf16 is K5's, as the model runs
    it; every other is cuDNN's."""
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
        calls = {what: (lambda mask=mask: torch.ops.aten.convolution_backward(
                     gy, x, w, None, [stride], [padding], [1], False, [0], groups, mask))
                 for what, mask in (("wgrad_ms", [False, True, False]),
                                    ("dgrad_ms", [True, False, False]))}
        if name == "pos_conv" and x.dtype == torch.bfloat16:
            dpre = gy[:, :, : x.shape[-1]].transpose(1, 2).contiguous()
            calls["dgrad_ms"] = lambda: pos_conv.pos_conv_dgrad(dpre, w)
        for what, call in calls.items():
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
    ap.add_argument("--steps", type=int, default=2, help="timed steps")
    ap.add_argument("--remat", default=None, choices=["full", "save_cheap", "no_probs",
                                                      "save_resid"])
    ap.add_argument("--remat_ffn", action="store_true")
    ap.add_argument("--remat_fe", type=int, default=None,
                    help="feature-extractor remat, saving this many conv layers' outputs")
    ap.add_argument("--conv_impl", default=None,
                    choices=["conv", "hybrid", "pairdot", "im2col", "tapdot"],
                    help="the feature extractor's conv lowering (default: the config's, conv)")
    ap.add_argument("--fused_qkv", action="store_true", help="q, k and v in one product")
    args = ap.parse_args()
    overrides = {}
    if args.conv_impl:
        overrides["conv_impl"] = args.conv_impl
    if args.fused_qkv:
        overrides["fused_qkv"] = True
    if args.remat:
        overrides.update(remat=True, remat_policy=args.remat)
    if args.remat_ffn:
        overrides["remat_ffn"] = True
    if args.remat_fe is not None:
        overrides.update(remat_feature_extractor=True, remat_fe_save_layers=args.remat_fe)
    if not torch.cuda.is_available():
        print("profile_torch_step.py: no CUDA device", file=sys.stderr)
        return 1
    dev = runtime.require_cuda()
    one_step, info = (pretrain_step(dev) if args.preset == "pretrain"
                      else attack_step(args.preset, dev, overrides))

    one_step()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one_step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / args.steps
    peak = torch.cuda.max_memory_allocated(dev)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with scoped_model(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            one_step()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        if args.trace:
            os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
            shutil.copy(path, args.trace)
    summary = trace.summarize(events)
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] += e["dur"] / 1e3
            calls[e["name"]] += 1
    groups = collections.Counter()
    for k, ms in by_name.items():
        groups[group_of(k)] += ms
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(json.dumps({
        "preset": args.preset, **info, "card": smi, "step_s": step_s,
        "window_ms": summary["window_s"] * 1e3, "busy_ms": summary["busy_s"] * 1e3,
        "busy_share": summary["busy_s"] / summary["window_s"],
        "peak_mem_gib": peak / 2**30, "groups_ms": dict(groups.most_common()),
        "by_scope_ms": by_scope_ms(events),
        "top_kernels": [{"name": k[:120], "ms": ms, "calls": calls[k]}
                        for k, ms in by_name.most_common(args.top)],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
