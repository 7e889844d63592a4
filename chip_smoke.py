"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line with its numbers and the tolerance it
held; any failed check raises, so the script exits non-zero before its last
line:

  1. build   — builds the CUDA kernels from ``paa_tpu_torch/csrc`` (nvcc,
               sm_90a) and prints the card's name and power limit.
  2. kernels — each kernel against its plain PyTorch version on the card,
               at the test shapes and at the main paths' shapes, with times,
               the least time the card could take (the bound) and the time
               of one PyTorch call for the same function where there is one;
               K2 run twice must give equal bits. K1/K2 also at the
               long-clip lengths T ∈ {774, 999, 1499} with 16 heads, where
               the JAX package runs its flash kernel. K1/K2 and K3 also
               at the base sweep's shapes (phase 7's clips are longer than
               phase 4's), and at the pretraining batches of phase 8,
               (32, T_pre, 12, 64) bf16 and (32, T_pre, 4, 16) f32, and at
               phase 9's ranks' shapes, (32, 499, 12, 64) and (16, 499, 6,
               64) bf16 (the anchor's ranks', (16, T, 4, 16) and (32, T, 2,
               16) bf16, at the end, with the anchor's T). K3 at
               base's and lv60's p, in torch.stft's
               layout and contiguous, must launch
               one kernel and run one device operation a call (the nodes
               of a CUDA graph of one call; torch.profiler's trace too,
               where it sees the device),
               repeat its bits over 10 calls, and reports its device time
               (``device_ms``, a CUDA graph of 100 calls) beside ``ms``.
               K5 (the positional conv, both directions) at base's batch
               (64, 499, 768, 16 groups, 128 taps), an lv60 microbatch (32,
               999, 1024), the tiny anchor's groups and a ragged length,
               with equal bits on a repeat, one launch a call, and
               F.conv1d and cuDNN's input gradient as ``library_ms``.
               K7 (the encoder's LayerNorm, both directions) at an lv60
               microbatch at 20 s and 30 s, an lv60 eval batch, a base
               batch and lv60's feature projection, bf16, with equal bits
               on a repeat, one launch a call, its byte bound, the plain
               version's ms and F.layer_norm with its autograd backward as
               ``library_ms``.
               K8 (the relative conformer's attention, both directions) at
               its 30 s and 20 s microbatches, (16, 1499, 16, 64) and (32,
               999, 16, 64), and ragged small shapes: errors, bits on a
               repeat, device ms beside its bound and K1's / K2's, and the
               high-water mark a forward and a backward add above their
               outputs.
  3. tiny    — the committed tiny checkpoint: one fletcher_munson PGD train
               step and one eval step on the card (through the kernels),
               held against the same steps on the CPU (plain versions, f32).
  4. main    — wav2vec2-base at full width (12 layers, hidden 768, 12 heads),
               random weights from a seed, bf16: B=64 × 10 s of 16 kHz
               audio, 1 warm-up and 3 timed PGD train steps plus one eval
               step; the launch counters show the kernels ran in every layer.
  5. lv60    — wav2vec2-large-lv60 at full width (24 layers, hidden 1024,
               16 heads), random weights from a seed, bf16: B=64 × 20 s
               (T = 999 frames) in 2 microbatches, 1 warm-up and 2 timed
               PGD train steps plus one eval step, with the launch counts.
  6. cli     — ``python -m paa_tpu_torch.cli.run_attack``: the tiny
               checkpoint's clean test eval against the JAX package's
               recorded numbers, and lv60 on ~20 s synthetic clips; each
               writes a finite results.json and launches the kernels as
               often as its steps ask. Then the anchor on its --small_data
               corpus twice, the second with --profile: a Chrome trace
               with CPU events in <save_dir>/profile/, the clean scores of
               the run without it, its perturbation within rtol 2e-3.
  7. sweep   — ``python -m paa_tpu_torch.cli.sweep`` twice: wav2vec2-base at
               full width, random weights from the seed, B=64 × ~10 s
               synthetic clips, three fletcher_munson cells for one epoch
               (every cell finished with finite scores, the JAX package's
               keys in sweep_results.json, the launches its cell steps and
               eval passes ask for, a peak within 2 % of phase 4's; wall
               time, cell steps/s and one cell's step beside phase 4's;
               its clips are the length phase 2 checked the kernels at);
               and a 1-cell sweep under the anchor's flags, whose clean
               test scores must equal phase 6's run and whose
               perturbation.npy must match it (rtol 2e-3, atol 1e-6).
  8. pretrain — ``python -m paa_tpu_torch.train.pretrain``: (a) wav2vec2-base
               at full width, random weights from the seed, bf16 compute
               and float32 parameters, B=32, 4 steps (warmup 2), one eval;
               K1/K2 launch 12 × (steps + eval batches) and 12 × steps
               times. The same run through ``pretrain()`` with a step
               watcher: the weights after step 1 equal the initial ones bit
               for bit (lr 0), after step 4 they differ, every loss is
               finite, the step time (steps 2-4) and peak; its export,
               loaded into a fresh model, gives the kept best weights'
               logits exactly. (b) the tiny checkpoint's recipe (float32,
               the register route): the loss halves, the best eval WER is below
               1, the export reproduces the test WER exactly, beside the
               JAX record. (c) the committed checkpoint through the port's
               ``evaluate_wer`` gives its recorded eval WER exactly.
  9. parallel — data and tensor parallelism, ``torchrun --standalone
               --nproc_per_node 2`` of this script's worker mode, the 2 ranks
               sharing the one card over gloo (each rank writes its record
               and launch counts to a JSON file; a launch is killed after
               PAR_TIMEOUT_S): (a) dp=2 at base's full width, B=64 × 10 s,
               32 rows a rank, and (b) tp=2, B=16, 6 heads and 1536 FFN
               columns a rank: ∂loss/∂p and one PGD step from p = 0 against
               the one-device step on this card (loss, gradient and PGD
               signs within PAR_TOL), p bit-equal on the ranks, each rank's
               K1/K2/K3 launches as computed, its step time and peak;
               (c) the CLI anchor through ``paa_tpu_torch.cli.run_attack``
               with dp=2 (clean test scores equal phase 6's) and with
               ``--tp 2`` (within phase 6's anchor tolerance: the split
               heads round apart in bf16), perturbed scores beside phase
               6's; (d) a 2-cell sweep through ``paa_tpu_torch.cli.sweep``,
               one cell a rank, against the same sweep in one process.
               Its times are of two processes sharing one card over gloo,
               not scaling numbers.
 10. feed    — the host feed against the device feed: (a) on phase 7's
               corpus at B=64, the host feed (collate, then
               ``prefetch_to_device``), ``DeviceCorpus`` and ``CachedCorpus``
               with half the split resident: ms a batch over 5 shuffled
               epochs of the train split (host clock, ending in a
               synchronize), bytes copied to the card a batch, bytes staged;
               every batch of every split with its valid rows bit-equal
               across the feeds, padding rows the split's row 0 in both
               corpora and zero audio in the host feed; (b) ``run_attack``
               at base's full width on that corpus, fletcher_munson PGD,
               one epoch, with ``--no_device_cache`` and ``--device_cache``:
               ``step_time_ms`` beside phase 4's step, the peak, launches
               as computed, clean test scores equal between the feeds and
               perturbed ones within phase 6's anchor tolerance; (c) the
               anchor with dp=2 under ``torchrun`` on the device feed:
               clean test scores equal to phase 6's, p bit-equal on the
               ranks. Phases 6, 7 and 9 run on the device feed too, the
               default on CUDA.
 11. remat   — (a) phase 5's configuration under each remat setting of the
               model: the policies no_probs, save_cheap, save_resid and full,
               save_cheap with remat_ffn, and full with feature-extractor
               remat saving 0 and 2 layers, on phase 5's weights: step time,
               peak and launches (K1 twice a layer and microbatch under
               full, once otherwise), the first step's loss from p = 0
               bit-equal to phase 5's, ∂loss/∂p at p = 0 within PAR_TOL of
               phase 5's, and the peaks in the order full < save_resid <
               save_cheap < phase 5; (b) the same batch in one microbatch
               under full remat with feature-extractor remat; (c) phase 6's
               lv60 ``run_attack`` with ``--remat``: clean scores equal to
               the run without it (eval has no backward), finite results,
               launches as its steps ask. It runs after phase 6, whose lv60
               run it needs.
 12. lowerings — the feature extractor's conv lowerings (``conv_impl``) and
               ``fused_qkv``, after phase 11: (a) base at phase 4's shape on
               phase 4's weights under conv, hybrid, pairdot, im2col and
               tapdot, each 1 warm-up and 2 timed steps: step time, peak,
               K1/K2/K3 launches a train step equal to phase 4's, the
               feature extractor's forward and backward ms apart (CUDA
               events around it and its ``autograd.grad``, one microbatch;
               ``tools/conv_impl_ab.py``), and the first loss and ∂loss/∂p
               at p = 0 within PAR_TOL of conv's (conv's first loss
               bit-equal to phase 4's); (b) the same at phase 5's shape on
               its weights, against phase 5; (c) base's geometry at depth 2,
               B=2 × 1 s, float32 with TF32 off: each lowering's logits and
               ∂logits/∂audio within 1e-4 of conv's largest value; (d)
               ``fused_qkv`` at phase 4's shape as (a) runs it, against (a)'s
               conv; (e) phase 6 (a)'s anchor ``run_attack`` with
               ``--conv_impl hybrid``: clean test scores within the anchor's
               tolerance of phase 6 (a)'s, launches as its steps ask.

Then K1/K2's register route (head dim 16) at the anchor's shape, the kernels
line ``{"kernels": [...]}`` (per kernel and the runs it counts: launches in
them, the shape it was checked at, error, ms, the plain version's ms, the
bound and what sets it, the PyTorch call's ms), and
last ``{"ok": true, "device": {...}}``.
It exits non-zero when no CUDA device is present; it never runs on the CPU
instead. The CLI and sweep runs write under ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import math
import os
import re
import runpy
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from paa_tpu_torch import runtime
from paa_tpu_torch.attack import optimizers, step
from paa_tpu_torch.cli import parser
from paa_tpu_torch.config import AttackConfig, ConstraintParams
from paa_tpu_torch.data import pipeline, synthetic
from paa_tpu_torch.models import checkpoint_io, wav2vec2
from paa_tpu_torch.ops import dsp, psycho, text
from paa_tpu_torch.ops.kernels import _lib, attention, fe_norm, fm_norm, layer_norm, pos_conv
from paa_tpu_torch.parallel import mesh as mesh_lib, tp as tp_lib
from paa_tpu_torch.train import pretrain

SEED = 0
MAIN_B, MAIN_T = 64, 160_000  # bench.py's shape: batch 64 × 10 s at 16 kHz
LV60_B, LV60_T, LV60_ACCUM = 64, 320_000, 2  # 20 s clips, T = 999 frames
LONG_T = (774, 999, 1499)  # 15.5 s (the JAX flash switch), 20 s, 30 s
TINY_CKPT = "checkpoints/wav2vec2-tiny-synthetic.safetensors"
RUNS_DIR = os.path.join("chiprun_out", "chip_smoke")
ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances, as max |kernel − plain| / max(max |plain|, 0.1) unless said
# otherwise.
# bf16: outputs and gradients are stored in bf16 (relative step 2^-8) and
# the kernels round p and ds where the plain version rounds p only.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_ABS_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
FM_TOL = 1e-5  # float32 sum of positive terms in another order
POS_CONV_TOL = 2e-2  # K5: bf16 outputs, as ATTN_TOL's
# K6, as max |kernel − plain| / max |plain| against the plain version in
# float32 on the same bf16 values: each output is rounded once to bf16, so it
# lies within one bf16 step (2^-8) of the output's scale
FE_NORM_TOL = 2.0**-8
LAYER_NORM_TOL = 2.0**-8  # K7, as FE_NORM_TOL

# The H100 SXM's published peaks (dense), for the bounds: bf16 on the tensor
# cores, float32 outside them, and device memory.
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def counts(**kw) -> dict:
    """A full launch-count dict: the named counters, every other one 0."""
    assert set(kw) <= set(_lib.launches), kw
    return {name: kw.get(name, 0) for name in _lib.launches}


def load_tool(name: str):
    """A script of ``tools/`` as a module, loaded from its path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the device timer of K3 and the attention checks (a CUDA graph of 100
# calls), and K3's device operations (the nodes of a CUDA graph of one call,
# and torch.profiler's names)
fm_profile = load_tool("fm_norm_profile")
# a model on another's weights under another config (phases 11 and 12), and
# the whole-FE timer (CUDA events around the FE and its autograd.grad)
conv_ab = load_tool("conv_impl_ab")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), the scale floored at
    0.1, the order of the test outputs: some references are exactly 0 (at
    T=1, dq = dk = 0) and meet float32 rounding noise."""
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(float(want.float().abs().max()), 0.1)


def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events:
    the caller's view, host launch work included where it exceeds the
    device's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def qkv(B, T, H, d, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((B, T, H * d), generator=g, device=dev) * 0.5).to(dtype)
            for _ in range(4)]


def bound(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak rate of their type and the bytes over the
    memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bounds(B, T, H, d, dtype) -> dict:
    """K1: 4·B·H·T²·d operations, q, k, v read and o, lse written; K2: five
    T×T×d products, 10·B·H·T²·d, q, k, v, o, do, lse read and dq, dk, dv
    written."""
    n, stats = B * T * H * d * torch.finfo(dtype).bits // 8, B * H * T * 4
    fwd, fwd_by = bound(4 * B * H * T * T * d, 4 * n + stats, dtype)
    bwd, bwd_by = bound(10 * B * H * T * T * d, 8 * n + stats, dtype)
    return {"fwd_bound_ms": fwd, "fwd_bound_by": fwd_by, "bwd_bound_ms": bwd,
            "bwd_bound_by": bwd_by}


def check_attention(B, T, H, d, dtype, dev, iters=20) -> dict:
    q, k, v, do = qkv(B, T, H, d, dtype, dev, seed=T * 7 + d)
    o, lse = attention.attention_fwd(q, k, v, H)
    o_ref, lse_ref = attention.attention_fwd_plain(q, k, v, H)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    (attention.attention_fwd_plain(*leaves, H)[0].float() * do.float()).sum().backward()
    grads = attention.attention_bwd(q, k, v, o, lse, do, H)
    again = attention.attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    errs = {"o": rel_err(o, o_ref), "lse_abs": rel_err(lse, lse_ref)[0]}
    for name, got, leaf in zip(("dq", "dk", "dv"), grads, leaves):
        errs[name] = rel_err(got, leaf.grad)
    tol = ATTN_TOL[dtype]
    out = {"phase": "kernels", "kernel": "attention", "B": B, "T": T, "H": H, "d": d,
           "dtype": str(dtype).split(".")[1], "tol_rel": tol, "tol_lse_abs": LSE_ABS_TOL[dtype],
           "lse_max_abs_err": errs["lse_abs"]}
    for name in ("o", "dq", "dk", "dv"):
        out[f"{name}_max_abs_err"], out[f"{name}_rel_err"] = errs[name]
    fail = [n for n in ("o", "dq", "dk", "dv") if not errs[n][1] <= tol]
    if not errs["lse_abs"] <= LSE_ABS_TOL[dtype]:
        fail.append("lse")
    out["bwd_deterministic"] = all(bool(torch.equal(a, b)) for a, b in zip(grads, again))
    if not out["bwd_deterministic"]:
        fail.append("bwd_bits")
    out["fwd_ms"] = time_ms(lambda: attention.attention_fwd(q, k, v, H), iters)
    out["fwd_plain_ms"] = time_ms(lambda: attention.attention_fwd_plain(q, k, v, H), iters)
    out["bwd_ms"] = time_ms(lambda: attention.attention_bwd(q, k, v, o, lse, do, H), iters)
    out["bwd_plain_ms"] = time_ms(
        lambda: attention.attention_bwd_plain(q, k, v, o, lse, do, H), iters)
    # the device's own time: a CUDA graph of 5·iters (100) wrapper calls,
    # replayed 5 times
    calls = 5 * iters
    out["fwd_device_ms"] = fm_profile.graph_ms(lambda: attention.attention_fwd(q, k, v, H), calls)
    out["bwd_device_ms"] = fm_profile.graph_ms(
        lambda: attention.attention_bwd(q, k, v, o, lse, do, H), calls)
    # one PyTorch call for the same function, as a yardstick only (the port
    # never calls it): SDPA's forward, and its backward alone, replayed on
    # one saved forward; each also as a CUDA graph of as many calls, the
    # backward's captured on the stream its forward ran on
    sdpa = torch.nn.functional.scaled_dot_product_attention
    to_bhtd = lambda t: t.view(B, T, H, d).transpose(1, 2).detach().requires_grad_(True)
    qs, ks, vs = to_bhtd(q), to_bhtd(k), to_bhtd(v)
    dos = do.view(B, T, H, d).transpose(1, 2)
    with torch.no_grad():
        out["fwd_library_ms"] = time_ms(lambda: sdpa(qs, ks, vs, scale=1.0), iters)
        out["fwd_library_device_ms"] = fm_profile.graph_ms(lambda: sdpa(qs, ks, vs, scale=1.0),
                                                           calls)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ys = sdpa(qs, ks, vs, scale=1.0)
    torch.cuda.current_stream().wait_stream(side)
    sdpa_bwd = lambda: torch.autograd.grad(ys, (qs, ks, vs), dos, retain_graph=True)
    out["bwd_library_ms"] = time_ms(sdpa_bwd, iters)
    out["bwd_library_device_ms"] = fm_profile.graph_ms(sdpa_bwd, calls, stream=side)
    out.update(attention_bounds(B, T, H, d, dtype))
    out["failed"] = fail
    emit(out)
    return out


def fm_edge_stft(dev) -> torch.Tensor:
    """(1, 513, 130) STFT with cells at power 0, at SPL exactly 0 (power 1)
    and at SPL exactly 90 (power 1e9 = 1200² + 31600², exact in float32)."""
    x = torch.zeros((1, 513, 130, 2), dtype=torch.float32)
    x[0, 10:200, 5:60, 0] = 1.0
    x[0, 200:400, 60:120, 0] = 1200.0
    x[0, 200:400, 60:120, 1] = 31600.0
    x[0, 0, :, 0] = 1.0  # bin 0 Hz lies outside [20, 20000]: weight 1
    return torch.view_as_complex(x.to(dev))


def check_fm(stft_p: torch.Tensor, tables, label: str, iters=100) -> dict:
    """K3 against its plain version; its launches and device operations in
    one call, its bits over 10 calls, its time per call as the caller sees
    it (``ms``) and on the device alone (``device_ms``)."""
    call = lambda: fm_norm.fm_weighted_power_sum(stft_p, tables)
    _lib.reset_launches()
    got = call()
    launches = _lib.launches["fm_norm"]
    want = fm_norm.fm_weighted_power_sum_plain(stft_p, tables)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    bits_repeat = all(torch.equal(call(), got) for _ in range(10))
    # the device operations of one call: the nodes of a CUDA graph that
    # captured it decide; torch.profiler's names are kept beside them, and
    # a trace that saw the device must agree (now and then on the H100 it
    # sees nothing, three traces running)
    nodes = fm_profile.graph_nodes(call)
    work = [n for n in nodes if n in fm_profile.DEVICE_WORK]
    ops = [name for name, _us in fm_profile.device_ops(call)]
    F = stft_p.shape[-2]
    cells = stft_p.numel()
    # per cell: |X|², its SPL, the phon lerp and the weighted sum, about 16
    # float32 operations; the complex input, the (10, F) table and the (F,)
    # domain mask read once
    ms_bound, by = bound(16 * cells, 8 * cells + 11 * F * 4 + 4, torch.float32)
    out = {"phase": "kernels", "kernel": "fm_norm", "case": label,
           "shape": list(stft_p.shape), "strides": list(stft_p.stride()),
           "value": float(got), "plain_value": float(want), "max_abs_err": abs_err,
           "rel_err": rel, "tol_rel": FM_TOL, "launches_per_call": launches,
           "graph_nodes_per_call": nodes, "device_ops_per_call": ops,
           "bits_repeat": bits_repeat,
           "ms": time_ms(call, iters), "device_ms": fm_profile.graph_ms(call),
           "plain_ms": time_ms(lambda: fm_norm.fm_weighted_power_sum_plain(stft_p, tables),
                               iters)}
    out.update(bound_ms=ms_bound, bound_by=by, library_ms=None)
    out["failed"] = [name for name, ok in (("sum", rel <= FM_TOL), ("launches", launches == 1),
                                           ("device_ops", work == ["kernel"] and len(ops) <= 1),
                                           ("bits", bits_repeat)) if not ok]
    emit(out)
    return out


def check_pos_conv(B, T, H, Cg, K, dev, iters=10) -> dict:
    """K5's forward and input gradient against their plain versions (the
    same sums through F.conv1d in bf16), their bits on a repeat and one
    launch a call; each direction's ms, its device ms (a CUDA graph of 20
    calls), the plain version's ms and the library's: F.conv1d as the layer
    called it before K5, and its input gradient through cuDNN
    (``conv1d_input``, which takes about half a second at base's shape)."""
    g = torch.Generator(device=dev).manual_seed(T * 7 + Cg)
    x, d = (torch.randn((B, T, H), generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    w = (torch.randn((H, Cg, K), generator=g, device=dev) / math.sqrt(Cg * K)).to(torch.bfloat16)
    bias = (torch.randn(H, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    fwd = lambda: pos_conv.pos_conv_fwd(x, w, bias)
    dgrad = lambda: pos_conv.pos_conv_dgrad(d, w)
    _lib.reset_launches()
    pre, out_ = fwd()
    dx = dgrad()
    launches = [_lib.launches["pos_conv"], _lib.launches["pos_conv_dgrad"]]
    pre_ref, out_ref = pos_conv.pos_conv_fwd_plain(x, w, bias)
    dx_ref = pos_conv.pos_conv_dgrad_plain(d, w)
    torch.cuda.synchronize()
    again = fwd()
    bits = (torch.equal(again[0], pre) and torch.equal(again[1], out_)
            and torch.equal(dgrad(), dx))
    out = {"phase": "kernels", "kernel": "pos_conv", "B": B, "T": T, "H": H, "groups": H // Cg,
           "Cg": Cg, "K": K, "dtype": "bfloat16", "tol_rel": POS_CONV_TOL, "bits_repeat": bits,
           "launches_per_call": launches}
    fail = [] if bits else ["bits"]
    if launches != [1, 1]:
        fail.append("launches")
    for name, got, want in (("pre", pre, pre_ref), ("out", out_, out_ref), ("dx", dx, dx_ref)):
        out[f"{name}_max_abs_err"], out[f"{name}_rel_err"] = rel_err(got, want)
        if not out[f"{name}_rel_err"] <= POS_CONV_TOL:
            fail.append(name)
    xt = x.transpose(1, 2)
    dy = torch.nn.functional.pad(d.transpose(1, 2), (0, 1 - K % 2))
    library = {"fwd": lambda: torch.nn.functional.conv1d(xt, w, bias, padding=K // 2,
                                                         groups=H // Cg),
               "dgrad": lambda: torch.nn.grad.conv1d_input(xt.shape, w, dy, padding=K // 2,
                                                           groups=H // Cg)}
    # 2·B·T·H·Cg·K operations each way; the forward reads x and the weight
    # and writes pre and gelu(pre), the gradient reads dpre and the weight
    # and writes dx
    n, wb = B * T * H * 2, H * Cg * K * 2
    for direction, call, plain, nbytes in (
            ("fwd", fwd, lambda: pos_conv.pos_conv_fwd_plain(x, w, bias), 3 * n + wb),
            ("dgrad", dgrad, lambda: pos_conv.pos_conv_dgrad_plain(d, w), 2 * n + wb)):
        out[f"{direction}_ms"] = time_ms(call, iters)
        out[f"{direction}_device_ms"] = fm_profile.graph_ms(call, 20)
        out[f"{direction}_plain_ms"] = time_ms(plain, 2)
        out[f"{direction}_library_ms"] = time_ms(library[direction], 2)
        ms, by = bound(2 * B * T * H * Cg * K, nbytes, torch.bfloat16)
        out[f"{direction}_bound_ms"], out[f"{direction}_bound_by"] = ms, by
        out[f"{direction}_peak_share"] = ms / out[f"{direction}_device_ms"]
    out["failed"] = fail
    emit(out)
    return out


def check_fe_norm(B, C, T, dev, iters=10, more=False) -> dict:
    """K6's forward (with the statistics, as under grad) and backward against
    the plain version in float32 on the same bf16 values, their bits on a
    repeat and one launch a call; each direction's ms, its device ms (a CUDA
    graph of 20 calls), its byte bound (4 B a value forward, 6 B backward,
    the statistics' 8 B a frame), the plain version's ms in bf16 (the layer
    before K6) and the library's: ``F.layer_norm`` on the (B, T, C) view and
    ``F.gelu``, and its autograd backward alone. With ``more``, also
    (fe_norm_more) the backward with the weight gradients and the (B, T, C)
    layout of the conv lowerings each way."""
    g = torch.Generator(device=dev).manual_seed(T * 7 + C)
    y = (torch.randn((B, C, T), generator=g, device=dev) * 2 + 0.3).to(torch.bfloat16)
    dout = torch.randn((B, C, T), generator=g, device=dev).to(torch.bfloat16)
    params = [torch.randn(C, generator=g, device=dev) * 0.3,
              1 + torch.randn(C, generator=g, device=dev) * 0.2,
              torch.randn(C, generator=g, device=dev) * 0.2]
    eps = 1e-5
    fwd = lambda: fe_norm.fe_norm_fwd(y, *params, eps, True, stats=True)
    _lib.reset_launches()
    out_, mean, rstd = fwd()
    bwd = lambda: fe_norm.fe_norm_bwd(dout, y, *params, mean, rstd, True, wgrad=False)
    dx = bwd()[0]
    launches = [_lib.launches["fe_norm"], _lib.launches["fe_norm_bwd"]]
    torch.cuda.synchronize()
    bits = torch.equal(fwd()[0], out_) and torch.equal(bwd()[0], dx)
    yr = y.float().requires_grad_(True)
    out_ref = fe_norm.fe_norm_gelu_plain(yr, *params, eps, True)
    (dx_ref,) = torch.autograd.grad(out_ref, yr, dout.float())
    out = {"phase": "kernels", "kernel": "fe_norm", "B": B, "C": C, "T": T, "dtype": "bfloat16",
           "tol_rel": FE_NORM_TOL, "bits_repeat": bits, "launches_per_call": launches}
    fail = [] if bits else ["bits"]
    if launches != [1, 1]:
        fail.append("launches")
    for name, got, want in (("out", out_, out_ref), ("dx", dx, dx_ref)):
        out[f"{name}_max_abs_err"], _ = rel_err(got, want)
        out[f"{name}_rel_err"] = out[f"{name}_max_abs_err"] / float(want.abs().max())
        if not out[f"{name}_rel_err"] <= FE_NORM_TOL:
            fail.append(name)
    del yr, out_ref, dx_ref
    torch.cuda.empty_cache()

    def autograd_pair(fn):
        """(forward, its backward alone) of ``fn`` on a leaf copy of y."""
        leaf = y.detach().requires_grad_(True)
        held = fn(leaf)
        return (lambda: fn(leaf),
                lambda: torch.autograd.grad(held, leaf, dout, retain_graph=True))

    plain = autograd_pair(lambda t: fe_norm.fe_norm_gelu_plain(t, *params, eps, True))
    lib_params = [p.to(torch.bfloat16) for p in params]
    library = autograd_pair(lambda t: torch.nn.functional.gelu(torch.nn.functional.layer_norm(
        (t + lib_params[0][:, None]).transpose(1, 2), (C,), lib_params[1], lib_params[2], eps),
        approximate="tanh").transpose(1, 2))
    n, stats = B * C * T, 8 * B * T
    for i, (direction, call, nbytes) in enumerate((("fwd", fwd, 4 * n + stats),
                                                   ("bwd", bwd, 6 * n + stats))):
        out[f"{direction}_ms"] = time_ms(call, iters)
        out[f"{direction}_device_ms"] = fm_profile.graph_ms(call, 20)
        out[f"{direction}_plain_ms"] = time_ms(plain[i], 2)
        out[f"{direction}_library_ms"] = time_ms(library[i], 2)
        ms, by = bound(0, nbytes, torch.bfloat16)
        out[f"{direction}_bound_ms"], out[f"{direction}_bound_by"] = ms, by
        out[f"{direction}_peak_share"] = ms / out[f"{direction}_device_ms"]
    del plain, library
    torch.cuda.empty_cache()
    if more:
        fail += fe_norm_more(out, y, dout, params, mean, rstd, eps)
    out["failed"] = fail
    emit(out)
    return out


def fe_norm_more(out: dict, y, dout, params, mean, rstd, eps) -> list:
    """K6's backward with the weight gradients (pretraining): its device ms
    and the device memory it holds above its inputs and output (the weight
    gradients' rows, one a block), beside the backward without them; and
    the (B, T, C) layout of the conv lowerings each way: error against the
    plain version and device ms. Adds its numbers to ``out``; returns the
    names of the checks that failed."""
    fail = []
    B, C, T = y.shape

    def held(call) -> int:
        """Device memory at the call's peak above the memory before it,
        less its (B, C, T) result."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(y.device)
        before = torch.cuda.memory_allocated(y.device)
        res = call()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(y.device) - before - res[0].nbytes
        del res
        return extra

    wgrad = lambda: fe_norm.fe_norm_bwd(dout, y, *params, mean, rstd, True, wgrad=True)
    bwd = lambda: fe_norm.fe_norm_bwd(dout, y, *params, mean, rstd, True, wgrad=False)
    dx_w, dbias, dw, db = wgrad()
    dx = bwd()[0]
    leaves = [y.float().requires_grad_(True)] + [p.clone().requires_grad_(True) for p in params]
    want = torch.autograd.grad(fe_norm.fe_norm_gelu_plain(leaves[0], *leaves[1:], eps, True),
                               leaves, dout.float())
    errs = {name: float((a - b).abs().max() / b.abs().max())
            for name, a, b in zip(("bias", "weight", "bias_ln"), (dbias, dw, db), want[1:])}
    del leaves, want
    out.update(wgrad_bwd_device_ms=fm_profile.graph_ms(wgrad, 20),
               wgrad_bwd_held_bytes=held(wgrad), bwd_held_bytes=held(bwd),
               wgrad_blocks=fe_norm.wgrad_blocks(y, 1), wgrad_rel_err=errs,
               wgrad_dx_equal=torch.equal(dx_w, dx))
    if not (max(errs.values()) <= FE_NORM_TOL and out["wgrad_dx_equal"]):
        fail.append("wgrad")
    # the (B, T, C) layout: the same values transposed
    yt, dt = (t.transpose(1, 2).contiguous() for t in (y, dout))
    fwd_t = lambda: fe_norm.fe_norm_fwd(yt, *params, eps, True, stats=True, dim=2)
    out_t, mean_t, rstd_t = fwd_t()
    bwd_t = lambda: fe_norm.fe_norm_bwd(dt, yt, *params, mean_t, rstd_t, True, False, dim=2)
    dx_t = bwd_t()[0]
    yr = yt.float().requires_grad_(True)
    ref = fe_norm.fe_norm_gelu_plain(yr, *params, eps, True, 2)
    (dx_ref,) = torch.autograd.grad(ref, yr, dt.float())
    for name, got, want in (("out", out_t, ref), ("dx", dx_t, dx_ref)):
        out[f"btc_{name}_rel_err"] = float((got.float() - want).abs().max() / want.abs().max())
        if not out[f"btc_{name}_rel_err"] <= FE_NORM_TOL:
            fail.append(f"btc_{name}")
    del yr, ref, dx_ref
    n, stats = B * C * T, 8 * B * T
    for direction, call, nbytes in (("fwd", fwd_t, 4 * n + stats), ("bwd", bwd_t, 6 * n + stats)):
        out[f"btc_{direction}_device_ms"] = fm_profile.graph_ms(call, 20)
        out[f"btc_{direction}_peak_share"] = (bound(0, nbytes, torch.bfloat16)[0]
                                              / out[f"btc_{direction}_device_ms"])
    del yt, dt, out_t, dx_t
    torch.cuda.empty_cache()
    return fail


def check_layer_norm(B, T, C, dev, iters=20, wgrad=False) -> dict:
    """K7's forward (saving x̂ and 1/std, as under grad) and backward against
    the plain version in float32 on the same bf16 values, their bits on a
    repeat and one launch a call; each direction's ms, its device ms (a CUDA
    graph of 20 calls), its byte bound (6 B a value each way, 1/std's 4 B a
    row), the plain version's ms in bf16 (the route before K7) and the
    library's, ``F.layer_norm`` and its autograd backward alone; and the
    forward with grad off (4 B a value), as an eval batch runs it. With
    ``wgrad``, also the backward with the weight gradients (pretraining's):
    dγ and dβ against the plain version's, its dx equal to the one without
    them, its bits on a repeat and its device ms."""
    g = torch.Generator(device=dev).manual_seed(T * 7 + C)
    x = (torch.randn((B, T, C), generator=g, device=dev) * 1.5 + 0.1).to(torch.bfloat16)
    dout = torch.randn((B, T, C), generator=g, device=dev).to(torch.bfloat16)
    weight = 1 + torch.randn(C, generator=g, device=dev) * 0.2
    bias = torch.randn(C, generator=g, device=dev) * 0.2
    eps = 1e-5
    fwd = lambda: layer_norm.layer_norm_fwd(x, weight, bias, eps, save=True)
    _lib.reset_launches()
    out_, xhat, rstd = fwd()
    bwd = lambda: layer_norm.layer_norm_bwd(dout, xhat, rstd, weight, wgrad=False)
    dx = bwd()[0]
    launches = [_lib.launches["layer_norm"], _lib.launches["layer_norm_bwd"]]
    torch.cuda.synchronize()
    bits = torch.equal(fwd()[0], out_) and torch.equal(bwd()[0], dx)
    xr = x.float().requires_grad_(True)
    out_ref = wav2vec2._LayerNormFn.apply(xr, weight, bias, eps)
    (dx_ref,) = torch.autograd.grad(out_ref, xr, dout.float())
    out_ref = out_ref.detach()
    out = {"phase": "kernels", "kernel": "layer_norm", "B": B, "T": T, "C": C,
           "dtype": "bfloat16", "tol_rel": LAYER_NORM_TOL, "bits_repeat": bits,
           "launches_per_call": launches}
    fail = [] if bits else ["bits"]
    if launches != [1, 1]:
        fail.append("launches")
    for name, got, want in (("out", out_, out_ref), ("dx", dx, dx_ref)):
        out[f"{name}_max_abs_err"], _ = rel_err(got, want)
        out[f"{name}_rel_err"] = out[f"{name}_max_abs_err"] / float(want.abs().max())
        if not out[f"{name}_rel_err"] <= LAYER_NORM_TOL:
            fail.append(name)
    del xr, out_ref, dx_ref
    torch.cuda.empty_cache()

    def autograd_pair(fn):
        """(forward, its backward alone) of ``fn`` on a leaf copy of x."""
        leaf = x.detach().requires_grad_(True)
        held = fn(leaf)
        return (lambda: fn(leaf),
                lambda: torch.autograd.grad(held, leaf, dout, retain_graph=True))

    plain = autograd_pair(lambda t: wav2vec2._LayerNormFn.apply(t, weight, bias, eps))
    lib_params = [p.to(torch.bfloat16) for p in (weight, bias)]
    library = autograd_pair(lambda t: torch.nn.functional.layer_norm(t, (C,), *lib_params, eps))
    n, stats = B * T * C, 4 * B * T
    for i, (direction, call) in enumerate((("fwd", fwd), ("bwd", bwd))):
        out[f"{direction}_ms"] = time_ms(call, iters)
        out[f"{direction}_device_ms"] = fm_profile.graph_ms(call, 20)
        out[f"{direction}_plain_ms"] = time_ms(plain[i], 2)
        out[f"{direction}_library_ms"] = time_ms(library[i], 2)
        ms, by = bound(0, 6 * n + stats, torch.bfloat16)
        out[f"{direction}_bound_ms"], out[f"{direction}_bound_by"] = ms, by
        out[f"{direction}_peak_share"] = ms / out[f"{direction}_device_ms"]
    del plain, library
    nosave = lambda: layer_norm.layer_norm_fwd(x, weight, bias, eps, save=False)
    out["fwd_nosave_device_ms"] = fm_profile.graph_ms(nosave, 20)
    out["fwd_nosave_peak_share"] = (bound(0, 4 * n, torch.bfloat16)[0]
                                    / out["fwd_nosave_device_ms"])
    if not torch.equal(nosave()[0], out_):
        fail.append("nosave")
    if wgrad:
        fail += layer_norm_wgrad(out, x, dout, xhat, rstd, weight, bias, eps, dx)
    torch.cuda.empty_cache()
    out["failed"] = fail
    emit(out)
    return out


def layer_norm_wgrad(out: dict, x, dout, xhat, rstd, weight, bias, eps, dx) -> list:
    """K7's backward with the weight gradients, as pretraining runs it: dγ
    and dβ (one row a block of ``wgrad_blocks``, summed by the wrapper)
    against the plain version's autograd in float32 on the same values, its
    dx against ``dx`` of the backward without them, its bits on a repeat
    and its device ms. Adds its numbers to ``out``; returns the names of
    the checks that failed."""
    call = lambda: layer_norm.layer_norm_bwd(dout, xhat, rstd, weight, wgrad=True)
    dx_w, dw, db = call()
    again = call()
    leaves = [x.float().requires_grad_(True), weight.clone().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    want = torch.autograd.grad(wav2vec2._LayerNormFn.apply(*leaves, eps), leaves,
                               dout.float())
    errs = {name: float((got - ref).abs().max() / ref.abs().max())
            for name, got, ref in (("weight", dw, want[1]), ("bias", db, want[2]))}
    del leaves, want
    out.update(wgrad_rel_err=errs, wgrad_dx_equal=torch.equal(dx_w, dx),
               wgrad_bits_repeat=all(torch.equal(a, b) for a, b in zip(again, (dx_w, dw, db))),
               wgrad_blocks=layer_norm.wgrad_blocks(xhat),
               wgrad_bwd_device_ms=fm_profile.graph_ms(call, 20))
    ok = (max(errs.values()) <= LAYER_NORM_TOL and out["wgrad_dx_equal"]
          and out["wgrad_bits_repeat"])
    return [] if ok else ["wgrad"]


def check_relpos(B, T, H, dev, iters=20) -> dict:
    """K8 (relative-position attention, bf16, head dim 64) against its plain
    version: errors, bits on a repeat, the call's and the device's ms beside
    its bound (6·B·H·T²·d operations forward, 14·B·H·T²·d backward) and K1's
    and K2's device ms at the same shape, and how far a forward and a
    backward raise the allocator's high-water mark above their inputs,
    outputs, lse and scratch."""
    d, dt = 64, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(T * 11 + B)
    r = lambda rows, scale: (torch.randn((*rows, H * d), generator=g, device=dev)
                             * scale).to(dt)
    qu, qv, k, v, do = (r((B, T), 0.125), r((B, T), 0.125), r((B, T), 1.0), r((B, T), 1.0),
                        r((B, T), 1.0))
    pos = r((2 * T - 1,), 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    o, lse = attention.attention_relpos_fwd(qu, qv, k, v, pos, H)
    grads = attention.attention_relpos_bwd(qu, qv, k, v, pos, o, lse, do, H)
    torch.cuda.synchronize()
    kept = o.nbytes + lse.nbytes + sum(t.nbytes for t in grads)
    out = {"phase": "kernels", "kernel": "attention_relpos", "B": B, "T": T, "H": H, "d": d,
           "dtype": "bfloat16", "tol_rel": ATTN_TOL[dt], "tol_lse_abs": LSE_ABS_TOL[dt],
           "hwm_over_outputs_mib": (torch.cuda.max_memory_allocated() - base - kept) / 2**20,
           "one_bhtt_bf16_mib": B * H * T * T * 2 / 2**20}
    again = attention.attention_relpos_bwd(qu, qv, k, v, pos, o, lse, do, H)
    o2, _ = attention.attention_relpos_fwd(qu, qv, k, v, pos, H)
    out["bits_repeat"] = bool(torch.equal(o, o2)) and all(
        bool(torch.equal(a, b)) for a, b in zip(grads, again))
    del again, o2
    o_ref, lse_ref = attention.attention_relpos_fwd_plain(qu, qv, k, v, pos, H)
    out["lse_max_abs_err"] = rel_err(lse, lse_ref)[0]
    out["o_max_abs_err"], out["o_rel_err"] = rel_err(o, o_ref)
    del o_ref, lse_ref
    want = attention.attention_relpos_bwd_plain(qu, qv, k, v, pos, o, lse, do, H)
    for name, got, ref in zip(("dqu", "dqv", "dk", "dv"), grads, want):
        out[f"{name}_max_abs_err"], out[f"{name}_rel_err"] = rel_err(got, ref)
    del want
    torch.cuda.empty_cache()
    fail = [n for n in ("o", "dqu", "dqv", "dk", "dv") if not out[f"{n}_rel_err"] <= ATTN_TOL[dt]]
    if not out["lse_max_abs_err"] <= LSE_ABS_TOL[dt]:
        fail.append("lse")
    if not out["bits_repeat"]:
        fail.append("bits")
    calls = 5 * iters
    fwd = lambda: attention.attention_relpos_fwd(qu, qv, k, v, pos, H)
    bwd = lambda: attention.attention_relpos_bwd(qu, qv, k, v, pos, o, lse, do, H)
    out["fwd_ms"], out["bwd_ms"] = time_ms(fwd, iters), time_ms(bwd, iters)
    out["fwd_device_ms"] = fm_profile.graph_ms(fwd, calls)
    out["bwd_device_ms"] = fm_profile.graph_ms(bwd, calls)
    o1, lse1 = attention.attention_fwd(qu, k, v, H)
    out["k1_fwd_device_ms"] = fm_profile.graph_ms(lambda: attention.attention_fwd(qu, k, v, H),
                                                  calls)
    out["k2_bwd_device_ms"] = fm_profile.graph_ms(
        lambda: attention.attention_bwd(qu, k, v, o1, lse1, do, H), calls)
    n, stats, table = B * T * H * d * 2, B * H * T * 4, (2 * T - 1) * H * d * 2
    out["fwd_bound_ms"], out["fwd_bound_by"] = bound(6 * B * H * T * T * d,
                                                     5 * n + stats + table, dt)
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(14 * B * H * T * T * d,
                                                     10 * n + stats + table, dt)
    out["fwd_share_of_bound"] = out["fwd_bound_ms"] / out["fwd_device_ms"]
    out["bwd_share_of_bound"] = out["bwd_bound_ms"] / out["bwd_device_ms"]
    out["fwd_over_k1"] = out["fwd_device_ms"] / out["k1_fwd_device_ms"]
    out["bwd_over_k2"] = out["bwd_device_ms"] / out["k2_bwd_device_ms"]
    out["failed"] = fail
    emit(out)
    return out


def phase_relpos(dev) -> dict:
    """K8 at the relative conformer's 30 s microbatch and at 20 s, and at
    ragged small shapes."""
    small = [check_relpos(2, T, 2, dev, iters=5) for T in (1, 65, 130)]
    at_main = {"relpos_30s": check_relpos(16, 1499, 16, dev),
               "relpos_20s": check_relpos(32, 999, 16, dev)}
    bad = [r for r in small + list(at_main.values()) if r["failed"]]
    check(not bad, f"K8 out of tolerance: {bad}")
    return at_main


def phase_kernels(dev) -> dict:
    """Every check runs; the phase fails after them if any was out of
    tolerance. Returns the checks at the main path's shapes."""
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for T in (1, 130, 499, 640):
            results.append(check_attention(2, T, 12, 64, dtype, dev))
        for T in (130, 499):
            results.append(check_attention(2, T, 4, 16, dtype, dev))
        for T in LONG_T:  # the shapes of the JAX package's flash kernel (K4)
            results.append(check_attention(2, T, 16, 64, dtype, dev))
    at_main = {"attention": check_attention(MAIN_B, 499, 12, 64, torch.bfloat16, dev),
               # one lv60 microbatch: B/A rows × 20 s
               "attention_long": check_attention(LV60_B // LV60_ACCUM, 999, 16, 64,
                                                 torch.bfloat16, dev),
               # lv60's whole batch in one microbatch (phase 11 (b))
               "attention_long_a1": check_attention(LV60_B, 999, 16, 64, torch.bfloat16, dev,
                                                    iters=5),
               # base under --compute_dtype float32: the register route at
               # full width
               "attention_base_f32": check_attention(MAIN_B, 499, 12, 64, torch.float32, dev,
                                                     iters=5)}

    cfg = AttackConfig(norm_type="fletcher_munson")
    tables = psycho.build_tables(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    stft = lambda n: dsp.stft(torch.randn((1, n), generator=g, device=dev) * 0.01, cfg.n_fft,
                              cfg.hop_length, cfg.win_length)
    # p's STFT on the main path, (1, 513, 626), and lv60's, (1, 513, 1251), in
    # torch.stft's layout (bins innermost in memory), then made contiguous
    spec_main, spec_lv60 = stft(MAIN_T), stft(LV60_T)
    at_main["fm_norm"] = check_fm(spec_main, tables, "main_path")
    # K5 at base's batch and an lv60 microbatch, and at the tiny anchor's
    # groups and a ragged length
    at_main["pos_conv"] = check_pos_conv(MAIN_B, 499, 768, 48, 128, dev)
    at_main["pos_conv_long"] = check_pos_conv(LV60_B // LV60_ACCUM, 999, 1024, 64, 128, dev)
    results.append(check_pos_conv(32, 152, 64, 16, 16, dev))
    results.append(check_pos_conv(2, 130, 768, 48, 128, dev))
    # K6 at lv60's layer 0 (also with weight gradients, and on (B, T, C)) and
    # layer 6 for one microbatch of 20 s clips, a C other than 512 and T = 1
    at_main["fe_norm_l0"] = check_fe_norm(LV60_B // LV60_ACCUM, 512, 63_999, dev, more=True)
    at_main["fe_norm_l6"] = check_fe_norm(LV60_B // LV60_ACCUM, 512, 999, dev)
    results.append(check_fe_norm(4, 264, 777, dev))
    results.append(check_fe_norm(3, 512, 1, dev))
    # K7 at an lv60 attack microbatch (20 s and 30 s), an lv60 eval batch,
    # a base batch and lv60's feature projection
    at_main["layer_norm_lv60"] = check_layer_norm(LV60_B // LV60_ACCUM, 999, 1024, dev,
                                                  wgrad=True)
    results.append(check_layer_norm(16, 1499, 1024, dev))
    results.append(check_layer_norm(LV60_B, 999, 1024, dev))
    at_main["layer_norm_base"] = check_layer_norm(MAIN_B, 499, 768, dev, wgrad=True)
    results.append(check_layer_norm(LV60_B // LV60_ACCUM, 999, 512, dev))
    at_main["fm_norm_lv60"] = check_fm(spec_lv60, tables, "lv60")
    results.append(check_fm(spec_main.contiguous(), tables, "main_path_contiguous"))
    results.append(check_fm(spec_lv60.contiguous(), tables, "lv60_contiguous"))
    spec_b2 = torch.complex(torch.randn((2, 513, 130), generator=g, device=dev) * 10,
                            torch.randn((2, 513, 130), generator=g, device=dev) * 10)
    results.append(check_fm(spec_b2, tables, "B2_T130"))
    results.append(check_fm(spec_b2.transpose(1, 2).contiguous().transpose(1, 2), tables,
                            "B2_T130_frames_major"))
    edges = fm_edge_stft(dev)
    results.append(check_fm(edges, tables, "edges_power0_spl0_spl90"))
    results.append(check_fm(edges.transpose(1, 2).contiguous().transpose(1, 2), tables,
                            "edges_frames_major"))
    results.append(check_fm(spec_main[..., ::2], tables, "every_other_frame_strided"))
    # the base sweep's shapes (phase 7): its synthetic corpus fixes its clip
    # length from the seed, 160,955 samples
    sweep_len = sweep_audio_len()
    at_main["attention_sweep"] = check_attention(
        MAIN_B, wav2vec2.get_config("wav2vec2-base").feat_extract_output_length(sweep_len),
        12, 64, torch.bfloat16, dev)
    at_main["fm_norm_sweep"] = check_fm(stft(sweep_len), tables, "sweep")
    # the pretraining batches of phase 8: base (bf16, the Hopper route) and
    # the tiny recipe (float32, the register route), at their corpora's lengths
    at_main["attention_pretrain"] = check_attention(
        32, pretrain_frames(PRETRAIN_BASE_ARGV), 12, 64, torch.bfloat16, dev)
    at_main["attention_pretrain_tiny"] = check_attention(
        32, pretrain_frames(PRETRAIN_TINY_ARGV), 4, 16, torch.float32, dev)
    # phase 9's ranks: dp=2 holds 32 of base's 64 rows, tp=2 six of its 12
    # heads at B=16
    at_main["attention_dp"] = check_attention(PAR_DP_B // PAR_RANKS, 499, 12, 64,
                                              torch.bfloat16, dev)
    at_main["attention_tp"] = check_attention(PAR_TP_B, 499, 12 // PAR_RANKS, 64,
                                              torch.bfloat16, dev)
    at_main.update(phase_relpos(dev))
    bad = [r for r in results + list(at_main.values()) if r["failed"]]
    check(not bad, f"kernels out of tolerance: {bad}")
    return at_main


# ---------------------------------------------------------------------------
# phase 3: the tiny checkpoint, card against CPU
# ---------------------------------------------------------------------------


def tiny_inputs(B=4, T=32_000):
    audio = np.zeros((B, T), np.float32)
    texts = []
    for i, (wav, _sr, txt) in enumerate(synthetic.generate_corpus(B, seed=SEED)):
        n = min(T, len(wav))
        audio[i, :n] = wav[:n]
        texts.append(txt)
    labels, pads = text.encode_batch(texts)
    p0 = np.random.default_rng(SEED).standard_normal((1, T)).astype(np.float32) * 1e-3
    return audio, labels, pads, p0


def run_tiny(dev, sd, arrays):
    audio, labels, pads, p0 = (torch.from_numpy(a).to(dev) for a in arrays)
    model = wav2vec2.Wav2Vec2ForCTC(wav2vec2.get_config("wav2vec2-tiny"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.to(dev)
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd")
    tables = psycho.build_tables(cfg, dev)
    weights = torch.ones(audio.shape[0], device=dev)
    train = step.make_train_step(cfg, model, tables)
    evaluate = step.make_eval_step(cfg, model)
    loss, _, grad = step._grad_and_metrics(model, cfg, p0, audio, labels, pads, weights)
    new_p, _, m = train(p0, None, audio, labels, pads, weights,
                        ConstraintParams.create(device=dev), cfg.lr)
    e = evaluate(new_p, audio, labels, pads, weights)
    return {"loss": float(m.ctc_loss), "grad": grad.cpu(), "new_p": new_p.cpu(),
            "eval_loss": float(e.ctc_loss), "ids": m.greedy_ids.cpu(), "lr": cfg.lr}


def phase_tiny(dev) -> None:
    sd = checkpoint_io.load_safetensors(TINY_CKPT)
    arrays = tiny_inputs()
    _lib.reset_launches()
    gpu = run_tiny(dev, sd, arrays)
    launched = dict(_lib.launches)
    cpu = run_tiny(torch.device("cpu"), sd, arrays)
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    eval_rel = abs(gpu["eval_loss"] - cpu["eval_loss"]) / abs(cpu["eval_loss"])
    sign_agree = float((torch.sign(gpu["grad"]) == torch.sign(cpu["grad"])).float().mean())
    p_diff = float((gpu["new_p"] - cpu["new_p"]).abs().max())
    ids_agree = float((gpu["ids"] == cpu["ids"]).float().mean())
    tol = {"loss_rel": 1e-4, "sign_agreement_min": 0.99, "new_p_max_abs": 2 * gpu["lr"],
           "eval_loss_rel": 1e-4}
    emit({"phase": "tiny", "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
          "loss_rel_err": loss_rel, "eval_loss_cuda": gpu["eval_loss"],
          "eval_loss_cpu": cpu["eval_loss"], "eval_loss_rel_err": eval_rel,
          "grad_sign_agreement": sign_agree, "new_p_max_abs_diff": p_diff,
          "greedy_id_agreement": ids_agree, "launches_cuda": launched, "tolerance": tol})
    check(loss_rel <= tol["loss_rel"], f"tiny: train loss rel err {loss_rel}")
    check(eval_rel <= tol["eval_loss_rel"], f"tiny: eval loss rel err {eval_rel}")
    check(sign_agree >= tol["sign_agreement_min"], f"tiny: sign agreement {sign_agree}")
    check(p_diff <= tol["new_p_max_abs"], f"tiny: new p differs by {p_diff}")
    # the gradient, the train step and the eval step each run the layers
    # forward; the first two also backward; the train step projects once
    mcfg = wav2vec2.get_config("wav2vec2-tiny")
    L, ln = mcfg.num_hidden_layers, ln_layers(mcfg)
    # float32, head dim 16: the register route of K1/K2
    check(launched == counts(attention_fwd=3 * L, attention_bwd=2 * L, fm_norm=1,
                             layer_norm=3 * ln, layer_norm_bwd=2 * ln),
          f"tiny: kernel launches on the card {launched}")


# ---------------------------------------------------------------------------
# phase 4: wav2vec2-base at full width
# ---------------------------------------------------------------------------


def full_width_batch(B: int, T: int, dev) -> list:
    """The full-width runs' batch: audio N(0, 0.1²) from SEED, one
    sentence's labels on every row, all rows real."""
    rng = np.random.default_rng(SEED)
    audio = torch.from_numpy(rng.standard_normal((B, T)).astype(np.float32) * 0.1).to(dev)
    labels, pads = (torch.from_numpy(a).to(dev) for a in
                    text.encode_batch(["the quick brown fox jumps over the lazy dog"] * B))
    return [audio, labels, pads, torch.ones(B, device=dev)]


def fe_layers(mcfg) -> int:
    """Feature-extractor layers that launch K6 in one forward on the card:
    every layer of a LayerNorm feature extractor, in any compute dtype and
    under any conv lowering, none at base."""
    return len(mcfg.conv_dim) if mcfg.feat_extract_norm == "layer" else 0


def ln_layers(mcfg) -> int:
    """LayerNorms that launch K7 in one forward on the card: two a layer,
    the one before (post-LN) or after (pre-LN) the stack, and the feature
    projection's."""
    return 2 * mcfg.num_hidden_layers + 2


def ln_step(mcfg, accum: int) -> dict:
    """K7's launches in a train step of ``accum`` microbatches: each
    LayerNorm once each way a microbatch; the ``full`` and ``save_resid``
    remat policies run each layer's two forward again in the backward."""
    again = 2 * mcfg.num_hidden_layers if mcfg.remat and mcfg.remat_policy in (
        "full", "save_resid") else 0
    return {"layer_norm": (ln_layers(mcfg) + again) * accum,
            "layer_norm_bwd": ln_layers(mcfg) * accum}


def fe_step(mcfg, accum: int) -> dict:
    """K6's launches in a train step of ``accum`` microbatches: each layer
    once each way a microbatch, its forward twice under feature-extractor
    remat (the checkpoint runs it again in the backward)."""
    fe = fe_layers(mcfg)
    return {"fe_norm": fe * accum * (2 if mcfg.remat_feature_extractor else 1),
            "fe_norm_bwd": fe * accum}


def phase_full_width(dev, phase: str, preset: str, B: int, T: int, accum: int,
                     timed_steps: int, card: str, model=None, grad: bool = False) -> dict:
    """One attack configuration at full width: random weights from SEED (or
    ``model``'s), bf16 compute and storage, fletcher_munson PGD with
    ``accum`` microbatches. Returns the launch counts of its run, its step
    time, its peak memory, the first step's loss (from p = 0) and the model;
    with ``grad`` also ∂loss/∂p at p = 0, taken after the run's counts."""
    t0 = time.perf_counter()
    if model is None:
        model = wav2vec2.init_model(wav2vec2.get_config(preset), seed=SEED)
        model = model.cast_param_storage(torch.bfloat16).to(dev)
    mcfg = model.cfg
    L = mcfg.num_hidden_layers
    # full remat runs every layer's forward again in its backward, K1 included
    k1 = 2 if mcfg.remat and mcfg.remat_policy == "full" else 1
    cfg = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", lr=1e-4,
                       accum_steps=accum, model_name=preset)
    tables = psycho.build_tables(cfg, dev)
    cparams = ConstraintParams.create(device=dev)
    audio, labels, pads, weights = full_width_batch(B, T, dev)
    p = torch.zeros((1, T), device=dev)
    opt = optimizers.init_opt_state(cfg, p)
    train = step.make_train_step(cfg, model, tables)
    evaluate = step.make_eval_step(cfg, model)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # per train step: every layer forward and backward in each microbatch,
    # one projection; the eval step is one forward pass over the batch
    # (bf16, head dim 64: the wgmma route of K1/K2); the positional conv
    # once each way a microbatch, through K5 in bf16; lv60's feature
    # extractor through K6 (fe_step); every LayerNorm through K7 (ln_step)
    pc = int(mcfg.compute_dtype == "bfloat16")
    per_step = counts(attention_fwd_sm90=k1 * L * accum, attention_bwd_sm90=L * accum, fm_norm=1,
                      pos_conv=pc * accum, pos_conv_dgrad=pc * accum, **fe_step(mcfg, accum),
                      **ln_step(mcfg, accum))
    times = lambda n: {k: v * n for k, v in per_step.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    _lib.reset_launches()
    losses = []
    p, opt, m = train(p, opt, audio, labels, pads, weights, cparams, cfg.lr)  # warm-up
    losses.append(float(m.ctc_loss))
    check(_lib.launches == times(1), f"{phase}: warm-up step launched {_lib.launches}, "
                                     f"want {times(1)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        p, opt, m = train(p, opt, audio, labels, pads, weights, cparams, cfg.lr)
    loss_last = m.ctc_loss
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed_steps
    losses.append(float(loss_last))
    n = timed_steps + 1
    train_launches = dict(_lib.launches)
    check(train_launches == times(n), f"{phase}: {n} train steps launched {train_launches}")
    e = evaluate(p, audio, labels, pads, weights)
    eval_loss = float(e.ctc_loss)
    launches = dict(_lib.launches)
    want = {**times(n), "attention_fwd_sm90": times(n)["attention_fwd_sm90"] + L,
            "pos_conv": times(n)["pos_conv"] + pc,
            "fe_norm": times(n)["fe_norm"] + fe_layers(mcfg),
            "layer_norm": times(n)["layer_norm"] + ln_layers(mcfg)}
    check(launches == want, f"{phase}: eval step launched {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated(dev)
    p_abs = float(p.abs().max())
    finite = all(np.isfinite(losses + [eval_loss])) and bool(torch.isfinite(p).all())
    remat = {k: getattr(mcfg, k) for k in ("remat", "remat_policy", "remat_feature_extractor",
                                           "remat_fe_save_layers", "remat_ffn")}
    emit({"phase": phase, "model": preset, "layers": L, "hidden": mcfg.hidden_size,
          "heads": mcfg.num_attention_heads, "batch": B, "samples": T,
          "frames": mcfg.feat_extract_output_length(T), "accum_steps": accum, **remat,
          "compute_dtype": mcfg.compute_dtype, "param_storage": "bfloat16",
          "norm": cfg.norm_type, "optimizer": cfg.optimizer_type, "setup_s": setup_s,
          "step_s": step_s, "steps_per_s": 1.0 / step_s, "timed_steps": timed_steps,
          "losses": losses, "eval_loss": eval_loss, "p_max_abs": p_abs,
          "peak_mem_bytes": peak, "peak_mem_gib": peak / 2**30, "card": card,
          "launches": launches, "launches_per_train_step": per_step})
    check(finite, f"{phase}: non-finite loss or perturbation")
    check(p_abs > 0.0, f"{phase}: the perturbation did not change")
    out = {"launches": launches, "per_step": per_step, "step_s": step_s, "peak": peak,
           "first_loss": losses[0], "model": model}
    if grad:
        p0 = torch.zeros((1, T), device=dev)
        out["grad"] = step._grad_and_metrics(model, cfg, p0, audio, labels, pads, weights)[2]
    return out


# ---------------------------------------------------------------------------
# phase 6: the entry point, python -m paa_tpu_torch.cli.run_attack
# ---------------------------------------------------------------------------

# The JAX package's clean test eval of the tiny checkpoint under the anchor
# flags, on its TPU in bf16 (benchmarks/quality_r5/cells/*/results.json).
ANCHOR = {"ctc": 105.607, "wer": 0.0321}
# bf16 rounds at other places on the card than on the TPU: the port's CPU
# plain path in bf16 gives 105.605 / 0.0334, in f32 105.351 / 0.0321.
ANCHOR_TOL = {"ctc_rel": 1e-2, "wer_abs": 5e-3}
ANCHOR_ARGV = ["--model", "wav2vec2-tiny", "--checkpoint_path", TINY_CKPT,
               "--dataset", "synthetic", "--synthetic_samples", "2048", "--seed", "5",
               "--batch_size", "32", "--optimizer_type", "pgd", "--lr", "1e-4"]
LV60_CLI_ARGV = ["--model", "wav2vec2-large-lv60", "--dataset", "synthetic",
                 "--synthetic_samples", "96", "--synthetic_words", "44,52",
                 "--batch_size", "16", "--accum_steps", "2",
                 "--norm_type", "fletcher_munson", "--optimizer_type", "pgd"]


def run_module(module: str, name: str, argv: list[str],
               out: str | None = None) -> tuple[str, float, dict]:
    """Run ``python -m module argv`` in this process, so that the launch
    counters see its kernels, into a fresh save root (or with ``--out
    <root>/<out>``): (save root, seconds, launch counts)."""
    root = os.path.join(RUNS_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    saved_argv = sys.argv
    where = ["--save_root", root] if out is None else ["--out", os.path.join(root, out)]
    sys.argv = [module, *argv, *where]
    _lib.reset_launches()
    t0 = time.perf_counter()
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        code = 0  # main() returned without sys.exit
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved_argv
    seconds = time.perf_counter() - t0
    launches = dict(_lib.launches)
    check(code == 0, f"{name}: {module} exited {code}")
    return root, seconds, launches


def run_facts(name: str, log_path: str, metrics_path: str) -> dict:
    """The splits and clip length from a run's log, and its epochs from its
    metrics.jsonl."""
    with open(log_path) as f:
        split = re.search(r"splits: train=(\d+) eval=(\d+) test=(\d+) \| audio_len=(\d+)",
                          f.read())
    check(split is not None, f"{name}: no split line in {log_path}")
    with open(metrics_path) as f:
        lines = [json.loads(line) for line in f]
    n_train, n_eval, n_test, audio_len = map(int, split.groups())
    return {"epochs": len(lines), "train": n_train, "eval": n_eval, "test": n_test,
            "audio_len": audio_len, "metrics": lines}


def run_cli(name: str, argv: list[str]) -> tuple[dict, dict, dict]:
    """The entry point as ``python -m`` runs it: (results.json, run facts,
    launch counts). One epoch, no inspection samples, a fresh run
    directory."""
    root, seconds, launches = run_module(
        "paa_tpu_torch.cli.run_attack", name,
        argv + ["--num_epochs", "1", "--num_items_to_inspect", "0", "--no_resume"])
    (run_dir,) = [d for d, _, files in os.walk(root) if "results.json" in files]
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    facts = run_facts(name, os.path.join(run_dir, "train.log"),
                      os.path.join(run_dir, "metrics.jsonl"))
    del facts["metrics"]
    return results, {"run_dir": run_dir, "seconds": seconds, **facts}, launches


def expected_cli_launches(argv: list[str], facts: dict, fm: bool, route: str,
                          cells: int = 1) -> dict:
    """What one CLI run, or a sweep of ``cells`` cells, launches: each cell's
    train step runs every layer forward and backward per microbatch and
    projects once; the clean eval runs once, the perturbed eval once per
    cell and epoch, the test split clean once and perturbed once per cell;
    each cell's initial perturbation is projected once. ``route`` is the
    suffix of the attention counters ("" for the register route, "_sm90" for wgmma).
    Each forward runs the positional conv once and each backward its input
    gradient, through K5 under the bf16 compute dtype, and lv60's feature
    extractor K6 once a layer each way (no CLI flag turns on its remat);
    every LayerNorm K7 once each way, and again forward under the remat
    policies that recompute it (ln_step)."""
    args = parser.create_arg_parser().parse_known_args(argv)[0]
    pc = int(args.compute_dtype == "bfloat16")
    remat, policy = parser.resolve_remat(args)
    mcfg = wav2vec2.get_config(args.model, compute_dtype=args.compute_dtype,
                               conv_impl=args.conv_impl, remat=remat, remat_policy=policy)
    fe, ln = fe_layers(mcfg), ln_step(mcfg, 1)
    A = args.accum_steps
    L = wav2vec2.get_config(args.model).num_hidden_layers
    nb = lambda n: math.ceil(n / args.batch_size)
    steps = cells * facts["epochs"] * nb(facts["train"])
    evals = nb(facts["eval"]) * (1 + cells * facts["epochs"]) + (1 + cells) * nb(facts["test"])
    return counts(**{f"attention_fwd{route}": L * (A * steps + evals),
                     f"attention_bwd{route}": L * A * steps,
                     "fm_norm": (steps + cells) if fm else 0,
                     "pos_conv": pc * (A * steps + evals), "pos_conv_dgrad": pc * A * steps,
                     "fe_norm": fe * (A * steps + evals), "fe_norm_bwd": fe * A * steps,
                     "layer_norm": ln["layer_norm"] * A * steps + ln_layers(mcfg) * evals,
                     "layer_norm_bwd": ln["layer_norm_bwd"] * A * steps})


def phase_cli(card: str) -> dict:
    """Returns each run's launch counts, and the anchor's attention frames."""
    scores = lambda r, key: [r[key]["ctc"], r[key]["wer"]]
    # (a) the ROADMAP anchor: the tiny checkpoint's clean test eval
    res, facts, launches = run_cli("anchor", ANCHOR_ARGV)
    clean = res["final_test_clean"]
    ctc_rel = abs(clean["ctc"] - ANCHOR["ctc"]) / ANCHOR["ctc"]
    wer_abs = abs(clean["wer"] - ANCHOR["wer"])
    want = expected_cli_launches(ANCHOR_ARGV, facts, fm=False, route="")  # head dim 16
    emit({"phase": "cli", "run": "anchor", **facts, "final_test_clean": clean,
          "reference": ANCHOR, "ctc_rel_err": ctc_rel, "wer_abs_err": wer_abs,
          "tolerance": ANCHOR_TOL, "launches": launches, "want_launches": want, "card": card})
    check(res.get("finished_training") is True, "cli anchor: the run did not finish")
    check(ctc_rel <= ANCHOR_TOL["ctc_rel"], f"cli anchor: clean CTC {clean['ctc']}")
    check(wer_abs <= ANCHOR_TOL["wer_abs"], f"cli anchor: clean WER {clean['wer']}")
    check(launches == want, f"cli anchor: launched {launches}, want {want}")
    out = {"anchor": launches, "anchor_run": {"run_dir": facts["run_dir"], "final_test_clean": clean,
                                              "final_test_perturbed": res["final_test_perturbed"],
                                              "audio_len": facts["audio_len"]},
           "anchor_frames":
           wav2vec2.get_config("wav2vec2-tiny").feat_extract_output_length(facts["audio_len"])}

    # (b) lv60 on ~20 s clips, random weights
    res, facts, launches = run_cli("lv60", LV60_CLI_ARGV)
    want = expected_cli_launches(LV60_CLI_ARGV, facts, fm=True, route="_sm90")
    values = (scores(res, "eval_score_clean") + scores(res, "eval_score_perturbed")
              + scores(res, "final_test_perturbed"))
    emit({"phase": "cli", "run": "lv60", **facts, "clip_s": facts["audio_len"] / 16000,
          "eval_score_clean": res["eval_score_clean"],
          "final_test_perturbed": res["final_test_perturbed"],
          "launches": launches, "want_launches": want, "card": card})
    check(res.get("finished_training") is True, "cli lv60: the run did not finish")
    check(facts["audio_len"] / 16000 > 15.5, f"cli lv60: clips of {facts['audio_len']} samples")
    check(all(math.isfinite(v) for v in values), f"cli lv60: non-finite scores {values}")
    check(launches == want, f"cli lv60: launched {launches}, want {want}")
    out["cli_lv60"] = launches
    out["cli_lv60_run"] = {k: res[k] for k in ("eval_score_clean", "final_test_clean")}

    # (c) --profile: the anchor on its --small_data corpus, without the
    # trace and with it; the trace must not change the run's numbers
    small = ANCHOR_ARGV + ["--small_data"]
    res, facts, launches = run_cli("anchor_small", small)
    res_p, facts_p, launches_p = run_cli("anchor_profile", small + ["--profile"])
    trace = os.path.join(facts_p["run_dir"], "profile", "trace.json")
    check(os.path.exists(trace), f"cli profile: no trace at {trace}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    trace_bytes = os.path.getsize(trace)
    shutil.rmtree(os.path.dirname(trace))  # checked; too large to bring back
    cpu_events = sum(e.get("cat") == "cpu_op" for e in events)
    p_plain, p_prof = (np.load(os.path.join(f["run_dir"], "perturbation.npy"))
                       for f in (facts, facts_p))
    p_diff = float(np.abs(p_prof - p_plain).max())
    p_close = bool(np.allclose(p_prof, p_plain, **ONE_CELL_TOL))
    want = expected_cli_launches(small, facts_p, fm=False, route="")
    emit({"phase": "cli", "run": "anchor_profile", **facts_p, "trace_bytes": trace_bytes,
          "trace_cpu_events": cpu_events,
          # not checked: torch.profiler on the card now and then sees no
          # device operation (PERF.md, open questions)
          "trace_device_events": sum(e.get("cat") == "kernel" for e in events),
          "final_test_clean": res_p["final_test_clean"],
          "unprofiled_final_test_clean": res["final_test_clean"],
          "perturbation_max_abs_diff": p_diff, "tolerance": ONE_CELL_TOL,
          "launches": launches_p, "unprofiled_launches": launches, "want_launches": want,
          "card": card})
    check(cpu_events > 0, "cli profile: the trace holds no CPU event")
    for key in ("eval_score_clean", "final_test_clean"):
        check(res_p[key] == res[key], f"cli profile: {key} {res_p[key]} against {res[key]}")
    check(p_close, f"cli profile: perturbation differs by {p_diff}")
    check(launches_p == launches == want, f"cli profile: launched {launches_p} and {launches}, "
                                          f"want {want}")
    return out


# ---------------------------------------------------------------------------
# phase 7: the sweep, python -m paa_tpu_torch.cli.sweep
# ---------------------------------------------------------------------------

# wav2vec2-base on 226 synthetic clips of 20-24 words: 160,955-sample (10.06
# s) clips, 128 train clips (2 batches of 64), 16 eval and 16 test clips
SWEEP_ARGV = ["--model", "wav2vec2-base", "--dataset", "synthetic",
              "--synthetic_samples", "226", "--synthetic_words", "20,24", "--batch_size", "64",
              "--optimizer_type", "pgd", "--norms", "fletcher_munson",
              "--grid", json.dumps({"fletcher_munson": [2.0, 4.0, 8.0]})]
SWEEP_FLAGS = ["--epochs_per_cell", "1", "--num_items_to_inspect", "0", "--no_resume"]
# the 1-cell sweep under the anchor's flags: run_attack's default norm
ANCHOR_SWEEP_ARGV = ANCHOR_ARGV + ["--norms", "max_phon", "--grid", json.dumps({"max_phon": [20.0]})]
JAX_SWEEP_RECORD = os.path.join(ROOT, "benchmarks", "quality_r5", "cells",
                                "adam_ab_sweep_results.json")
SWEEP_PEAK_TOL = 0.02  # relative to phase 4's peak
ONE_CELL_TOL = {"rtol": 2e-3, "atol": 1e-6}  # perturbation.npy against run_attack's


@functools.cache
def sweep_pipe():
    """The base sweep's corpus (phase 10's too), as its flags make it."""
    args = parser.create_arg_parser().parse_known_args(SWEEP_ARGV)[0]
    return parser.pipeline_from_args(args)


def sweep_audio_len() -> int:
    """The base sweep's clip length, from the corpus its flags make."""
    return sweep_pipe().audio_len


def run_sweep(name: str, argv: list[str]) -> tuple[dict, dict, dict, int]:
    """The sweep as ``python -m`` runs it, one epoch a cell: (its
    sweep_results.json, run facts, launch counts, peak device memory)."""
    torch.cuda.reset_peak_memory_stats()
    root, seconds, launches = run_module("paa_tpu_torch.cli.sweep", name, argv + SWEEP_FLAGS)
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(root, "sweep_results.json")) as f:
        summary = json.load(f)
    first = next(iter(summary.values()))["cells"][0]["dir"]
    facts = run_facts(name, os.path.join(root, "sweep.log"),
                      os.path.join(first, "metrics.jsonl"))
    return summary, {"root": root, "seconds": seconds, **facts}, launches, peak


def phase_sweep(card: str, main: dict, anchor: dict) -> dict:
    """Returns each sweep's launch counts."""
    with open(JAX_SWEEP_RECORD) as f:
        record = json.load(f)
    want_keys = {k for entry in record.values() for k in entry}
    want_cell_keys = {k for entry in record.values() for c in entry["cells"] for k in c}

    # (a) base at full width, three fletcher_munson cells
    summary, facts, launches, peak = run_sweep("sweep", SWEEP_ARGV)
    check(list(summary) == ["fletcher_munson"], f"sweep: norms {list(summary)}")
    entry = summary["fletcher_munson"]
    cells = entry["cells"]
    want = expected_cli_launches(SWEEP_ARGV, facts, fm=True, route="_sm90", cells=len(cells))
    cell_step_ms = [line["step_time_ms"] for line in facts.pop("metrics")]
    peak_rel = peak / main["peak"] - 1.0
    scores = ("final_ctc", "best_eval_pert_ctc", "test_clean_ctc", "test_clean_wer",
              "test_pert_ctc", "test_pert_wer")
    emit({"phase": "sweep", "run": "base", **facts, "clip_s": facts["audio_len"] / 16000,
          "cells": [{k: c[k] for k in ("size", "best_epoch") + scores} for c in cells],
          "cell_steps_per_sec": entry["cell_steps_per_sec"], "n_cell_steps": entry["n_cell_steps"],
          "programs_built": entry["programs_built"], "cell_step_ms": cell_step_ms,
          "main_step_ms": 1e3 * main["step_s"],
          "cell_step_over_main": cell_step_ms[0] / (1e3 * main["step_s"]),
          "peak_mem_bytes": peak, "main_peak_mem_bytes": main["peak"], "peak_rel": peak_rel,
          "tolerance": {"peak_rel": SWEEP_PEAK_TOL}, "launches": launches,
          "want_launches": want, "card": card})
    check(len(cells) == 3, f"sweep: {len(cells)} cells")
    for c in cells:
        with open(os.path.join(c["dir"], "results.json")) as f:
            check(json.load(f).get("finished_training") is True, f"sweep: cell {c['size']} unfinished")
        check(all(math.isfinite(c[k]) for k in scores), f"sweep: non-finite scores in {c}")
        check(set(c) == want_cell_keys, f"sweep: cell keys {sorted(c)}")
    check(set(entry) == want_keys, f"sweep: keys {sorted(entry)}")
    check(entry["n_cell_steps"] == len(cells) * facts["epochs"] * math.ceil(facts["train"] / 64),
          f"sweep: {entry['n_cell_steps']} cell steps")
    check(launches == want, f"sweep: launched {launches}, want {want}")
    check(abs(peak_rel) <= SWEEP_PEAK_TOL, f"sweep: peak {peak} against phase 4's {main['peak']}")
    # phase 2 held the kernels at this run's shapes: every batch is padded
    # to 64 rows of audio_len samples, K3 sees one cell's p
    check(facts["audio_len"] == sweep_audio_len(),
          f"sweep: clips of {facts['audio_len']} samples, phase 2 checked {sweep_audio_len()}")

    # (b) one cell under the anchor's flags against phase 6's run_attack run
    summary, facts, anchor_launches, _ = run_sweep("sweep_anchor", ANCHOR_SWEEP_ARGV)
    (cell,) = summary["max_phon"]["cells"]
    with open(os.path.join(cell["dir"], "results.json")) as f:
        clean = json.load(f)["final_test_clean"]
    p_sweep = np.load(os.path.join(cell["dir"], "perturbation.npy"))
    p_run = np.load(os.path.join(anchor["run_dir"], "perturbation.npy"))
    p_diff = float(np.abs(p_sweep - p_run).max())
    p_close = bool(np.allclose(p_sweep, p_run, **ONE_CELL_TOL))
    want = expected_cli_launches(ANCHOR_SWEEP_ARGV, facts, fm=False, route="")
    # the same clips as phase 6's anchor: the register-route check at the anchor's
    # frames covers this run's shapes too
    check(facts["audio_len"] == anchor["audio_len"],
          f"sweep anchor: clips of {facts['audio_len']} samples, the anchor's {anchor['audio_len']}")
    facts.pop("metrics")
    emit({"phase": "sweep", "run": "anchor_one_cell", **facts, "final_test_clean": clean,
          "run_attack_final_test_clean": anchor["final_test_clean"],
          "best_epoch": cell["best_epoch"], "perturbation_max_abs_diff": p_diff,
          "perturbation_within_tol": p_close, "tolerance": ONE_CELL_TOL,
          "launches": anchor_launches, "want_launches": want, "card": card})
    check(clean == anchor["final_test_clean"],
          f"sweep anchor: clean test {clean} against run_attack's {anchor['final_test_clean']}")
    check(p_close, f"sweep anchor: perturbation differs by {p_diff}")
    check(anchor_launches == want, f"sweep anchor: launched {anchor_launches}, want {want}")
    return {"sweep": launches, "sweep_anchor": anchor_launches}


# ---------------------------------------------------------------------------
# phase 8: victim pretraining, python -m paa_tpu_torch.train.pretrain
# ---------------------------------------------------------------------------

# (a) base at full width: 512 synthetic clips of 3-8 words, B=32, 4 steps
PRETRAIN_BASE_ARGV = ["--model", "wav2vec2-base", "--batch_size", "32",
                      "--synthetic_samples", "512", "--steps", "4", "--warmup_steps", "2",
                      "--eval_every", "4"]
# (b) the committed checkpoint's recipe (its .history.json), cut at 1000 steps
PRETRAIN_TINY_ARGV = ["--model", "wav2vec2-tiny", "--lr", "1e-3", "--batch_size", "32",
                      "--warmup_steps", "300", "--synthetic_samples", "2048",
                      "--eval_every", "200", "--target_wer", "0.05", "--steps", "1000"]
TINY_RECORD = os.path.join(ROOT, "checkpoints", "wav2vec2-tiny-synthetic.history.json")


@functools.cache
def pretrain_corpus(argv: tuple[str, ...]):
    """(config, corpus) of a pretraining run's flags."""
    cfg = pretrain.config_from_args(pretrain.create_arg_parser().parse_args(list(argv)))
    return cfg, pretrain.build_corpus(cfg)


def pretrain_frames(argv: list[str]) -> int:
    """T_pre: the frames of the corpus the flags make."""
    cfg, pipe = pretrain_corpus(tuple(argv))
    return wav2vec2.get_config(cfg.model).feat_extract_output_length(pipe.audio_len)


def pretrain_launches(cfg, pipe, history: dict, route: str) -> dict:
    """What a pretraining run launches: every layer forward and backward per
    step, forward per batch of each eval pass and of the final test pass;
    the positional conv once a forward and once a backward, through K5 under
    the bf16 compute dtype (base; the tiny recipe runs float32); every
    LayerNorm through K7 once a forward and once a backward."""
    mcfg = wav2vec2.get_config(cfg.model)
    L, pc, ln = mcfg.num_hidden_layers, int(mcfg.compute_dtype == "bfloat16"), ln_layers(mcfg)
    nb = lambda split: math.ceil(len(split) / cfg.batch_size)
    steps = history["eval_step"][-1]  # the run ends at an eval
    evals = len(history["eval_step"]) * nb(pipe.eval) + nb(pipe.test)
    return counts(**{f"attention_fwd{route}": L * (steps + evals),
                     f"attention_bwd{route}": L * steps,
                     "pos_conv": pc * (steps + evals), "pos_conv_dgrad": pc * steps,
                     "layer_norm": ln * (steps + evals), "layer_norm_bwd": ln * steps})


def run_pretrain(name: str, argv: list[str]) -> tuple[dict, dict, float, str]:
    """The entry point as ``python -m`` runs it: (its .history.json, launch
    counts, seconds, checkpoint path)."""
    root, seconds, launches = run_module("paa_tpu_torch.train.pretrain", name, argv,
                                         out="model.safetensors")
    with open(os.path.join(root, "model.history.json")) as f:
        record = json.load(f)
    return record, launches, seconds, os.path.join(root, "model.safetensors")


def fresh_model(model_name: str, state: dict, dev) -> wav2vec2.Wav2Vec2ForCTC:
    model = wav2vec2.Wav2Vec2ForCTC(wav2vec2.get_config(model_name))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model.to(dev)


def phase_pretrain(dev, card: str) -> dict:
    """Returns each pretraining run's launch counts."""
    with open(TINY_RECORD) as f:
        jax_record = json.load(f)
    history_keys = set(jax_record["history"])

    # (a) base at full width through the entry point
    cfg, pipe = pretrain_corpus(tuple(PRETRAIN_BASE_ARGV))
    frames = pretrain_frames(PRETRAIN_BASE_ARGV)
    record, launches, seconds, ckpt = run_pretrain("pretrain_base", PRETRAIN_BASE_ARGV)
    initial = wav2vec2.init_model(wav2vec2.get_config(cfg.model), seed=cfg.seed).state_dict()
    exported = checkpoint_io.load_safetensors(ckpt)
    check({k: v.shape for k, v in exported.items()} == {k: tuple(v.shape)
                                                         for k, v in initial.items()},
          f"pretrain base: the export holds {sorted(exported)}")
    os.remove(ckpt)  # 380 MB: too large to bring back; (a2) checks an export's logits
    del exported
    history = record["history"]
    want = pretrain_launches(cfg, pipe, history, "_sm90")
    check(set(history) == history_keys, f"pretrain base: history keys {sorted(history)}")
    check(launches == want, f"pretrain base: launched {launches}, want {want}")
    check(all(math.isfinite(v) for v in history["loss"] + history["eval_ctc"]),
          f"pretrain base: non-finite loss in {history}")

    # (a2) the same run through pretrain(), watched step by step
    seen: dict = {"losses": []}

    def clock(step_idx):
        torch.cuda.synchronize()
        seen[step_idx] = time.perf_counter()

    def watch(step_idx, model, loss):
        # steps 2-4 are timed; the weight comparisons stay outside the clock
        seen["losses"].append(loss)
        if step_idx == 4:
            clock(4)
        if step_idx in (1, 4):
            now = model.state_dict()
            seen[f"equal_{step_idx}"] = all(torch.equal(now[k].cpu(), v) for k, v in initial.items())
        if step_idx == 1:
            clock(1)

    torch.cuda.reset_peak_memory_stats(dev)
    _lib.reset_launches()
    best, lib_history = pretrain.pretrain(cfg, pipe=pipe, device=dev, on_step=watch)
    lib_launches = dict(_lib.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(v) for v in seen["losses"]]
    step_s = (seen[4] - seen[1]) / 3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.safetensors")
        pretrain.export_checkpoint(best, path)
        exported = checkpoint_io.load_safetensors(path)
    batch = next(pipe.eval.batches(cfg.batch_size))
    logits = [pretrain.make_logits_fn(fresh_model(cfg.model, sd, dev))(batch.audio)
              for sd in (best, exported)]
    logits_equal = bool(torch.equal(*logits))
    mcfg = wav2vec2.get_config(cfg.model)
    emit({"phase": "pretrain", "run": "base", "model": cfg.model,
          "layers": mcfg.num_hidden_layers, "hidden": mcfg.hidden_size,
          "heads": mcfg.num_attention_heads, "compute_dtype": mcfg.compute_dtype,
          "param_dtype": "float32", "batch": cfg.batch_size, "audio_len": pipe.audio_len, "T_pre": frames,
          "train": len(pipe.train), "eval": len(pipe.eval), "test": len(pipe.test),
          "steps": cfg.steps, "warmup_steps": cfg.warmup_steps, "cli_seconds": seconds,
          "cli_history": history, "cli_launches": launches, "want_launches": want,
          "losses": losses, "step_s": step_s, "timed_steps": "2-4",
          "peak_mem_bytes": peak, "peak_mem_gib": peak / 2**30,
          "params_equal_after_step_1": seen["equal_1"],
          "params_equal_after_step_4": seen["equal_4"],
          "export_logits_equal": logits_equal, "launches": lib_launches, "card": card})
    check(all(math.isfinite(v) for v in losses) and len(losses) == cfg.steps,
          f"pretrain base: losses {losses}")
    check(losses[0] == history["loss"][0], f"pretrain base: step 1 loss {losses[0]} against "
                                           f"the entry point's {history['loss'][0]}")
    check(seen["equal_1"], "pretrain base: step 1 (lr 0) changed the weights")
    check(not seen["equal_4"], "pretrain base: 4 steps left the weights unchanged")
    check(lib_launches == pretrain_launches(cfg, pipe, lib_history, "_sm90"),
          f"pretrain base: pretrain() launched {lib_launches}")
    check(logits_equal, "pretrain base: the exported weights give other logits")
    del best, logits
    torch.cuda.empty_cache()

    # (b) tiny, the committed checkpoint's recipe
    cfg, pipe = pretrain_corpus(tuple(PRETRAIN_TINY_ARGV))
    record, tiny_launches, seconds, ckpt = run_pretrain("pretrain_tiny", PRETRAIN_TINY_ARGV)
    history = record["history"]
    want = pretrain_launches(cfg, pipe, history, "")  # float32: the register route
    model = fresh_model(cfg.model, checkpoint_io.load_safetensors(ckpt), dev)
    reload_wer, _ = pretrain.evaluate_wer(pretrain.make_logits_fn(model), pipe.test,
                                          cfg.batch_size)
    best_at = history["eval_step"][history["eval_wer"].index(history["best_eval_wer"])]
    jax_history = jax_record["history"]
    emit({"phase": "pretrain", "run": "tiny_recipe", "config": record["config"],
          "T_pre": pretrain_frames(PRETRAIN_TINY_ARGV), "seconds": seconds,
          "wall_sec": history["wall_sec"], "steps_run": history["eval_step"][-1],
          "loss_first": history["loss"][0], "loss_last": history["loss"][-1],
          "eval_wer": history["eval_wer"], "best_eval_wer": history["best_eval_wer"],
          "best_at_step": best_at, "test_wer": history["test_wer"],
          "reloaded_test_wer": reload_wer,
          "jax_record": {"best_eval_wer": jax_history["best_eval_wer"],
                         "best_at_step": jax_history["eval_step"][-1],
                         "test_wer": jax_history["test_wer"],
                         "wall_sec": jax_history["wall_sec"]},
          "launches": tiny_launches, "want_launches": want, "card": card})
    check(set(history) == history_keys, f"pretrain tiny: history keys {sorted(history)}")
    check(history["loss"][-1] < 0.5 * history["loss"][0], f"pretrain tiny: {history['loss']}")
    check(history["best_eval_wer"] < 1.0, f"pretrain tiny: best eval WER {history}")
    check(reload_wer == history["test_wer"],
          f"pretrain tiny: reloaded test WER {reload_wer} against {history['test_wer']}")
    check(tiny_launches == want, f"pretrain tiny: launched {tiny_launches}, want {want}")

    # (c) the committed checkpoint through the port's evaluate_wer, on its
    # own corpus: (b)'s flags make it (seed 5, 2048 clips, B=32)
    check(all(record["config"][k] == jax_record["config"][k]
              for k in ("model", "seed", "synthetic_samples", "batch_size")),
          "pretrain: (b) and the committed checkpoint's corpus differ")
    model = fresh_model(cfg.model, checkpoint_io.load_safetensors(TINY_CKPT), dev)
    wer, ctc = pretrain.evaluate_wer(pretrain.make_logits_fn(model), pipe.eval, cfg.batch_size)
    emit({"phase": "pretrain", "run": "committed_checkpoint", "eval_wer": wer, "eval_ctc": ctc,
          "recorded_eval_wer": jax_history["best_eval_wer"],
          "recorded_eval_ctc": jax_history["eval_ctc"][-1], "card": card})
    check(wer == jax_history["best_eval_wer"],
          f"pretrain: committed checkpoint eval WER {wer}, recorded {jax_history['best_eval_wer']}")
    return {"pretrain_base": launches, "pretrain_tiny": tiny_launches}


# ---------------------------------------------------------------------------
# phase 9: data and tensor parallelism, 2 ranks under torchrun
# ---------------------------------------------------------------------------

# The machine has one card: the 2 ranks share it, so the process group is
# gloo (parallel/mesh.py's backend rule) and every collective is staged
# through the host. Its times are of two processes sharing one card over
# gloo, not scaling numbers.
PAR_RANKS = 2
PAR_TIMEOUT_S = 300  # each torchrun launch, and the ranks' process group
PAR_DP_B, PAR_TP_B = 64, 16  # (a) 32 rows a rank; (b) gloo's host-staged reduces kept small
# A sharded bf16 step against the one-device step on this card: the split
# batch and the split heads round at other places (other cuBLAS tiles for
# half the rows or heads; tp's partial sums rounded to bf16, reduced in
# float32 and rounded again), and the loss and ∂loss/∂p sum in another
# order. Measured on the H100 (PERF.md, PR 9): loss 8.0e-5 (dp) and 4.3e-4
# (tp) relative, ∂loss/∂p 6.2e-3 and 9.0e-3 of its largest value, PGD signs
# 99.87 % and 99.73 % equal; the tolerances leave 3-5× of that.
PAR_TOL = {"loss_rel": 2e-3, "grad_rel": 3e-2, "sign_agreement_min": 0.99}


def run_ranks(kind: str, out_dir: str, extra: list[str]) -> tuple[list[dict], float]:
    """``torchrun --standalone --nproc_per_node 2 chip_smoke.py --worker
    kind out_dir extra``: (each rank's record, seconds). The launch and its
    ranks run in their own process group, killed at PAR_TIMEOUT_S."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(PAR_RANKS), os.path.join(ROOT, "chip_smoke.py"),
           "--worker", kind, out_dir, *extra]
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, "torchrun.log"), "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            code = proc.wait(timeout=PAR_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            code = "timeout"
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "torchrun.log")) as f:
        tail = f.read()[-4000:]
    check(code == 0, f"parallel {kind}: torchrun exited {code}:\n{tail}")
    records = []
    for r in range(PAR_RANKS):
        with open(os.path.join(out_dir, f"{kind}_rank{r}.json")) as f:
            records.append(json.load(f))
    return records, seconds


def worker(kind: str, out_dir: str, extra: list[str]) -> int:
    """One rank of ``run_ranks``: ``steps`` runs (a) and (b); ``cli`` runs
    ``python -m extra[1] extra[2:]`` (after ``--``) in this process. Writes
    its record, with its launch counts (and for ``cli`` a hash of the p each
    ``run_attack`` returned), to ``<out_dir>/<kind>_rank<r>.json``."""
    rank = int(os.environ["RANK"])
    if kind == "steps":
        record = worker_steps(out_dir, rank)
    else:
        from paa_tpu_torch.train import loop

        module, argv = extra[1], extra[2:]
        results, run_attack = [], loop.run_attack
        loop.run_attack = lambda *a, **kw: results.append(run_attack(*a, **kw)) or results[-1]
        _lib.reset_launches()
        saved = sys.argv
        sys.argv = [module, *argv]
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
            code = 0
        except SystemExit as e:
            code = e.code
        finally:
            sys.argv = saved
            loop.run_attack = run_attack
        # the best p each rank's run_attack returned (none for the sweep)
        record = {"code": code, "launches": dict(_lib.launches),
                  "perturbation_sha256": [hashlib.sha256(r.perturbation.tobytes()).hexdigest()
                                          for r in results]}
    record["jax_modules"] = sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "flax", "optax", "paa_tpu"))
    with open(os.path.join(out_dir, f"{kind}_rank{rank}.json"), "w") as f:
        json.dump(record, f)
    return 0 if record.get("code", 0) == 0 else 1


def par_model(dev):
    """Phase 4's model: base at full width from SEED, bf16 storage."""
    mcfg = wav2vec2.get_config("wav2vec2-base")
    return wav2vec2.init_model(mcfg, seed=SEED).cast_param_storage(torch.bfloat16).to(dev)


PAR_CFG = AttackConfig(norm_type="fletcher_munson", optimizer_type="pgd", lr=1e-4,
                       model_name="wav2vec2-base")


def worker_steps(out_dir: str, rank: int) -> dict:
    """(a) dp=2 at B=64 and (b) tp=2 at B=16: ∂loss/∂p at p = 0, then two
    sharded PGD steps from p = 0, the second timed; launches counted from
    the first call; p and the gradient saved for the parent."""
    import torch.distributed as dist

    dev = runtime.require_cuda()
    mesh_lib.init_process_group(dev, timeout_s=PAR_TIMEOUT_S)
    full = par_model(dev)
    tables = psycho.build_tables(PAR_CFG, dev)
    cparams = ConstraintParams.create(device=dev)
    record = {"backend": dist.get_backend(), "device": str(dev)}
    for name, tp_size, B in (("dp", 1, PAR_DP_B), ("tp", PAR_RANKS, PAR_TP_B)):
        batch = full_width_batch(B, MAIN_T, dev)
        mesh = mesh_lib.decide_mesh(tp_size, B)
        model = tp_lib.shard_model(full, mesh)
        train = step.make_sharded_step(PAR_CFG, model, tables, mesh)
        p0 = torch.zeros((1, MAIN_T), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _lib.reset_launches()
        loss, _, grad = step._grad_fn(model, PAR_CFG, mesh)(p0, *batch)
        p1, _, m = train(p0, None, *batch, cparams, PAR_CFG.lr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train(p0, None, *batch, cparams, PAR_CFG.lr)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        torch.save({"grad": grad.cpu(), "p": p1.cpu()},
                   os.path.join(out_dir, f"{name}_rank{rank}.pt"))
        record[name] = {"mesh": mesh.shape, "coords": mesh.coords, "loss": float(loss),
                        "step_loss": float(m.ctc_loss), "step_s": step_s,
                        "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                        "launches": dict(_lib.launches),
                        "heads": model.wav2vec2.encoder.layers[0].attention.heads}
        del model, train, batch, grad, p1
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return record


def one_device_reference(dev, B: int) -> dict:
    """The one-device step on this card at B rows: ∂loss/∂p at p = 0 and
    the p of one PGD step from p = 0."""
    model = par_model(dev)
    batch = full_width_batch(B, MAIN_T, dev)
    p0 = torch.zeros((1, MAIN_T), device=dev)
    loss, _, grad = step._grad_and_metrics(model, PAR_CFG, p0, *batch)
    train = step.make_train_step(PAR_CFG, model, psycho.build_tables(PAR_CFG, dev))
    p1, _, m = train(p0, None, *batch, ConstraintParams.create(device=dev), PAR_CFG.lr)
    out = {"loss": float(loss), "step_loss": float(m.ctc_loss), "grad": grad.cpu(),
           "p": p1.cpu()}
    del model, batch, grad, p1
    torch.cuda.empty_cache()
    return out


def phase_parallel(dev, card: str, anchor: dict) -> dict:
    """Returns the launch counts of its runs, summed over the ranks."""
    t_phase = time.perf_counter()
    root = os.path.join(RUNS_DIR, "parallel")
    shutil.rmtree(root, ignore_errors=True)
    L = wav2vec2.get_config("wav2vec2-base").num_hidden_layers
    out = {}

    # (a) dp=2 and (b) tp=2 at full width against the one-device step
    refs = {"dp": one_device_reference(dev, PAR_DP_B), "tp": one_device_reference(dev, PAR_TP_B)}
    records, seconds = run_ranks("steps", root, [])
    # per rank: ∂loss/∂p and two steps, each every layer forward and
    # backward (bf16, head dim 64: the wgmma route), each step one K3; every
    # rank runs the whole positional conv, K5 once each way a pass, and every
    # LayerNorm over whole rows, K7 once each way a pass
    ln = ln_layers(wav2vec2.get_config("wav2vec2-base"))
    want = counts(attention_fwd_sm90=3 * L, attention_bwd_sm90=3 * L, fm_norm=2, pos_conv=3,
                  pos_conv_dgrad=3, layer_norm=3 * ln, layer_norm_bwd=3 * ln)
    for name, B in (("dp", PAR_DP_B), ("tp", PAR_TP_B)):
        ref = refs[name]
        saved = [torch.load(os.path.join(root, f"{name}_rank{r}.pt"), weights_only=True)
                 for r in range(PAR_RANKS)]
        g, g1 = saved[0]["grad"], ref["grad"]
        loss = records[0][name]["loss"]
        result = {
            "loss": loss, "one_device_loss": ref["loss"],
            "loss_rel_err": abs(loss - ref["loss"]) / abs(ref["loss"]),
            "grad_max_rel_err": float((g - g1).abs().max() / g1.abs().max()),
            "pgd_sign_agreement": float((torch.sign(g) == torch.sign(g1)).float().mean()),
            "p_max_abs_diff": float((saved[0]["p"] - ref["p"]).abs().max()),
            "p_bit_equal_across_ranks": all(torch.equal(s["p"], saved[0]["p"]) for s in saved),
            "grad_bit_equal_across_ranks": all(torch.equal(s["grad"], g) for s in saved),
        }
        ranks = [records[r][name] for r in range(PAR_RANKS)]
        emit({"phase": "parallel", "run": name, "model": "wav2vec2-base", "batch": B,
              "samples": MAIN_T, "ranks": PAR_RANKS, "mesh": ranks[0]["mesh"],
              "coords": [x["coords"] for x in ranks],
              "heads_per_rank": ranks[0]["heads"], "backend": records[0]["backend"],
              **result, "step_s": [x["step_s"] for x in ranks],
              "peak_mem_bytes": [x["peak_mem_bytes"] for x in ranks],
              "launches": [x["launches"] for x in ranks], "want_launches_per_rank": want,
              "tolerance": PAR_TOL, "launch_seconds": seconds, "card": card,
              "timing": "two processes sharing one card over gloo; not a scaling number"})
        check(records[0]["backend"] == "gloo", f"parallel: backend {records[0]['backend']}")
        check(result["loss_rel_err"] <= PAR_TOL["loss_rel"], f"parallel {name}: loss {result}")
        check(result["grad_max_rel_err"] <= PAR_TOL["grad_rel"], f"parallel {name}: grad {result}")
        check(result["pgd_sign_agreement"] >= PAR_TOL["sign_agreement_min"],
              f"parallel {name}: signs {result}")
        check(result["p_bit_equal_across_ranks"], f"parallel {name}: p differs between ranks")
        check(all(x["launches"] == want for x in ranks),
              f"parallel {name}: launched {[x['launches'] for x in ranks]}, want {want} a rank")
        check(ranks[0]["heads"] == (12 if name == "dp" else 12 // PAR_RANKS),
              f"parallel {name}: {ranks[0]['heads']} heads a rank")
        out[f"par_{name}"] = {k: sum(x["launches"][k] for x in ranks) for k in want}

    # (c) the CLI anchor, dp=2 and --tp 2, against phase 6's run
    for name, extra in (("cli_dp", []), ("cli_tp", ["--tp", str(PAR_RANKS)])):
        save_root = os.path.join(RUNS_DIR, name)
        shutil.rmtree(save_root, ignore_errors=True)
        argv = ANCHOR_ARGV + extra + ["--num_epochs", "1", "--num_items_to_inspect", "0",
                                      "--no_resume", "--save_root", save_root]
        records, seconds = run_ranks("cli", os.path.join(root, name),
                                     ["--", "paa_tpu_torch.cli.run_attack", *argv])
        run_dir = [d for d, _, files in os.walk(save_root) if "results.json" in files][0]
        with open(os.path.join(run_dir, "results.json")) as f:
            res = json.load(f)
        facts = run_facts(name, os.path.join(run_dir, "train.log"),
                          os.path.join(run_dir, "metrics.jsonl"))
        del facts["metrics"]
        want = expected_cli_launches(ANCHOR_ARGV, facts, fm=False, route="")
        clean = res["final_test_clean"]
        emit({"phase": "parallel", "run": name, "ranks": PAR_RANKS, **facts,
              "clean_tolerance": "equal" if name == "cli_dp" else ANCHOR_TOL,
              "final_test_clean": clean, "anchor_final_test_clean": anchor["final_test_clean"],
              "final_test_perturbed": res["final_test_perturbed"],
              "anchor_final_test_perturbed": anchor["final_test_perturbed"],
              "launches": [r["launches"] for r in records], "want_launches_per_rank": want,
              "launch_seconds": seconds, "card": card})
        check(res.get("finished_training") is True, f"parallel {name}: the run did not finish")
        if name == "cli_dp":  # each row's bf16 forward is the one-device row's
            check(clean == anchor["final_test_clean"],
                  f"parallel {name}: clean test {clean} against phase 6's "
                  f"{anchor['final_test_clean']}")
        else:  # the split heads' bf16 partial sums round apart: phase 6's tolerance
            ref = anchor["final_test_clean"]
            check(abs(clean["ctc"] - ref["ctc"]) / ref["ctc"] <= ANCHOR_TOL["ctc_rel"]
                  and abs(clean["wer"] - ref["wer"]) <= ANCHOR_TOL["wer_abs"],
                  f"parallel {name}: clean test {clean} against phase 6's {ref}, "
                  f"tolerance {ANCHOR_TOL}")
        check(all(r["launches"] == want for r in records),
              f"parallel {name}: launched {[r['launches'] for r in records]}, want {want} a rank")
        check(all(r["jax_modules"] == [] for r in records), f"parallel {name}: JAX imported")
        out[name] = {k: sum(r["launches"][k] for r in records) for k in want}

    # (d) a 2-cell sweep, one cell a rank, against the same sweep in one process
    argv = ANCHOR_ARGV + ["--norms", "max_phon", "--grid", json.dumps({"max_phon": [20.0, 30.0]})]
    one, _, _, _ = run_sweep("sweep_two_cells", argv)
    save_root = os.path.join(RUNS_DIR, "sweep_two_ranks")
    shutil.rmtree(save_root, ignore_errors=True)
    records, seconds = run_ranks("cli", os.path.join(root, "sweep"),
                                 ["--", "paa_tpu_torch.cli.sweep", *argv, *SWEEP_FLAGS,
                                  "--save_root", save_root])
    with open(os.path.join(save_root, "sweep_results.json")) as f:
        two = json.load(f)["max_phon"]
    first = two["cells"][0]["dir"]
    facts = run_facts("sweep_two_ranks", os.path.join(save_root, "sweep.log"),
                      os.path.join(first, "metrics.jsonl"))
    del facts["metrics"]
    want = expected_cli_launches(argv, facts, fm=False, route="", cells=1)  # one cell a rank
    keys = ("size", "best_epoch", "test_clean_ctc", "test_clean_wer", "test_pert_ctc",
            "test_pert_wer", "final_ctc")
    cells = []
    for got, ref in zip(two["cells"], one["max_phon"]["cells"]):
        p_got, p_ref = (np.load(os.path.join(c["dir"], "perturbation.npy")) for c in (got, ref))
        cells.append({"two_ranks": {k: got[k] for k in keys}, "one_process": {k: ref[k] for k in keys},
                      "perturbation_max_abs_diff": float(np.abs(p_got - p_ref).max()),
                      "perturbation_within_tol": bool(np.allclose(p_got, p_ref, **ONE_CELL_TOL))})
    emit({"phase": "parallel", "run": "sweep", "ranks": PAR_RANKS, "mesh": two["mesh"],
          "cells": cells, "tolerance": ONE_CELL_TOL, "launches": [r["launches"] for r in records],
          "want_launches_per_rank": want, "launch_seconds": seconds, "card": card})
    check(two["mesh"] == "(sweep=2, data=1)", f"parallel sweep: mesh {two['mesh']}")
    for c in cells:
        check(c["two_ranks"]["test_clean_ctc"] == c["one_process"]["test_clean_ctc"]
              and c["two_ranks"]["test_clean_wer"] == c["one_process"]["test_clean_wer"],
              f"parallel sweep: clean scores {c}")
        check(c["perturbation_within_tol"], f"parallel sweep: perturbation {c}")
    check(all(r["launches"] == want for r in records),
          f"parallel sweep: launched {[r['launches'] for r in records]}, want {want} a rank")
    out["sweep_two_ranks"] = {k: sum(r["launches"][k] for r in records) for k in want}
    emit({"phase": "parallel", "wall_s": time.perf_counter() - t_phase, "card": card})
    return out


# ---------------------------------------------------------------------------
# phase 10: the feeds, host and device
# ---------------------------------------------------------------------------

# run_attack at base's full width on phase 7's corpus: 2 train batches of 64,
# eval and test batches of 16 valid rows and 48 padding rows each
FEED_ARGV = ["--model", "wav2vec2-base", "--dataset", "synthetic", "--synthetic_samples", "226",
             "--synthetic_words", "20,24", "--batch_size", "64", "--optimizer_type", "pgd",
             "--norm_type", "fletcher_munson"]
FEED_EPOCHS = 5  # timed epochs of the train split a feed, after one untimed
STAGED_LINE = "staged split to device"  # the device feed's log line (pipeline.CorpusCache)


def feeds(split, dev) -> dict:
    """name → (batches(shuffle_rng) → iterator, bytes staged): the host feed,
    the whole split staged, and half of it staged."""
    corpus = pipeline.DeviceCorpus(split, dev)
    cached = pipeline.CachedCorpus(split, (len(split) // 2) * pipeline.row_bytes(split), dev)
    return {"host": (lambda rng: pipeline.prefetch_to_device(split.batches(MAIN_B, rng), dev), 0),
            "device": (lambda rng: corpus.batches(MAIN_B, rng), corpus.staged_bytes),
            "cached": (lambda rng: cached.batches(MAIN_B, rng), cached.staged_bytes)}


def time_feed(batches) -> dict:
    """ms a batch over FEED_EPOCHS shuffled epochs (host clock, ending in a
    synchronize), and the bytes each batch copies to the card."""
    for _ in batches(np.random.default_rng((SEED, 0))):
        pass
    torch.cuda.synchronize()
    pipeline.reset_h2d()
    n = 0
    t0 = time.perf_counter()
    for epoch in range(1, FEED_EPOCHS + 1):
        for _ in batches(np.random.default_rng((SEED, epoch))):
            n += 1
    torch.cuda.synchronize()
    return {"ms_per_batch": 1e3 * (time.perf_counter() - t0) / n,
            "h2d_bytes_per_batch": pipeline.h2d["bytes"] / n,
            "h2d_copies_per_batch": pipeline.h2d["copies"] / n, "batches": n}


def check_feed_batches(name: str, split, made: dict) -> int:
    """Every batch of the three feeds over ``split`` (shuffled as epoch 0):
    valid rows bit-equal across them; padding rows weigh 0 and carry the
    split's row 0 in both corpora, zero audio (and no label) in the host
    feed. Returns the padding rows seen."""
    row0 = split.collate([0], 1)
    host_pad = {"audio": 0.0, "labels": text.PAD_ID, "label_paddings": 1.0}
    pads = 0
    streams = {k: v[0](np.random.default_rng((SEED, 0))) for k, v in made.items()}
    for batches in zip(*streams.values()):
        got = dict(zip(streams, batches))
        valid = torch.from_numpy(pipeline.host_mask(got["host"]))
        pads += int((~valid).sum())
        for feed, b in got.items():
            check(np.array_equal(b.indices, got["host"].indices), f"feed {name}: {feed} rows")
            for field in ("audio", "labels", "label_paddings", "weights"):
                x, h = getattr(b, field).cpu(), getattr(got["host"], field).cpu()
                check(torch.equal(x[valid], h[valid]), f"feed {name}: {feed} {field} differs")
                pad = x[~valid]
                if field == "weights":
                    want = torch.zeros_like(pad)
                elif feed == "host":
                    want = torch.full_like(pad, host_pad[field])
                else:
                    want = torch.from_numpy(getattr(row0, field)).expand_as(pad)
                check(torch.equal(pad, want), f"feed {name}: {feed}'s padding {field}")
    return pads


def phase_feed(dev, card: str, main: dict, anchor: dict) -> dict:
    """Returns the launch counts of its runs (summed over the ranks for
    (c))."""
    t_phase = time.perf_counter()
    pipe = sweep_pipe()
    # (a) the feeds alone, on the train split; their batches on every split
    made = feeds(pipe.train, dev)
    timed = {name: {**time_feed(batches), "staged_bytes": staged}
             for name, (batches, staged) in made.items()}
    pads = {name: check_feed_batches(name, split, made if name == "train" else feeds(split, dev))
            for name, split in (("train", pipe.train), ("eval", pipe.eval), ("test", pipe.test))}
    del made
    torch.cuda.empty_cache()
    emit({"phase": "feed", "run": "feeds", "batch": MAIN_B, "audio_len": pipe.audio_len,
          "splits": {"train": len(pipe.train), "eval": len(pipe.eval), "test": len(pipe.test)},
          "feeds": timed, "padding_rows_checked": pads, "timed_epochs": FEED_EPOCHS,
          "cached_rows": len(pipe.train) // 2, "card": card})
    check(pads["eval"] > 0 and pads["test"] > 0, f"feed: no padding rows checked {pads}")
    check(timed["device"]["h2d_bytes_per_batch"] == MAIN_B * 4,
          f"feed: the device corpus copied {timed['device']['h2d_bytes_per_batch']} bytes a batch")

    # (b) run_attack on each feed
    out, runs = {}, {}
    for feed, flag in (("host", "--no_device_cache"), ("device", "--device_cache")):
        torch.cuda.reset_peak_memory_stats()
        res, facts, launches = run_cli(f"feed_{feed}", FEED_ARGV + [flag])
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(facts["run_dir"], "metrics.jsonl")) as f:
            step_ms = [json.loads(line)["step_time_ms"] for line in f]
        with open(os.path.join(facts["run_dir"], "train.log")) as f:
            staged = STAGED_LINE in f.read()
        want = expected_cli_launches(FEED_ARGV, facts, fm=True, route="_sm90")
        emit({"phase": "feed", "run": f"run_attack_{feed}", **facts, "flag": flag,
              "staged": staged, "step_time_ms": step_ms, "main_step_ms": 1e3 * main["step_s"],
              "step_over_main": step_ms[0] / (1e3 * main["step_s"]),
              "final_test_clean": res["final_test_clean"],
              "final_test_perturbed": res["final_test_perturbed"],
              "peak_mem_bytes": peak, "main_peak_mem_bytes": main["peak"],
              "launches": launches, "want_launches": want, "card": card})
        check(res.get("finished_training") is True, f"feed {feed}: the run did not finish")
        check(staged == (feed == "device"), f"feed {feed}: staged={staged}")
        check(facts["audio_len"] == sweep_audio_len(),
              f"feed {feed}: clips of {facts['audio_len']} samples, phase 2 checked "
              f"{sweep_audio_len()}")
        check(launches == want, f"feed {feed}: launched {launches}, want {want}")
        runs[feed], out[f"feed_{feed}"] = res, launches
    host, device = runs["host"], runs["device"]
    check(device["final_test_clean"] == host["final_test_clean"],
          f"feed: clean test {device['final_test_clean']} against {host['final_test_clean']}")
    g, w = device["final_test_perturbed"], host["final_test_perturbed"]
    check(abs(g["ctc"] - w["ctc"]) / w["ctc"] <= ANCHOR_TOL["ctc_rel"]
          and abs(g["wer"] - w["wer"]) <= ANCHOR_TOL["wer_abs"],
          f"feed: perturbed test {g} against {w}, tolerance {ANCHOR_TOL}")

    # (c) the anchor with dp=2 on the device feed, as phase 9 (c) runs it
    save_root = os.path.join(RUNS_DIR, "cli_dp_device")
    shutil.rmtree(save_root, ignore_errors=True)
    argv = ANCHOR_ARGV + ["--device_cache", "--num_epochs", "1", "--num_items_to_inspect", "0",
                          "--no_resume", "--save_root", save_root]
    records, seconds = run_ranks("cli", os.path.join(RUNS_DIR, "parallel_feed"),
                                 ["--", "paa_tpu_torch.cli.run_attack", *argv])
    run_dir = [d for d, _, files in os.walk(save_root) if "results.json" in files][0]
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    with open(os.path.join(run_dir, "train.log")) as f:
        staged = STAGED_LINE in f.read()
    facts = run_facts("cli_dp_device", os.path.join(run_dir, "train.log"),
                      os.path.join(run_dir, "metrics.jsonl"))
    del facts["metrics"]
    want = expected_cli_launches(ANCHOR_ARGV, facts, fm=False, route="")
    hashes = [r["perturbation_sha256"] for r in records]
    emit({"phase": "feed", "run": "cli_dp_device", "ranks": PAR_RANKS, **facts,
          "staged": staged, "final_test_clean": res["final_test_clean"],
          "anchor_final_test_clean": anchor["final_test_clean"],
          "final_test_perturbed": res["final_test_perturbed"],
          "p_bit_equal_across_ranks": all(h == hashes[0] for h in hashes) and bool(hashes[0]),
          "launches": [r["launches"] for r in records], "want_launches_per_rank": want,
          "launch_seconds": seconds, "card": card})
    check(res.get("finished_training") is True, "feed cli_dp_device: the run did not finish")
    check(staged, "feed cli_dp_device: the split was not staged")
    check(res["final_test_clean"] == anchor["final_test_clean"],
          f"feed cli_dp_device: clean test {res['final_test_clean']} against phase 6's "
          f"{anchor['final_test_clean']}")
    check(len(hashes[0]) == 1 and all(h == hashes[0] for h in hashes),
          f"feed cli_dp_device: p differs between the ranks {hashes}")
    check(all(r["launches"] == want for r in records),
          f"feed cli_dp_device: launched {[r['launches'] for r in records]}, want {want} a rank")
    check(all(r["jax_modules"] == [] for r in records), "feed cli_dp_device: JAX imported")
    out["cli_dp_device"] = {k: sum(r["launches"][k] for r in records) for k in want}
    emit({"phase": "feed", "wall_s": time.perf_counter() - t_phase, "card": card})
    return out


# ---------------------------------------------------------------------------
# phase 11: remat at lv60
# ---------------------------------------------------------------------------

# (a): (run name, model-config overrides), each against phase 5 (remat off)
REMAT_RUNS = (
    ("remat_no_probs", dict(remat=True, remat_policy="no_probs")),
    ("remat_save_cheap", dict(remat=True, remat_policy="save_cheap")),
    ("remat_save_resid", dict(remat=True, remat_policy="save_resid")),
    ("remat_full", dict(remat=True, remat_policy="full")),
    ("remat_save_cheap_ffn", dict(remat=True, remat_policy="save_cheap", remat_ffn=True)),
    ("remat_full_fe0", dict(remat=True, remat_policy="full", remat_feature_extractor=True,
                            remat_fe_save_layers=0)),
    ("remat_full_fe2", dict(remat=True, remat_policy="full", remat_feature_extractor=True,
                            remat_fe_save_layers=2)),
)
# their peaks, each below the next; "lv60" is phase 5's
REMAT_PEAK_ORDER = ("remat_full", "remat_save_resid", "remat_save_cheap", "lv60")
# (b): the batch in one microbatch, what remat is for
REMAT_A1 = dict(remat=True, remat_policy="full", remat_feature_extractor=True,
                remat_fe_save_layers=0)
REMAT_CLI_ARGV = LV60_CLI_ARGV + ["--remat"]  # (c): save_cheap, the policy --remat resolves


def phase_remat(dev, card: str, lv60: dict, cli_lv60: dict) -> dict:
    """Returns the launch counts of its runs."""
    t_phase = time.perf_counter()
    out, peaks = {}, {"lv60": lv60["peak"]}
    g0 = lv60["grad"]
    # (a) phase 5's configuration under each remat setting
    for name, over in REMAT_RUNS:
        run = phase_full_width(dev, name, "wav2vec2-large-lv60", LV60_B, LV60_T, LV60_ACCUM, 2,
                               card, model=conv_ab.with_config(lv60["model"], **over), grad=True)
        g = run.pop("grad")
        result = {"first_loss": run["first_loss"], "off_first_loss": lv60["first_loss"],
                  "first_loss_bit_equal": run["first_loss"] == lv60["first_loss"],
                  "grad_max_rel_err": float((g - g0).abs().max() / g0.abs().max()),
                  "pgd_sign_agreement": float((torch.sign(g) == torch.sign(g0)).float().mean()),
                  "step_s": run["step_s"], "off_step_s": lv60["step_s"],
                  "peak_mem_gib": run["peak"] / 2**30, "off_peak_mem_gib": lv60["peak"] / 2**30}
        emit({"phase": "remat", "run": name, **over, **result, "tolerance": PAR_TOL,
              "card": card})
        check(result["first_loss_bit_equal"], f"remat {name}: first loss {result}")
        check(result["grad_max_rel_err"] <= PAR_TOL["grad_rel"], f"remat {name}: grad {result}")
        check(result["pgd_sign_agreement"] >= PAR_TOL["sign_agreement_min"],
              f"remat {name}: signs {result}")
        out[name], peaks[name] = run["launches"], run["peak"]
        del run, g
        torch.cuda.empty_cache()
    order = [peaks[n] for n in REMAT_PEAK_ORDER]
    emit({"phase": "remat", "peak_order": list(REMAT_PEAK_ORDER),
          "peaks_gib": [x / 2**30 for x in order], "card": card})
    check(all(a < b for a, b in zip(order, order[1:])),
          f"remat: peaks {dict(zip(REMAT_PEAK_ORDER, order))} not in that order")

    # (b) B=64 × 20 s in one microbatch
    run = phase_full_width(dev, "remat_a1", "wav2vec2-large-lv60", LV60_B, LV60_T, 1, 2, card,
                           model=conv_ab.with_config(lv60["model"], **REMAT_A1))
    emit({"phase": "remat", "run": "remat_a1", **REMAT_A1, "accum_steps": 1,
          "step_s": run["step_s"], "peak_mem_gib": run["peak"] / 2**30,
          "phase5_step_s": lv60["step_s"], "phase5_peak_mem_gib": lv60["peak"] / 2**30,
          "card": card})
    out["remat_a1"] = run["launches"]
    del run
    torch.cuda.empty_cache()

    # (c) phase 6's lv60 run_attack with --remat: eval has no backward, so
    # its clean scores are the run's without it
    res, facts, launches = run_cli("lv60_remat", REMAT_CLI_ARGV)
    want = expected_cli_launches(REMAT_CLI_ARGV, facts, fm=True, route="_sm90")
    values = [res[k][m] for k in ("eval_score_clean", "eval_score_perturbed",
                                  "final_test_perturbed") for m in ("ctc", "wer")]
    emit({"phase": "remat", "run": "cli_lv60_remat", **facts,
          **{k: res[k] for k in cli_lv60}, "without_remat": cli_lv60,
          "launches": launches, "want_launches": want, "wall_s": time.perf_counter() - t_phase,
          "card": card})
    check(res.get("finished_training") is True, "remat cli: the run did not finish")
    check(all(math.isfinite(v) for v in values), f"remat cli: non-finite scores {values}")
    for key, value in cli_lv60.items():
        check(res[key] == value, f"remat cli: {key} {res[key]} against {value} without remat")
    check(launches == want, f"remat cli: launched {launches}, want {want}")
    out["cli_lv60_remat"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 12: the feature extractor's conv lowerings and fused_qkv
# ---------------------------------------------------------------------------

CONV_IMPLS = ("conv", "hybrid", "pairdot", "im2col", "tapdot")
# (c): each lowering's logits and ∂logits/∂audio against conv's in float32,
# TF32 off, as max |Δ| / max |conv's|: sums in another order, no bf16
LOWERING_F32_TOL = 1e-4
LOWERING_CLI_ARGV = ANCHOR_ARGV + ["--conv_impl", "hybrid"]  # (e)


def lowering_run(dev, name: str, preset: str, B: int, T: int, accum: int, card: str,
                 model, ref: dict | None, per_step: dict) -> dict:
    """One phase-12 configuration at full width: 1 warm-up and 2 timed
    steps (phase_full_width), launches a train step equal to ``per_step``
    (phase 4's or 5's), the feature extractor's forward and backward times
    on one microbatch, and the first loss and ∂loss/∂p at p = 0 against
    ``ref``'s (the same preset under conv; None for conv itself)."""
    run = phase_full_width(dev, name, preset, B, T, accum, 2, card, model=model, grad=True)
    fe = conv_ab.fe_times(run["model"], full_width_batch(B, T, dev)[0][: B // accum])
    out = {"conv_impl": model.cfg.conv_impl, "fused_qkv": model.cfg.fused_qkv,
           "step_s": run["step_s"], "peak_mem_gib": run["peak"] / 2**30, **fe,
           "first_loss": run["first_loss"], "launches_per_train_step": run["per_step"]}
    if ref is not None:
        g, g0 = run["grad"], ref["grad"]
        out.update(ref_first_loss=ref["first_loss"],
                   loss_rel_err=abs(run["first_loss"] - ref["first_loss"]) / abs(ref["first_loss"]),
                   grad_max_rel_err=float((g - g0).abs().max() / g0.abs().max()),
                   pgd_sign_agreement=float((torch.sign(g) == torch.sign(g0)).float().mean()))
    emit({"phase": "lowerings", "run": name, "model": preset, "batch": B, "samples": T,
          "accum_steps": accum, **out, "tolerance": PAR_TOL, "card": card})
    check(run["per_step"] == per_step, f"lowerings {name}: launches a step {run['per_step']}, "
                                       f"want {per_step}")
    if ref is not None:
        check(out["loss_rel_err"] <= PAR_TOL["loss_rel"], f"lowerings {name}: loss {out}")
        check(out["grad_max_rel_err"] <= PAR_TOL["grad_rel"], f"lowerings {name}: grad {out}")
        check(out["pgd_sign_agreement"] >= PAR_TOL["sign_agreement_min"],
              f"lowerings {name}: signs {out}")
    return {"launches": run["launches"], "first_loss": run["first_loss"], "grad": run["grad"]}


def lowering_f32(dev, card: str) -> None:
    """(c) wav2vec2-base's geometry at depth 2, B=2 × 1 s, float32 with TF32
    off (runtime.require_cuda): each lowering's logits and ∂(Σ logits·ct)/
    ∂audio against conv's, and K1/K2's register route launched in each."""
    base = wav2vec2.init_model(wav2vec2.get_config(
        "wav2vec2-base", num_hidden_layers=2, compute_dtype="float32"), seed=SEED).to(dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    audio = torch.randn((2, 16_000), device=dev, generator=gen) * 0.1
    ct = None
    got, launches = {}, {}
    for impl in CONV_IMPLS:
        model = conv_ab.with_config(base, conv_impl=impl)
        a = audio.clone().requires_grad_(True)
        _lib.reset_launches()
        logits = model(a)
        if ct is None:
            ct = torch.randn(logits.shape, device=dev, generator=gen)
        (g,) = torch.autograd.grad((logits * ct).sum(), a)
        launches[impl] = dict(_lib.launches)
        got[impl] = (logits.detach(), g)
    l0, g0 = got["conv"]
    errs = {impl: {"logits_rel_err": float((l - l0).abs().max() / l0.abs().max()),
                   "grad_rel_err": float((g - g0).abs().max() / g0.abs().max())}
            for impl, (l, g) in got.items() if impl != "conv"}
    emit({"phase": "lowerings", "run": "f32_exactness", "model": "wav2vec2-base", "layers": 2,
          "batch": 2, "samples": 16_000, "compute_dtype": "float32",
          "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
          "errors": errs, "tolerance": LOWERING_F32_TOL, "launches": launches, "card": card})
    check(not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
          "lowerings f32: TF32 is on")
    for impl, e in errs.items():
        check(max(e.values()) <= LOWERING_F32_TOL, f"lowerings f32 {impl}: {e}")
    for impl, n in launches.items():  # float32 at head dim 64: the register route
        check(n["attention_fwd"] == 2 and n["attention_bwd"] == 2,
              f"lowerings f32 {impl}: launched {n}")


def phase_lowerings(dev, card: str, main: dict, lv60: dict, anchor: dict) -> dict:
    """Returns the launch counts of its runs."""
    t_phase = time.perf_counter()
    out = {}
    # (a) base at phase 4's shape: phase 4's weights (init_model from SEED)
    base = wav2vec2.init_model(wav2vec2.get_config("wav2vec2-base"), seed=SEED)
    base = base.cast_param_storage(torch.bfloat16).to(dev)
    ref = None
    for impl in CONV_IMPLS:
        name = f"lowering_base_{impl}"
        run = lowering_run(dev, name, "wav2vec2-base", MAIN_B, MAIN_T, 1, card,
                           conv_ab.with_config(base, conv_impl=impl), ref, main["per_step"])
        if ref is None:  # conv: phase 4's configuration, so its first loss
            check(run["first_loss"] == main["first_loss"],
                  f"lowerings: conv's first loss {run['first_loss']} against phase 4's "
                  f"{main['first_loss']}")
            ref = run
        out[name] = run.pop("launches")
        torch.cuda.empty_cache()
    # (d) fused_qkv at phase 4's shape, against (a)'s conv run
    run = lowering_run(dev, "fused_qkv", "wav2vec2-base", MAIN_B, MAIN_T, 1, card,
                       conv_ab.with_config(base, fused_qkv=True), ref, main["per_step"])
    out["fused_qkv"] = run["launches"]
    del base, ref, run
    torch.cuda.empty_cache()
    # (b) lv60 at phase 5's shape, on phase 5's weights
    ref = None
    for impl in CONV_IMPLS:
        name = f"lowering_lv60_{impl}"
        model = conv_ab.with_config(lv60["model"], conv_impl=impl)
        run = lowering_run(dev, name, "wav2vec2-large-lv60", LV60_B, LV60_T, LV60_ACCUM, card,
                           model, ref, {**lv60["per_step"], **fe_step(model.cfg, LV60_ACCUM)})
        if ref is None:
            check(run["first_loss"] == lv60["first_loss"],
                  f"lowerings: conv's first loss {run['first_loss']} against phase 5's "
                  f"{lv60['first_loss']}")
            ref = run
        out[name] = run.pop("launches")
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()
    # (c) float32 exactness
    lowering_f32(dev, card)
    # (e) the CLI anchor with --conv_impl hybrid against phase 6 (a)'s run
    res, facts, launches = run_cli("anchor_hybrid", LOWERING_CLI_ARGV)
    clean, ref_clean = res["final_test_clean"], anchor["final_test_clean"]
    ctc_rel = abs(clean["ctc"] - ref_clean["ctc"]) / ref_clean["ctc"]
    wer_abs = abs(clean["wer"] - ref_clean["wer"])
    want = expected_cli_launches(LOWERING_CLI_ARGV, facts, fm=False, route="")
    emit({"phase": "lowerings", "run": "cli_anchor_hybrid", **facts, "final_test_clean": clean,
          "conv_final_test_clean": ref_clean, "ctc_rel_err": ctc_rel, "wer_abs_err": wer_abs,
          "tolerance": ANCHOR_TOL, "launches": launches, "want_launches": want,
          "wall_s": time.perf_counter() - t_phase, "card": card})
    check(res.get("finished_training") is True, "lowerings cli: the run did not finish")
    check(ctc_rel <= ANCHOR_TOL["ctc_rel"], f"lowerings cli: clean CTC {clean} against {ref_clean}")
    check(wer_abs <= ANCHOR_TOL["wer_abs"], f"lowerings cli: clean WER {clean} against {ref_clean}")
    check(facts["audio_len"] == anchor["audio_len"], f"lowerings cli: clips {facts['audio_len']}")
    check(launches == want, f"lowerings cli: launched {launches}, want {want}")
    out["anchor_hybrid"] = launches
    return out


# (row name, launch counter, source, TPU kernel it replaces, runs whose
# launches it reports, check at those runs' shapes and direction it takes
# its numbers from). The base sweep's clips are longer than phase 4's, so
# its K1/K2/K3 rows are its own, with phase 2's numbers at its shapes, and
# count phase 10's run_attack runs on its corpus too. The JAX
# package's flash kernel (K4) runs where its fused kernel's score tile no
# longer fits VMEM, T ≥ 774; on the card K1 and K2 cover those lengths, so
# K4's rows are theirs, counted in lv60. The register routes of K1 and K2
# (float32, and bf16 with head dim 16) are counted in the CLI's tiny anchor
# and its 1-cell sweep, which run bf16 with head dim 16 on the same clips.
K1_TPU = "paa_tpu/ops/pallas/attention.py:107 (_fwd_kernel, via _attend_fwd :196)"
K2_TPU = "paa_tpu/ops/pallas/attention.py:133 (_bwd_kernel, via _attend_bwd :218)"
K4_TPU = "paa_tpu/models/wav2vec2.py:766 (_flash_attention, stock Pallas flash_attention, {})"
K3_TPU = "paa_tpu/ops/pallas/fm_norm.py:40 (_kernel, via fm_weighted_power_sum :61)"
K5_TPU = "none: paa_tpu/models/wav2vec2.py:535-573 runs lax.conv_general_dilated"
K6_TPU = ("none: paa_tpu/models/wav2vec2.py:445-456 runs the bias add, _FeNorm (:475) and "
          "nn.gelu as jnp operations, which XLA fuses")
K7_TPU = ("none: paa_tpu/models/wav2vec2.py:803-852 runs _layernorm (a custom VJP) as jnp "
          "operations, which XLA fuses")
REMAT_NAMES = tuple(name for name, _ in REMAT_RUNS)  # phase 11 (a), at phase 5's shapes
# phase 12 (a) and (d), at phase 4's shapes; (b), at phase 5's
LOWERING_BASE_NAMES = tuple(f"lowering_base_{impl}" for impl in CONV_IMPLS) + ("fused_qkv",)
LOWERING_LV60_NAMES = tuple(f"lowering_lv60_{impl}" for impl in CONV_IMPLS)
KERNELS = (
    ("attention_fwd", "attention_fwd_sm90", "paa_tpu_torch/csrc/attention_fwd_sm90.cu", K1_TPU,
     ("main",) + LOWERING_BASE_NAMES, "attention", "fwd"),
    ("attention_bwd", "attention_bwd_sm90", "paa_tpu_torch/csrc/attention_bwd_sm90.cu", K2_TPU,
     ("main",) + LOWERING_BASE_NAMES, "attention", "bwd"),
    ("fm_norm", "fm_norm", "paa_tpu_torch/csrc/fm_norm.cu", K3_TPU, ("main",) + LOWERING_BASE_NAMES,
     "fm_norm", None),
    ("attention_fwd_sweep", "attention_fwd_sm90", "paa_tpu_torch/csrc/attention_fwd_sm90.cu",
     K1_TPU, ("sweep", "feed_host", "feed_device"), "attention_sweep", "fwd"),
    ("attention_bwd_sweep", "attention_bwd_sm90", "paa_tpu_torch/csrc/attention_bwd_sm90.cu",
     K2_TPU, ("sweep", "feed_host", "feed_device"), "attention_sweep", "bwd"),
    ("fm_norm_sweep", "fm_norm", "paa_tpu_torch/csrc/fm_norm.cu", K3_TPU,
     ("sweep", "feed_host", "feed_device"), "fm_norm_sweep", None),
    ("flash_attention_fwd", "attention_fwd_sm90", "paa_tpu_torch/csrc/attention_fwd_sm90.cu",
     K4_TPU.format("forward"), ("lv60",) + REMAT_NAMES + LOWERING_LV60_NAMES, "attention_long",
     "fwd"),
    ("flash_attention_bwd", "attention_bwd_sm90", "paa_tpu_torch/csrc/attention_bwd_sm90.cu",
     K4_TPU.format("backward"), ("lv60",) + REMAT_NAMES + LOWERING_LV60_NAMES, "attention_long",
     "bwd"),
    # phase 11 (b): lv60's whole batch of 64 in one microbatch
    ("flash_attention_fwd_a1", "attention_fwd_sm90", "paa_tpu_torch/csrc/attention_fwd_sm90.cu",
     K4_TPU.format("forward"), ("remat_a1",), "attention_long_a1", "fwd"),
    ("flash_attention_bwd_a1", "attention_bwd_sm90", "paa_tpu_torch/csrc/attention_bwd_sm90.cu",
     K4_TPU.format("backward"), ("remat_a1",), "attention_long_a1", "bwd"),
    ("attention_fwd_reg", "attention_fwd", "paa_tpu_torch/csrc/attention_fwd.cu", K1_TPU,
     ("anchor", "sweep_anchor", "sweep_two_ranks", "anchor_hybrid"), "attention_tiny", "fwd"),
    ("attention_bwd_reg", "attention_bwd", "paa_tpu_torch/csrc/attention_bwd.cu", K2_TPU,
     ("anchor", "sweep_anchor", "sweep_two_ranks", "anchor_hybrid"), "attention_tiny", "bwd"),
    ("attention_fwd_pretrain", "attention_fwd_sm90", "paa_tpu_torch/csrc/attention_fwd_sm90.cu",
     K1_TPU, ("pretrain_base",), "attention_pretrain", "fwd"),
    ("attention_bwd_pretrain", "attention_bwd_sm90", "paa_tpu_torch/csrc/attention_bwd_sm90.cu",
     K2_TPU, ("pretrain_base",), "attention_pretrain", "bwd"),
    ("attention_fwd_reg_pretrain", "attention_fwd", "paa_tpu_torch/csrc/attention_fwd.cu",
     K1_TPU, ("pretrain_tiny",), "attention_pretrain_tiny", "fwd"),
    ("attention_bwd_reg_pretrain", "attention_bwd", "paa_tpu_torch/csrc/attention_bwd.cu",
     K2_TPU, ("pretrain_tiny",), "attention_pretrain_tiny", "bwd"),
    ("fm_norm_lv60", "fm_norm", "paa_tpu_torch/csrc/fm_norm.cu", K3_TPU,
     ("lv60",) + REMAT_NAMES + ("remat_a1",) + LOWERING_LV60_NAMES, "fm_norm_lv60", None),
    # phase 9: each rank's shapes; the 2-rank sweep runs the anchor's shape
    ("attention_fwd_dp", "attention_fwd_sm90", "paa_tpu_torch/csrc/attention_fwd_sm90.cu",
     K1_TPU, ("par_dp",), "attention_dp", "fwd"),
    ("attention_bwd_dp", "attention_bwd_sm90", "paa_tpu_torch/csrc/attention_bwd_sm90.cu",
     K2_TPU, ("par_dp",), "attention_dp", "bwd"),
    ("attention_fwd_tp", "attention_fwd_sm90", "paa_tpu_torch/csrc/attention_fwd_sm90.cu",
     K1_TPU, ("par_tp",), "attention_tp", "fwd"),
    ("attention_bwd_tp", "attention_bwd_sm90", "paa_tpu_torch/csrc/attention_bwd_sm90.cu",
     K2_TPU, ("par_tp",), "attention_tp", "bwd"),
    ("fm_norm_parallel", "fm_norm", "paa_tpu_torch/csrc/fm_norm.cu", K3_TPU, ("par_dp", "par_tp"),
     "fm_norm", None),
    ("attention_fwd_reg_dp", "attention_fwd", "paa_tpu_torch/csrc/attention_fwd.cu", K1_TPU,
     ("cli_dp", "cli_dp_device"), "attention_tiny_dp", "fwd"),
    ("attention_bwd_reg_dp", "attention_bwd", "paa_tpu_torch/csrc/attention_bwd.cu", K2_TPU,
     ("cli_dp", "cli_dp_device"), "attention_tiny_dp", "bwd"),
    ("attention_fwd_reg_tp", "attention_fwd", "paa_tpu_torch/csrc/attention_fwd.cu", K1_TPU,
     ("cli_tp",), "attention_tiny_tp", "fwd"),
    ("attention_bwd_reg_tp", "attention_bwd", "paa_tpu_torch/csrc/attention_bwd.cu", K2_TPU,
     ("cli_tp",), "attention_tiny_tp", "bwd"),
    # K5 at base's batch (phase 4 and 12 (a)) and an lv60 microbatch (phases
    # 5, 11 (a) and 12 (b))
    ("pos_conv_fwd", "pos_conv", "paa_tpu_torch/csrc/pos_conv.cu", K5_TPU,
     ("main",) + LOWERING_BASE_NAMES, "pos_conv", "fwd"),
    ("pos_conv_dgrad", "pos_conv_dgrad", "paa_tpu_torch/csrc/pos_conv.cu", K5_TPU,
     ("main",) + LOWERING_BASE_NAMES, "pos_conv", "dgrad"),
    ("pos_conv_fwd_long", "pos_conv", "paa_tpu_torch/csrc/pos_conv.cu", K5_TPU,
     ("lv60",) + REMAT_NAMES + LOWERING_LV60_NAMES, "pos_conv_long", "fwd"),
    ("pos_conv_dgrad_long", "pos_conv_dgrad", "paa_tpu_torch/csrc/pos_conv.cu", K5_TPU,
     ("lv60",) + REMAT_NAMES + LOWERING_LV60_NAMES, "pos_conv_long", "dgrad"),
    # K6 at lv60's layer 0 and layer 6 for one microbatch; every lv60 run
    # launches it at all seven layers, the conv lowerings' on (B, T, C)
    *((f"fe_norm_{d}_{layer}", counter, "paa_tpu_torch/csrc/fe_norm.cu", K6_TPU,
       ("lv60",) + REMAT_NAMES + ("remat_a1", "cli_lv60", "cli_lv60_remat")
       + LOWERING_LV60_NAMES, f"fe_norm_{layer}", d)
      for layer in ("l0", "l6") for d, counter in (("fwd", "fe_norm"), ("bwd", "fe_norm_bwd"))),
    # K7 at an lv60 microbatch and a base batch; each run launches it at
    # every LayerNorm, the feature projection's (C = 512 at lv60) included
    *((f"layer_norm_{d}_{model}", counter, "paa_tpu_torch/csrc/layer_norm.cu", K7_TPU, runs,
       f"layer_norm_{model}", d)
      for model, runs in (("lv60", ("lv60",) + REMAT_NAMES + ("remat_a1", "cli_lv60",
                                                             "cli_lv60_remat")
                           + LOWERING_LV60_NAMES),
                          ("base", ("main",) + LOWERING_BASE_NAMES))
      for d, counter in (("fwd", "layer_norm"), ("bwd", "layer_norm_bwd"))),
)


def kernel_row(check_out: dict, direction: str | None) -> dict:
    """The numbers of one kernel row from its check."""
    if direction is None:  # K3
        keys = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        return {k: check_out[k] for k in keys}
    if check_out["kernel"] in ("fe_norm", "layer_norm"):  # K6, K7
        dims = ("B", "C", "T") if check_out["kernel"] == "fe_norm" else ("B", "T", "C")
        return {"shape": [check_out[k] for k in dims], "dtype": check_out["dtype"],
                "max_abs_err": check_out["out_max_abs_err" if direction == "fwd" else
                                         "dx_max_abs_err"],
                **{k: check_out[f"{direction}_{k}"] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "peak_share",
                    "library_ms")}}
    if check_out["kernel"] == "pos_conv":  # K5
        err = (max(check_out["pre_max_abs_err"], check_out["out_max_abs_err"])
               if direction == "fwd" else check_out["dx_max_abs_err"])
        return {"shape": [check_out[k] for k in ("B", "T", "H", "Cg", "K")],
                "dtype": check_out["dtype"], "max_abs_err": err,
                **{k: check_out[f"{direction}_{k}"] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "peak_share",
                    "library_ms")}}
    err = (check_out["o_max_abs_err"] if direction == "fwd" else
           max(check_out[f"{g}_max_abs_err"] for g in ("dq", "dk", "dv")))
    return {"shape": [check_out[k] for k in ("B", "T", "H", "d")], "dtype": check_out["dtype"],
            "max_abs_err": err, "ms": check_out[f"{direction}_ms"],
            "device_ms": check_out[f"{direction}_device_ms"],
            "plain_ms": check_out[f"{direction}_plain_ms"],
            "bound_ms": check_out[f"{direction}_bound_ms"],
            "bound_by": check_out[f"{direction}_bound_by"],
            "library_ms": check_out[f"{direction}_library_ms"],
            "library_device_ms": check_out[f"{direction}_library_device_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--worker"]:  # one rank of phase 9
        return worker(sys.argv[2], sys.argv[3], sys.argv[4:])
    dev = runtime.require_cuda()

    t0 = time.perf_counter()
    _lib.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda, "card": smi})
    print(smi, flush=True)

    at_main = phase_kernels(dev)
    phase_tiny(dev)
    main_run = phase_full_width(dev, "main", "wav2vec2-base", MAIN_B, MAIN_T, 1, 3, smi)
    del main_run["model"]  # later phases' peaks are held against this one's
    launches = {"main": main_run["launches"]}
    torch.cuda.empty_cache()
    lv60_run = phase_full_width(dev, "lv60", "wav2vec2-large-lv60", LV60_B, LV60_T,
                                LV60_ACCUM, 2, smi, grad=True)
    launches["lv60"] = lv60_run["launches"]
    torch.cuda.empty_cache()
    launches.update(phase_cli(smi))
    torch.cuda.empty_cache()
    launches.update(phase_remat(dev, smi, lv60_run, launches.pop("cli_lv60_run")))
    torch.cuda.empty_cache()
    launches.update(phase_lowerings(dev, smi, main_run, lv60_run, launches["anchor_run"]))
    del lv60_run
    torch.cuda.empty_cache()
    anchor = launches.pop("anchor_run")
    launches.update(phase_sweep(smi, main_run, anchor))
    torch.cuda.empty_cache()
    launches.update(phase_pretrain(dev, smi))
    torch.cuda.empty_cache()
    launches.update(phase_parallel(dev, smi, anchor))
    torch.cuda.empty_cache()
    launches.update(phase_feed(dev, smi, main_run, anchor))
    # torch.profiler now and then sees no device operation in three traces
    # (once after phases 3-7, once in phase 2): whether it still sees the
    # device is recorded here, not checked
    spec = torch.randn((1, 513, 626), dtype=torch.complex64, device=dev)
    tables = psycho.build_tables(AttackConfig(norm_type="fletcher_munson"), dev)
    emit({"phase": "profiler_probe", "device_ops": fm_profile.device_ops(
        lambda: fm_norm.fm_weighted_power_sum(spec, tables))})
    # the register route at the anchor's shape: its 32 clips, 4 heads of 16
    frames = launches.pop("anchor_frames")
    at_main["attention_tiny"] = check_attention(32, frames, 4, 16, torch.bfloat16, dev)
    # phase 9's anchor runs: dp=2 holds 16 of its 32 rows, tp=2 two of its 4 heads
    at_main["attention_tiny_dp"] = check_attention(32 // PAR_RANKS, frames, 4, 16,
                                                   torch.bfloat16, dev)
    at_main["attention_tiny_tp"] = check_attention(32, frames, 4 // PAR_RANKS, 16,
                                                   torch.bfloat16, dev)
    for name in ("attention_tiny", "attention_tiny_dp", "attention_tiny_tp"):
        check(not at_main[name]["failed"], f"kernels: the anchor's shape ({name})")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(launches[run][counter] for run in runs),
         "launches_by_run": {run: launches[run][counter] for run in runs},
         **kernel_row(at_main[chk], direction)}
        for name, counter, src, rep, runs, chk, direction in KERNELS]})
    check(not any(m.split(".")[0] in ("jax", "flax", "optax", "paa_tpu") for m in sys.modules),
          "JAX or the JAX package was imported")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
