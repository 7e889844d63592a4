"""Time variants of the Hopper attention kernels K1/K2 against the built ones.

    python3 tools/attention_variants.py

Each variant is the kernel source of ``paa_tpu_torch/csrc`` with a few
literal substitutions (ring stages, blocks per SM, the backward's
ping-pong). The script builds the
port's kernel library and every variant (one nvcc each, in parallel, into
``build/paa_tpu_torch/``), checks that each variant gives the same bits as
the built kernel, then times the built kernel and each variant at base's
shape (64, 499, 12, 64) and the lv60 microbatch (32, 999, 16, 64), bf16, in
three rounds of alternating order. It prints one JSON line per shape with
the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from paa_tpu_torch.ops.kernels import _lib, attention  # noqa: E402

FWD, BWD = "attention_fwd_sm90.cu", "attention_bwd_sm90.cu"
DQ_ONE = "__launch_bounds__(kThreads, 1)\nattn_bwd_dq_sm90_kernel("
# name: (source, [(text in the source, its replacement)])
VARIANTS = {
    "fwd_stages2": (FWD, [("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
    "fwd_stages3": (FWD, [("constexpr int kStages = 4;", "constexpr int kStages = 3;")]),
    "bwd_stages2": (BWD, [("constexpr int kStages = 4;", "constexpr int kStages = 2;")]),
    "bwd_stages3": (BWD, [("constexpr int kStages = 4;", "constexpr int kStages = 3;")]),
    "bwd_dq_2_blocks_per_sm": (BWD, [(DQ_ONE, DQ_ONE.replace("kThreads, 1", "kThreads, 2"))]),
    # the two consumer warpgroups issue their products whenever they are ready
    "bwd_no_pingpong": (BWD, [("pp.start();", ""), ("pp.wait_turn();", ""),
                              ("pp.pass(false);", ""), ("pp.pass(j == n_tiles - 1);", "")]),
}
SHAPES = ((64, 499, 12), (32, 999, 16))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build(name: str, source: str, subs) -> subprocess.Popen:
    text = (_lib.CSRC / source).read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    src = _lib.BUILD_DIR / f"variant_{name}.cu"
    src.write_text(text)
    return subprocess.Popen(
        [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-shared", str(src),
         "-o", str(src.with_suffix(".so"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def fwd_call(lib):
    lib.paa_attention_fwd_sm90.argtypes = [_P] * 5 + [_I] * 3 + [_P]

    def run(q, k, v, o, lse, do, H):
        B, T, _ = q.shape
        out = torch.empty_like(q)
        lse_out = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
        _lib.check(lib.paa_attention_fwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_out.data_ptr(),
            B, T, H, torch.cuda.current_stream().cuda_stream), "variant fwd")
        return out, lse_out
    return run


def bwd_call(lib):
    lib.paa_attention_bwd_sm90.argtypes = [_P] * 10 + [_I] * 3 + [_P]
    lib.paa_attention_bwd_sm90_rows.argtypes = [_I]

    def run(q, k, v, o, lse, do, H):
        B, T, _ = q.shape
        grads = [torch.empty_like(q) for _ in range(3)]
        scratch = torch.empty((2, B, H, lib.paa_attention_bwd_sm90_rows(T)),
                              dtype=torch.float32, device=q.device)
        _lib.check(lib.paa_attention_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), *(g.data_ptr() for g in grads), scratch.data_ptr(), B, T, H,
            torch.cuda.current_stream().cuda_stream), "variant bwd")
        return grads
    return run


def time_ms(fn, iters=30) -> float:
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
    if not torch.cuda.is_available():
        print("attention_variants.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    _lib.library()
    procs = {n: build(n, src, subs) for n, (src, subs) in VARIANTS.items()}
    runs = {
        "fwd_built": lambda q, k, v, o, lse, do, H: attention.attention_fwd(q, k, v, H),
        "bwd_built": lambda q, k, v, o, lse, do, H: attention.attention_bwd(q, k, v, o, lse, do, H),
    }
    kind = {"fwd_built": "fwd", "bwd_built": "bwd"}
    ptxas = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        ptxas[name] = [ln.strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(_lib.BUILD_DIR / f"variant_{name}.so"))
        kind[name] = "fwd" if VARIANTS[name][0] == FWD else "bwd"
        runs[name] = (fwd_call if kind[name] == "fwd" else bwd_call)(lib)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(json.dumps({"ptxas": ptxas, "card": smi}), flush=True)
    for B, T, H in SHAPES:
        g = torch.Generator(device=dev).manual_seed(T)
        q, k, v, do = [(torch.randn((B, T, H * 64), generator=g, device=dev) * 0.5)
                       .to(torch.bfloat16) for _ in range(4)]
        o, lse = attention.attention_fwd(q, k, v, H)
        args = (q, k, v, o, lse, do, H)
        want = {"fwd": runs["fwd_built"](*args), "bwd": runs["bwd_built"](*args)}
        same = {n: all(torch.equal(a, b) for a, b in zip(fn(*args), want[kind[n]]))
                for n, fn in runs.items()}
        ms = {n: [] for n in runs}
        for rnd in range(3):
            for n in (list(runs) if rnd % 2 == 0 else list(reversed(runs))):
                ms[n].append(time_ms(lambda fn=runs[n]: fn(*args)))
        print(json.dumps({"B": B, "T": T, "H": H, "d": 64, "dtype": "bfloat16", "card": smi,
                          "same_bits": same, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
