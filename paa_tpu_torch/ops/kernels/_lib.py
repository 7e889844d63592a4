"""Build, load and count the port's CUDA kernels.

The sources in ``paa_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, bound with
``ctypes``. The build runs at first use, one ``nvcc`` per source started
together, into ``build/paa_tpu_torch/`` at the repository root; the
library's file name carries a hash of the sources, so an edited source is
never served by a stale build. Processes that start together (the ranks of
a ``torchrun`` launch) build under an exclusive file lock: the first builds,
the others wait and load its library; a failed build raises in the process
that ran it, and each waiting process then builds again and raises too.

``launches`` counts, per kernel, the wrapper calls that launched it. A run
sets the counts to 0 with :func:`reset_launches` and reads them after.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paa_tpu_torch"
SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "attention_fwd_sm90.cu",
           "attention_bwd_sm90.cu", "fm_norm.cu", "pos_conv.cu", "fe_norm.cu",
           "layer_norm.cu", "attention_relpos_sm90.cu")
HEADERS = ("attention_common.cuh", "attention_sm90.cuh", "row_io.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# attention_fwd/_bwd: the register-route kernels (float32, and bf16 with head
# dim 16);
# attention_fwd_sm90/_bwd_sm90: the wgmma + TMA kernels (bf16, head dim 64);
# pos_conv/_dgrad: the positional conv's forward and input gradient (bf16);
# fe_norm/_bwd: the feature extractor's bias + LayerNorm + GELU, forward and
# backward (bf16 and float32, either layout);
# layer_norm/_bwd: the LayerNorm over the last axis, forward and backward
# (bf16 and float32);
# attention_relpos_fwd/_bwd: the relative-position attention K8 (bf16, head
# dim 64)
launches = {"attention_fwd": 0, "attention_bwd": 0, "attention_fwd_sm90": 0,
            "attention_bwd_sm90": 0, "fm_norm": 0, "pos_conv": 0, "pos_conv_dgrad": 0,
            "fe_norm": 0, "fe_norm_bwd": 0, "layer_norm": 0, "layer_norm_bwd": 0,
            "attention_relpos_fwd": 0, "attention_relpos_bwd": 0}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, B, T, H, D, is_bf16, stream
    "paa_attention_fwd": (_P,) * 5 + (_I,) * 5 + (_P,),
    # q, k, v, o, lse, do, dq, dk, dv, B, T, H, D, is_bf16, stream
    "paa_attention_bwd": (_P,) * 9 + (_I,) * 5 + (_P,),
    # q, k, v, o, lse, B, T, H, stream
    "paa_attention_fwd_sm90": (_P,) * 5 + (_I,) * 3 + (_P,),
    # q, k, v, o, lse, do, dq, dk, dv, scratch, B, T, H, stream
    "paa_attention_bwd_sm90": (_P,) * 10 + (_I,) * 3 + (_P,),
    # T
    "paa_attention_bwd_sm90_rows": (_I,),
    # stft, table, in_domain, partials, ticket, out, B, F, T, its strides,
    # max blocks, threads, stream
    "paa_fm_power_sum": (_P,) * 6 + (_I,) * 3 + (_L,) * 3 + (_I,) * 2 + (_P,),
    # x, taps, bias, pre, out, B, T, H, Cg, K, stream
    "paa_pos_conv_fwd": (_P,) * 5 + (_I,) * 5 + (_P,),
    # dpre, taps, dx, B, T, H, Cg, K, stream
    "paa_pos_conv_dgrad": (_P,) * 3 + (_I,) * 5 + (_P,),
    # y, bias, gamma, beta, out, mean, rstd, B, C, T, eps, tanh, channels_last,
    # is_bf16, stream
    "paa_fe_norm_fwd": (_P,) * 7 + (_I,) * 3 + (_F, _I, _I, _I, _P),
    # g, y, bias, gamma, beta, mean, rstd, dx, partial, grid, B, C, T, tanh,
    # channels_last, is_bf16, stream
    "paa_fe_norm_bwd": (_P,) * 9 + (_I,) * 7 + (_P,),
    # x, gamma, beta, out, xhat, rstd, rows, C, eps, is_bf16, stream
    "paa_layer_norm_fwd": (_P,) * 6 + (_I, _I, _F, _I, _P),
    # g, xhat, rstd, gamma, dx, partial, grid, rows, C, is_bf16, stream
    "paa_layer_norm_bwd": (_P,) * 6 + (_I,) * 4 + (_P,),
    # qu, qv, k, v, pos, o, lse, B, T, H, stream
    "paa_attention_relpos_fwd_sm90": (_P,) * 7 + (_I,) * 3 + (_P,),
    # qu, qv, k, v, pos, o, lse, do, dqu, dqv, dk, dv, scratch, B, T, H, stream
    "paa_attention_relpos_bwd_sm90": (_P,) * 13 + (_I,) * 3 + (_P,),
    "paa_error_string": (_I,),
}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha1()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    build_log = "\n".join(logs)
    (BUILD_DIR / "nvcc.log").write_text(build_log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp_so = work / target.name
    link = subprocess.run(
        [nvcc, "-shared", *map(str, objs), "-o", str(tmp_so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp_so, target)
    shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    target = BUILD_DIR / f"libpaa_kernels-{_source_hash()}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # the OS drops an flock when its holder exits, also on a crash
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not target.exists():
                _build(target)
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.paa_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the row kernels load
    and store 16 bytes at a time): a copy only where it is neither."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        message = library().paa_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
