"""Build, load and count the port's CUDA kernels.

The sources in ``paa_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, bound with
``ctypes``. The build runs at first use, one ``nvcc`` per source started
together, into ``build/paa_tpu_torch/`` at the repository root; the
library's file name carries a hash of the sources, so an edited source is
never served by a stale build.

``launches`` counts, per kernel, the wrapper calls that launched it. A run
sets the counts to 0 with :func:`reset_launches` and reads them after.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paa_tpu_torch"
SOURCES = ("attention_fwd.cu", "attention_bwd.cu", "fm_norm.cu")
HEADERS = ("attention_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches = {"attention_fwd": 0, "attention_bwd": 0, "fm_norm": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, B, T, H, D, is_bf16, stream
    "paa_attention_fwd": (_P,) * 5 + (_I,) * 5 + (_P,),
    # q, k, v, o, lse, do, dq, dk, dv, delta, B, T, H, D, is_bf16, stream
    "paa_attention_bwd": (_P,) * 10 + (_I,) * 5 + (_P,),
    # stft (as real pairs), table, in_domain, partials, out, B, F, T, stream
    "paa_fm_power_sum": (_P,) * 5 + (_I,) * 3 + (_P,),
    # B, F, T
    "paa_fm_num_partials": (_I,) * 3,
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
        _build(target)
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.paa_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        message = library().paa_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
