"""Word Error Rate — corpus-level, jiwer-compatible semantics.

WER = (total word-level edit distance) / (total reference words), summed
over the corpus — the convention of HF ``evaluate.load("wer")`` (built on
jiwer) that the reference consumes (reference: src/core/
loss_helpers.py:25-32, src/run_attack.py:27).

Words are interned to integer ids, and the per-pair Levenshtein DP runs
in a small C kernel (paa_tpu_torch/csrc/levenshtein.c) compiled on first
use into ``build/paa_tpu_torch/``;
a pure-numpy DP is the fallback so the package works without a C
toolchain. Either way this is host-side work over already-decoded
strings — the device only produces argmax ids (ops/ctc.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile

import numpy as np

from paa_tpu_torch.ops.kernels._lib import BUILD_DIR, CSRC

logger = logging.getLogger(__name__)

_BUILD_DIR = str(BUILD_DIR)
_C_SOURCE = str(CSRC / "levenshtein.c")
_SO_PATH = os.path.join(_BUILD_DIR, "_levenshtein.so")

_lib = None
_lib_tried = False


def _build_so():
    # build inside the destination dir: os.replace from a /tmp on
    # a different filesystem raises EXDEV and would silently
    # disable the kernel forever
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
        tmp_so = os.path.join(td, "_levenshtein.so")
        subprocess.run(
            ["cc", "-O3", "-shared", "-fPIC", "-o", tmp_so, _C_SOURCE],
            check=True,
            capture_output=True,
        )
        os.replace(tmp_so, _SO_PATH)


def _open_so():
    lib = ctypes.CDLL(_SO_PATH)
    lib.batched_edit_distance.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.batched_edit_distance.restype = None
    return lib


def _self_test(lib) -> bool:
    """Validate the loaded kernel against the numpy DP on known cases —
    an mtime check alone cannot prove a committed/cached .so matches the
    current levenshtein.c (e.g. after a git checkout resets both mtimes)."""
    cases = [
        ([1, 2, 3], [1, 2, 3]),  # equal → 0
        ([1, 2, 3], [1, 3]),     # delete → 1
        ([], [4, 5]),            # empty pred → 2
        ([1, 2], [3, 4]),        # disjoint → 2
        ([1, 2, 3, 4], [2, 1, 3, 5]),  # mixed → 3
    ]
    a = np.asarray([x for c in cases for x in c[0]], np.int32)
    b = np.asarray([x for c in cases for x in c[1]], np.int32)
    a_off = np.cumsum([0] + [len(c[0]) for c in cases]).astype(np.int64)
    b_off = np.cumsum([0] + [len(c[1]) for c in cases]).astype(np.int64)
    out = np.empty(len(cases), np.int64)
    lib.batched_edit_distance(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(cases),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    expected = [
        _edit_distance_numpy(np.asarray(pa, np.int32), np.asarray(pb, np.int32))
        for pa, pb in cases
    ]
    return out.tolist() == expected


def _load_native():
    """Compile (if needed), load, and SELF-TEST the C kernel; None on any
    failure. A kernel that fails the self-test against the numpy DP is
    rebuilt from source once and re-tested before giving up."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        needs_build = not os.path.exists(_SO_PATH) or (
            os.path.getmtime(_SO_PATH) < os.path.getmtime(_C_SOURCE)
        )
        if needs_build:
            _build_so()
        lib = _open_so()
        if not _self_test(lib):
            logger.warning("stale native levenshtein kernel; rebuilding from source")
            _build_so()
            lib = _open_so()
            if not _self_test(lib):
                raise RuntimeError("rebuilt kernel still fails self-test")
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain dependent
        logger.warning("native levenshtein unavailable (%s); using numpy fallback", e)
        _lib = None
    return _lib


def _edit_distance_numpy(a: np.ndarray, b: np.ndarray) -> int:
    """Vectorized-row Levenshtein DP fallback."""
    na, nb = len(a), len(b)
    if na == 0:
        return nb
    if nb == 0:
        return na
    prev = np.arange(nb + 1, dtype=np.int64)
    for i in range(1, na + 1):
        curr = np.empty(nb + 1, dtype=np.int64)
        curr[0] = i
        sub = prev[:-1] + (a[i - 1] != b)
        dele = prev[1:] + 1
        best = np.minimum(sub, dele)
        # insertion needs the running prefix min — sequential but cheap
        run = curr[0]
        for j in range(nb):
            run = min(best[j], run + 1)
            curr[j + 1] = run
        prev = curr
    return int(prev[nb])


def _intern(seqs: list[list[str]]):
    """Word lists → flattened int32 ids + int64 offsets."""
    table: dict[str, int] = {}
    flat: list[int] = []
    offsets = [0]
    for words in seqs:
        for w in words:
            flat.append(table.setdefault(w, len(table)))
        offsets.append(len(flat))
    return (
        np.asarray(flat, dtype=np.int32),
        np.asarray(offsets, dtype=np.int64),
    )


def batched_word_distances(predictions: list[str], references: list[str]) -> np.ndarray:
    """Per-pair word-level edit distances."""
    if len(predictions) != len(references):
        raise ValueError("predictions and references must be the same length")
    pred_words = [p.split() for p in predictions]
    ref_words = [r.split() for r in references]
    # One shared intern table so equal words map to equal ids across lists.
    all_ids, all_off = _intern(pred_words + ref_words)
    n = len(predictions)
    a, a_off = all_ids[: all_off[n]], all_off[: n + 1]
    b = all_ids[all_off[n] :]
    b_off = all_off[n:] - all_off[n]

    out = np.empty(n, dtype=np.int64)
    lib = _load_native()
    if lib is not None and n > 0:
        lib.batched_edit_distance(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if not (out < 0).any():
            return out
    for i in range(n):
        out[i] = _edit_distance_numpy(
            a[a_off[i] : a_off[i + 1]], b[b_off[i] : b_off[i + 1]]
        )
    return out


def wer(predictions: list[str], references: list[str]) -> float:
    """Corpus-level WER: Σ edit distance / Σ reference words."""
    dists = batched_word_distances(predictions, references)
    total_ref = sum(len(r.split()) for r in references)
    if total_ref == 0:
        return 0.0 if int(dists.sum()) == 0 else float("inf")
    return float(dists.sum()) / float(total_ref)
