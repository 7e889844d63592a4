"""FLAC decoder (16-bit-era subset): native C kernel + numpy fallback.

The upstream LibriSpeech distribution is FLAC; the reference decodes it
with torchaudio (reference: src/training_utils/build.py:118-133). In
this build's environment neither torchaudio-backends nor ``soundfile``
exist, so ``data/datasets.py`` falls back to this module. Decoding runs
in a C kernel (``csrc/flacdec.c``, ~200× the Python path — corpus
ingestion at reference scale is hours vs minutes) compiled on first use
into ``build/paa_tpu_torch/``
and self-tested against the pure-numpy decoder below, which remains the
fallback and the behavioral oracle. Both cover the
encodings stock LibriSpeech (and anything produced by the reference
``flac`` encoder at default settings) actually uses:

  * STREAMINFO metadata + arbitrary other metadata blocks (skipped)
  * frames with any blocksize coding (fixed or variable strategy)
  * CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes
  * Rice residuals, both 4-bit (method 0) and 5-bit (method 1) params,
    escape partitions, all partition orders
  * wasted-bits, 8/12/16/20/24-bit samples, independent channels and all
    three stereo decorrelation modes (left/side, right/side, mid/side)

CRCs (frame header CRC-8 / footer CRC-16 / STREAMINFO md5) are parsed
but NOT verified — this is a decode path for trusted local corpora, not
a validator. Anything outside the subset raises ``FlacError`` so the
caller's error gate (convert to WAV / install soundfile) still applies.

FIXED subframes reconstruct via vectorized cumulative sums (a FIXED
residual is the order-th integer difference); LPC runs the integer
recurrence in Python (exactness requires the spec's arithmetic
right-shift; clips are seconds long so this stays well under a second).
"""

from __future__ import annotations

import base64
import ctypes
import logging
import os
import subprocess
import tempfile

import numpy as np

from paa_tpu_torch.ops.kernels._lib import BUILD_DIR, CSRC

logger = logging.getLogger(__name__)


class FlacError(ValueError):
    """Stream uses a feature outside the supported subset (or is corrupt)."""


_BLOCKSIZE_FROM_CODE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384,
    15: 32768,
}
_SAMPLE_SIZE_FROM_CODE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _BitReader:
    """MSB-first bit reader over a byte buffer, with O(log n) unary reads
    via a precomputed set-bit index."""

    def __init__(self, data: bytes):
        self._bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self._ones = np.flatnonzero(self._bits)
        self.pos = 0
        self._w64 = (1 << np.arange(63, -1, -1)).astype(np.uint64)

    def read(self, n: int) -> int:
        """Read n (< 64) bits as an unsigned int."""
        if n == 0:  # _w64[-0:] would be the whole weight vector
            return 0
        b = self._bits[self.pos : self.pos + n]
        if len(b) < n:
            raise FlacError("unexpected end of stream")
        self.pos += n
        return int(b.astype(np.uint64) @ self._w64[-n:])

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def unary(self) -> int:
        """Count zero bits until (and consuming) the next 1 bit."""
        i = np.searchsorted(self._ones, self.pos)
        if i >= len(self._ones):
            raise FlacError("unexpected end of stream in unary code")
        j = int(self._ones[i])
        q = j - self.pos
        self.pos = j + 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) // 8 * 8

    @property
    def remaining_bits(self) -> int:
        return len(self._bits) - self.pos


def _read_utf8_number(br: _BitReader) -> int:
    """The frame header's UTF-8-style coded frame/sample number."""
    first = br.read(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    if n_extra < 1 or n_extra > 6:
        raise FlacError("invalid UTF-8 coded number in frame header")
    val = first & (mask - 1)
    for _ in range(n_extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("invalid UTF-8 continuation in frame header")
        val = (val << 6) | (b & 0x3F)
    return val


def _read_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual coding method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    n_part = 1 << po
    if blocksize % n_part:
        raise FlacError("partition order does not divide blocksize")
    out = np.empty(blocksize - order, dtype=np.int64)
    w = 0
    for part in range(n_part):
        n = blocksize // n_part - (order if part == 0 else 0)
        if n < 0:
            raise FlacError("predictor order exceeds first partition")
        param = br.read(plen)
        if param == escape:
            raw = br.read(5)
            for k in range(n):
                out[w + k] = br.read_signed(raw) if raw else 0
        else:
            for k in range(n):
                q = br.unary()
                v = (q << param) | (br.read(param) if param else 0)
                # zigzag: even → v/2, odd → -(v+1)/2
                out[w + k] = (v >> 1) ^ -(v & 1)
        w += n
    return out


def _fixed_restore(warmup: np.ndarray, res: np.ndarray, order: int) -> np.ndarray:
    """Invert the order-th difference with cumulative sums (exact in
    int64; FIXED predictors are repeated integer differencing)."""
    if order == 0:
        return res.copy()
    cur = res
    for o in range(order, 0, -1):
        seed = np.diff(warmup, n=o - 1)[-1]
        cur = np.concatenate([[seed], cur]).cumsum()[1:]
    return np.concatenate([warmup, cur])


def _lpc_restore(
    warmup: np.ndarray, res: np.ndarray, coefs: list[int], shift: int
) -> np.ndarray:
    order = len(coefs)
    x = [int(v) for v in warmup]
    rev = list(reversed(coefs))  # rev[j] multiplies x[n-order+j]
    for r in res:
        acc = 0
        hist = x[-order:]
        for c, h in zip(rev, hist):
            acc += c * h
        x.append((acc >> shift) + int(r))
    return np.asarray(x, dtype=np.int64)


def _read_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise FlacError("subframe sync bit set")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.unary() + 1
        if wasted >= bps:
            raise FlacError(f"wasted bits {wasted} >= sample size {bps}")
        bps -= wasted

    if ftype == 0:  # CONSTANT
        out = np.full(blocksize, br.read_signed(bps), dtype=np.int64)
    elif ftype == 1:  # VERBATIM
        out = np.fromiter(
            (br.read_signed(bps) for _ in range(blocksize)), np.int64, blocksize
        )
    elif 8 <= ftype <= 12:  # FIXED, order 0-4
        order = ftype - 8
        warmup = np.fromiter(
            (br.read_signed(bps) for _ in range(order)), np.int64, order
        )
        res = _read_residual(br, blocksize, order)
        out = _fixed_restore(warmup, res, order)
    elif ftype >= 32:  # LPC, order 1-32
        order = ftype - 31
        warmup = np.fromiter(
            (br.read_signed(bps) for _ in range(order)), np.int64, order
        )
        precision = br.read(4) + 1
        if precision == 16:
            raise FlacError("invalid LPC coefficient precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _read_residual(br, blocksize, order)
        out = _lpc_restore(warmup, res, coefs, shift)
    else:
        raise FlacError(f"reserved subframe type {ftype}")

    return out << wasted if wasted else out


# -- native decode path -----------------------------------------------------
#
# The same subset implemented in C (csrc/flacdec.c), compiled on first
# use and SELF-TESTED against this module's Python decoder; any load or
# decode failure falls back to the Python path (which owns the precise
# FlacError messages). tests/test_flac.py runs every fixture stream
# through BOTH decoders and asserts bit-identical output.

_BUILD_DIR = str(BUILD_DIR)
_C_SOURCE = str(CSRC / "flacdec.c")
_SO_PATH = os.path.join(_BUILD_DIR, "_flacdec.so")

_lib = None
_lib_tried = False


def _build_so():
    # build inside the destination dir: os.replace from /tmp on another
    # filesystem raises EXDEV and would silently disable the kernel
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
        tmp_so = os.path.join(td, "_flacdec.so")
        subprocess.run(
            ["cc", "-O3", "-shared", "-fPIC", "-o", tmp_so, _C_SOURCE],
            check=True,
            capture_output=True,
        )
        os.replace(tmp_so, _SO_PATH)


def _open_so():
    lib = ctypes.CDLL(_SO_PATH)
    lib.flac_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.flac_decode.restype = ctypes.c_int64
    lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.flac_free.restype = None
    return lib


def _native_call(lib, data: bytes):
    """One native decode → ((total, channels) int32, rate) or None on any
    nonzero return code."""
    out_ptr = ctypes.POINTER(ctypes.c_int32)()
    frames = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    bps = ctypes.c_int32()
    rc = lib.flac_decode(
        data, len(data), ctypes.byref(out_ptr), ctypes.byref(frames),
        ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bps),
    )
    if rc != 0:
        return None
    try:
        n, c = frames.value, channels.value
        arr = np.ctypeslib.as_array(out_ptr, shape=(n, c)).copy()
    finally:
        lib.flac_free(out_ptr)
    return arr, int(rate.value)


# Golden parity streams for the native-kernel self-test: one stream per
# subset feature the C decoder implements (FIXED+Rice, LPC, escape
# partitions, the three stereo decorrelation modes, wasted bits, and a
# multiframe CONSTANT/VERBATIM mix). Generated once with the byte-exact
# fixture writers in tests/test_flac.py; decode_flac_py is the oracle at
# check time, so the constant pins only the ENCODED bytes, not expected
# PCM. A VERBATIM-only probe (encode_flac emits nothing else) would let a
# stale cached .so with a broken LPC/Rice/stereo path pass the self-test.
_GOLDEN_PARITY_B64 = (
    "AAAAaGZMYUOAAAAiEAAQAAAAAAAAAAPoAPAAAAAwAAAAAAAAAAAAAAAAAAAAAP/4cAAAAC8AFAAj"
    "AC0BMEhEhgH2zEwewAIh4UA6BoDYwMAjbIWDICwL2pydw87HvTYGATLgUA6AgVD+wAAAAAAEKGZM"
    "YUOAAAAiEAAQAAAAAAAAAAPoAPAAAABAAAAAAAAAAAAAAAAAAAAAAP/4cAAAAD8AQgAACjXVmMnN"
    "0AgAAAAAAAAAAAAAAAAAAAJAAAAAAAAAAAAAAAAAAAAAAAAAAOAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAGgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAeAAAAAAAAAAAAAAAAAAAAAAAAAAAAAACwAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAKAAAAAAAAAAAAAAAAAAAABIAAAAAAAAAAAALAAADwAAAAATAAAAAAAAA"
    "AAAAAFwAAAAAAAAAAAAAAAAAAAAAFQAAAAAAAAAAAAAAAAAAAAAAAAAAAVAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAVAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAABEAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "IgAAAAAAAAAAAAAAAAAAAAAAAATAAAAAAAAAAAAAAAAAARAAAAAAAAAC4iAAAAAAAAHAAAAAAAAA"
    "AAAAAAAACAAAAAAAAAAAAAAAAAAAAAAAABQAAAAAAAAAAAAAAAAAAAAAAAAAAAAAgAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAGgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAADgAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAABoAAAAAAAAAAAAAAAAAAAAAAHgAAAAAAAAAAAAAABQAAAAAANAADYAAAAAAAAAAAVAAAAAA"
    "AAAAAAAAAAAAAD4AAAAAAAAAAAAAAAAAAAAAAAAADIAAAAAAAAAAAAAAAAAAAAAAAAAAAAABcAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAGwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAmAAAAAAAAAAAAAAA"
    "AAAAAAAAAAACIAAAAAAAAAAAAAAAAAAAA+AAAAAAAAAAAAEwAABsAAAAALAAAAAAAAAAAAAADQAA"
    "AAAAAAAAAAAAAAAAAAADAAAAAAAAAAAAAAAAAAAAAAAAAAAAMAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAMAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAoAAAAAAAAAAAAAAAAAAAAAAAAAAAAAFAAAAAAAA"
    "AAAAAAAAAAAAAAAAALAAAAAAAAAAAAAAAAAAKAAAAAAAAABoUAAAAAAAADIAAAAAAAAAAAAAAAAD"
    "oAAAAAAAAAAAAAAAAAAAAAAABEAAAAAAAAAAAAAAAAAAAAAAAAAAAAB0AAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAALgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAGQAAAAAAAAAAAAAAAAAAAAAAAAAAAC4AA"
    "AAAAAAAAAAAAAAAAAAAANgAAAAAAAAAAAAAACIAAAAAAXAAAAAAAcGZMYUOAAAAiEAAQAAAAAAAA"
    "AAPoAPAAAAAgAAAAAAAAAAAAAAAAAAAAAP/4cAAAAB8AEv8jA93M2DUC6o49wPirINn9E+e/oiCR"
    "+EIc18Ve+JdPhVAqoL6YR91gXvqtkEPUGDvcNRMwGpes3AWAAAAAAAC6ZkxhQ4AAACIQABAAAAAA"
    "AAAAA+gC8AAAACAAAAAAAAAAAAAAAAAAAAAA//hwgAAAHwACBDni8zocL4rYxwE5NvgrZBn9EXbG"
    "wx44/LDM7+APBSQcWQD4Dh4uahdA7qgR5wxFzwfI6BQF8fQMSunh3bTURgIJg+7aSM+j6c563xWI"
    "iOIgJRDHARV5saDPn7Zm24dN7jDLClKCG4P75O+CecfrZ9JEPq/tYmObu3LhWUJOx1GkNNntOQAA"
    "AAAAumZMYUOAAAAiEAAQAAAAAAAAAAPoAvAAAAAgAAAAAAAAAAAAAAAAAAAAAP/4cJAAAB8AAgmD"
    "7tpIz6PpznrfFYiI4iAlEMcBFXmxoM+ftmbbh03uMMsKUoIbg/vk74J5x+tn0kQ+r+1iY5u7cuFZ"
    "Qk7HUaQ02e05AvEyJ4rzn/DuCWw71/KHCz/4bw0h+TYRPwXkFg45GNRZB7T4iu4/33LICPPPKMXN"
    "lvRDOno4btxgwnIVeMNI5w0AAAAAALpmTGFDgAAAIhAAEAAAAAAAAAAD6ALwAAAAIAAAAAAAAAAA"
    "AAAAAAAAAAD/+HCgAAAfAAL6tQU+Ft0QPPEZHogUvxtRCTYPS9/8F7sBSvF+DJPsvhIG/MH+Lgbu"
    "76TxOx1W7O3hpQGxJjnnKude/6zQft2pAgmD7tpIz6PpznrfFYiI4iAlEMcBFXmxoM+ftmbbh03u"
    "MMsKUoIbg/vk74J5x+tn0kQ+r+1iY5u7cuFZQk7HUaQ02e05AAAAAABqZkxhQ4AAACIQABAAAAAA"
    "AAAAA+gA8AAAACAAAAAAAAAAAAAAAAAAAAAA//hwAAAAHwADP/D/j/y/5/9P+v/b/v/4/8/+v/f/"
    "z/7/+//gAAAIAIAGAEACgBgA4AgASAKAFgDABoA4AeAAAAAAAGJmTGFDgAAAIhAAEAAAAAAAAAAD"
    "6ADwAAAAMAAAAAAAAAAAAAAAAAAAAAD/+HAAAAAfAAD/swAA//hwAAEADwAC//0Bdv5oAKIAIf6P"
    "AVkBWf/uAbwAagGTAcwARf8k/p0AAA=="
)


def _golden_parity_streams() -> list[bytes]:
    blob = base64.b64decode(_GOLDEN_PARITY_B64)
    streams, off = [], 0
    while off < len(blob):
        n = int.from_bytes(blob[off : off + 4], "big")
        off += 4
        streams.append(blob[off : off + n])
        off += n
    return streams


def _self_test(lib) -> bool:
    """The native decoder must reproduce the Python decoder on every
    subset feature (an mtime check cannot prove a cached .so matches the
    current flacdec.c). Probes: an encode_flac stream (real CRC framing,
    VERBATIM) plus the golden streams above (FIXED/LPC/Rice-escape/
    stereo/wasted-bits/multiframe — the paths real LibriSpeech uses)."""
    ramp = (np.arange(-500, 500, dtype=np.int16) * 7).astype(np.int16)
    for stream in [encode_flac(ramp, 16000), *_golden_parity_streams()]:
        want, want_sr = decode_flac_py(stream)
        got = _native_call(lib, stream)
        if got is None:
            return False
        arr, sr = got
        if not (
            sr == want_sr and arr.shape == want.shape and bool((arr == want).all())
        ):
            return False
    return True


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        needs_build = not os.path.exists(_SO_PATH) or (
            os.path.exists(_C_SOURCE)
            and os.path.getmtime(_SO_PATH) < os.path.getmtime(_C_SOURCE)
        )
        if needs_build:
            _build_so()
        # A cached/committed .so can fail at CDLL time (other arch/libc) or
        # at self-test time (stale vs flacdec.c) — both get one rebuild.
        try:
            lib = _open_so()
            ok = _self_test(lib)
        except OSError:
            lib, ok = None, False
        if not ok:
            logger.warning("cached native FLAC decoder unusable; rebuilding")
            _build_so()
            lib = _open_so()
            if not _self_test(lib):
                raise RuntimeError("rebuilt decoder still fails self-test")
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain dependent
        logger.warning("native FLAC decoder unavailable (%s); using numpy path", e)
        _lib = None
    return _lib


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a FLAC byte stream → ``((total, channels) int32, rate)``.

    Tries the C kernel first (~100× the Python path on LPC-heavy
    streams); any native failure — unsupported feature, corruption, or
    no toolchain — falls through to :func:`decode_flac_py`, which raises
    the precise :class:`FlacError` for genuinely bad streams.
    """
    lib = _load_native()
    if lib is not None:
        out = _native_call(lib, bytes(data))
        if out is not None:
            return out
    return decode_flac_py(data)


def decode_flac_py(data: bytes) -> tuple[np.ndarray, int]:
    """Pure-numpy decode (the behavioral oracle for the C kernel)."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    streaminfo = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:
            streaminfo = body
        pos += 4 + length
        if last:
            break
    if streaminfo is None or len(streaminfo) < 34:
        raise FlacError("missing STREAMINFO")

    si = _BitReader(streaminfo)
    si.read(16)  # min blocksize
    si.read(16)  # max blocksize
    si.read(24)  # min framesize
    si.read(24)  # max framesize
    sample_rate = si.read(20)
    channels = si.read(3) + 1
    bps_stream = si.read(5) + 1
    total_samples = si.read(36)
    if sample_rate == 0:
        raise FlacError("invalid sample rate 0")
    if bps_stream not in (8, 12, 16, 20, 24):
        raise FlacError(f"unsupported bits-per-sample {bps_stream}")

    br = _BitReader(data[pos:])
    blocks: list[np.ndarray] = []
    decoded = 0
    while (total_samples == 0 or decoded < total_samples) and br.remaining_bits >= 16:
        sync = br.read(14)
        if sync != 0b11111111111110:
            raise FlacError(f"lost frame sync at bit {br.pos - 14}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_assign = br.read(4)
        ss_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_number(br)
        if bs_code == 0:
            raise FlacError("reserved blocksize code 0")
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_FROM_CODE[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise FlacError("invalid sample-rate code 15")
        bps = _SAMPLE_SIZE_FROM_CODE.get(ss_code, bps_stream)
        br.read(8)  # header CRC-8 (not verified)

        if ch_assign < 8:
            if ch_assign + 1 != channels:
                raise FlacError("frame channel count != STREAMINFO")
            chans = [_read_subframe(br, blocksize, bps) for _ in range(channels)]
        elif ch_assign in (8, 9, 10):
            if channels != 2:
                raise FlacError("stereo decorrelation in non-stereo stream")
            # the SIDE channel carries one extra bit
            if ch_assign == 8:  # left/side
                left = _read_subframe(br, blocksize, bps)
                side = _read_subframe(br, blocksize, bps + 1)
                right = left - side
            elif ch_assign == 9:  # right/side
                side = _read_subframe(br, blocksize, bps + 1)
                right = _read_subframe(br, blocksize, bps)
                left = right + side
            else:  # mid/side
                mid = _read_subframe(br, blocksize, bps)
                side = _read_subframe(br, blocksize, bps + 1)
                m2 = (mid << 1) | (side & 1)
                left = (m2 + side) >> 1
                right = (m2 - side) >> 1
            chans = [left, right]
        else:
            raise FlacError(f"reserved channel assignment {ch_assign}")

        br.align()
        br.read(16)  # frame CRC-16 (not verified)
        blocks.append(np.stack(chans, axis=1))
        decoded += blocksize

    if not blocks:
        raise FlacError("no audio frames")
    out = np.concatenate(blocks, axis=0)
    if total_samples:
        out = out[:total_samples]
    return out.astype(np.int32), sample_rate


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file → (mono float32 in [-1, 1), sample_rate) — the
    same contract as ``datasets._read_wav``."""
    with open(path, "rb") as f:
        data = f.read()
    pcm, sr = decode_flac(data)
    # infer full-scale from STREAMINFO bps by re-reading is overkill —
    # normalize by the observed stream's declared bps via the max int
    # container: stock LibriSpeech is 16-bit, and decode_flac validated
    # bps ∈ {8,12,16,20,24}; recover it from the stream header cheaply.
    bps = _stream_bps(data)
    x = pcm.astype(np.float32) / float(1 << (bps - 1))
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, int(sr)


def _stream_bps(data: bytes) -> int:
    """bits-per-sample from STREAMINFO (bits 103..107 of the block body),
    walking the metadata chain exactly like decode_flac_py — STREAMINFO
    need not be the first block, and assuming a fixed byte offset would
    silently mis-scale streams the decoder itself accepts."""
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        if (hdr & 0x7F) == 0:
            body = data[pos + 4 : pos + 4 + length]
            if len(body) < 18:
                raise FlacError("missing STREAMINFO")
            return (((body[12] & 0x01) << 4) | (body[13] >> 4)) + 1
        pos += 4 + length
        if hdr & 0x80:
            raise FlacError("missing STREAMINFO")


# ---------------------------------------------------------------------------
# Encoder (16-bit VERBATIM subset)
#
# Enough of the format to WRITE valid streams: fixed 4096-sample blocks,
# independent channels, VERBATIM subframes, real CRC-8/CRC-16 footers —
# so the output decodes with any compliant decoder (not just ours).
# Used to materialize stock-format LibriSpeech-layout corpora for
# end-to-end runs and tests (the reference consumes FLAC LibriSpeech
# out of the box, reference: src/training_utils/build.py:118-133).
# ---------------------------------------------------------------------------

_ENC_BLOCK = 4096


class _BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def write(self, value: int, n: int) -> None:
        self._bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def write_signed(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def align(self) -> None:
        while len(self._bits) % 8:
            self._bits.append(0)

    def tobytes(self) -> bytes:
        self.align()
        return np.packbits(np.asarray(self._bits, dtype=np.uint8)).tobytes()


def _crc_table(poly: int, width: int) -> list[int]:
    mask, top = (1 << width) - 1, 1 << (width - 1)
    table = []
    for b in range(256):
        crc = b << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly if crc & top else crc << 1) & mask
        table.append(crc)
    return table


_CRC8_TABLE = _crc_table(0x07, 8)  # x^8+x^2+x+1, the frame-header CRC
_CRC16_TABLE = _crc_table(0x8005, 16)  # x^16+x^15+x^2+1, the frame footer


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


def _utf8_frame_number(idx: int) -> bytes:
    """The frame header's UTF-8-style coded number (frame index here,
    since we write fixed-blocksize streams)."""
    if idx < 0x80:
        return bytes([idx])
    out = []
    n_extra = 1
    while idx >= (1 << (6 - n_extra)) << (6 * n_extra):
        n_extra += 1
        if n_extra > 6:
            raise FlacError("frame index too large to encode")
    lead_mask = (0xFF << (7 - n_extra)) & 0xFF
    out.append(lead_mask | (idx >> (6 * n_extra)))
    for k in range(n_extra - 1, -1, -1):
        out.append(0x80 | ((idx >> (6 * k)) & 0x3F))
    return bytes(out)


def _encode_frame(pcm: np.ndarray, frame_idx: int) -> bytes:
    """One fixed-strategy frame of ``(blocksize, channels)`` int16 PCM,
    independent channels, VERBATIM subframes."""
    blocksize, channels = pcm.shape
    hdr = _BitWriter()
    hdr.write(0b11111111111110, 14)  # sync
    hdr.write(0, 1)  # reserved
    hdr.write(0, 1)  # fixed blocksize strategy
    hdr.write(7, 4)  # blocksize: 16-bit value at end of header
    hdr.write(0, 4)  # sample rate: from STREAMINFO
    hdr.write(channels - 1, 4)  # independent channels
    hdr.write(4, 3)  # 16 bits per sample
    hdr.write(0, 1)  # reserved
    header = hdr.tobytes() + _utf8_frame_number(frame_idx)
    bs = _BitWriter()
    bs.write(blocksize - 1, 16)
    header += bs.tobytes()
    header += bytes([_crc8(header)])

    # The header ends byte-aligned and each 16-bit VERBATIM subframe is a
    # whole number of bytes, so sample data can be emitted directly as
    # big-endian int16 after the 1-byte subframe header (0|000001|0).
    body = b"".join(
        b"\x02" + pcm[:, c].astype(">i2").tobytes() for c in range(channels)
    )
    frame = header + body
    return frame + _crc16(frame).to_bytes(2, "big")


def encode_flac(x: np.ndarray, sample_rate: int) -> bytes:
    """Encode PCM → a valid 16-bit FLAC byte stream.

    ``x`` is float in [-1, 1] (scaled to int16) or an integer array
    (used as int16 directly); shape ``(T,)`` or ``(T, channels)``.
    """
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int64)
    else:
        pcm = x.astype(np.int64)
        if pcm.min() < -32768 or pcm.max() > 32767:
            raise FlacError("integer input exceeds the int16 range")
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    total, channels = pcm.shape
    if not 1 <= channels <= 8:
        raise FlacError(f"unsupported channel count {channels}")
    if total == 0:
        raise FlacError("cannot encode an empty signal")

    si = _BitWriter()
    si.write(_ENC_BLOCK, 16)  # min blocksize
    si.write(_ENC_BLOCK, 16)  # max blocksize
    si.write(0, 24)  # min framesize unknown
    si.write(0, 24)  # max framesize unknown
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(15, 5)  # bps - 1
    si.write(total, 36)
    streaminfo = si.tobytes() + b"\x00" * 16  # md5 unset (optional)
    out = [b"fLaC", bytes([0x80]), len(streaminfo).to_bytes(3, "big"), streaminfo]
    for i, start in enumerate(range(0, total, _ENC_BLOCK)):
        out.append(_encode_frame(pcm[start : start + _ENC_BLOCK], i))
    return b"".join(out)


def write_flac(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write ``x`` (same conventions as :func:`encode_flac`) to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_flac(x, sample_rate))
