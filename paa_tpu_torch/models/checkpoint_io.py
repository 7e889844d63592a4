"""Torch-free checkpoint ingestion: safetensors + pytorch_model.bin readers.

The reference obtains its frozen ASR target through
``transformers.from_pretrained`` (reference: src/training_utils/
build.py:225-231), which needs torch + network (or a populated HF cache).
The attack itself never needs torch — only the *weights*. This module
reads the two on-disk formats HF checkpoints ship in using nothing but
numpy and the stdlib, so the moment a weights file is placed in the
environment the quality numbers of BASELINE.md can be reproduced without
any torch/transformers/network dependency:

  * ``model.safetensors`` — 8-byte little-endian header length, JSON
    header mapping tensor name → {dtype, shape, data_offsets}, then a
    flat byte buffer.  (The format is deliberately trivial.)
  * ``pytorch_model.bin`` — a zip archive holding ``data.pkl`` (a pickle
    of the state_dict whose tensors are persistent-id references) plus
    one raw little-endian storage blob per tensor under ``data/<key>``.
    Parsed with a *restricted* unpickler: only the handful of symbols a
    plain tensor state_dict needs are allowed; anything else raises.

Both return ``dict[str, np.ndarray]`` ready for
``models/convert.convert_hf_state_dict``. bfloat16 tensors are upcast to
float32 exactly (bit-shift); fp16 likewise.
"""

from __future__ import annotations

import collections
import io
import json
import os
import pickle
import struct
import zipfile

import numpy as np

# -- safetensors -------------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    # BF16 handled specially (numpy has no bfloat16)
}


def _bf16_bytes_to_f32(raw: bytes) -> np.ndarray:
    """Exact bfloat16 → float32 upcast via a 16-bit left shift."""
    u16 = np.frombuffer(raw, dtype="<u2")
    return (u16.astype(np.uint32) << 16).view(np.float32)


def load_safetensors(path: str) -> dict[str, np.ndarray]:
    """Read a ``.safetensors`` file into ``{name: np.ndarray}``."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len).decode("utf-8"))
        blob = f.read()

    out: dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = blob[start:end]
        dt = meta["dtype"]
        if dt == "BF16":
            arr = _bf16_bytes_to_f32(raw)
        elif dt in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(raw, dtype=np.dtype(_SAFETENSORS_DTYPES[dt]).newbyteorder("<"))
        else:
            raise ValueError(f"Unsupported safetensors dtype {dt!r} for {name!r}")
        out[name] = arr.reshape(meta["shape"]).copy()
    return out


def save_safetensors(path: str, tensors: dict) -> None:
    """Minimal safetensors writer (float32/float16/int32/int64 + bf16-as-f32).

    Used by tests and as an export utility; the format round-trips through
    ``load_safetensors``.
    """
    rev = {np.dtype(v): k for k, v in _SAFETENSORS_DTYPES.items()}
    header: dict = {}
    chunks: list[bytes] = []
    offset = 0
    for name, x in tensors.items():
        x = np.ascontiguousarray(np.asarray(x))
        if x.dtype not in rev:
            raise ValueError(f"Unsupported dtype {x.dtype} for {name!r}")
        raw = x.astype(x.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {
            "dtype": rev[x.dtype],
            "shape": list(x.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        chunks.append(raw)
        offset += len(raw)
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for c in chunks:
            f.write(c)


# -- pytorch_model.bin (zip + restricted pickle) ------------------------------

# torch storage class name → numpy dtype of the raw little-endian blob.
_TORCH_STORAGE_DTYPES = {
    "DoubleStorage": np.float64,
    "FloatStorage": np.float32,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
    "BFloat16Storage": "bfloat16",  # handled specially
}


class _StorageRef:
    """Lazy handle to one raw storage blob inside the zip archive."""

    __slots__ = ("dtype_name", "key")

    def __init__(self, dtype_name: str, key: str):
        self.dtype_name = dtype_name
        self.key = key


class _StorageType:
    """Stand-in for ``torch.FloatStorage`` etc. — only the name matters."""

    def __init__(self, name: str):
        self.name = name


def _rebuild_tensor(storage_arr: np.ndarray, offset: int, size, stride) -> np.ndarray:
    """numpy equivalent of ``torch._utils._rebuild_tensor_v2``.

    ``stride`` is in elements (torch convention); a non-contiguous save is
    materialized via as_strided + copy.
    """
    size = tuple(int(s) for s in size)
    if not size:
        return storage_arr[offset : offset + 1].copy().reshape(())
    stride = tuple(int(s) for s in stride)
    contiguous = []
    acc = 1
    for s in reversed(size):
        contiguous.append(acc)
        acc *= s
    if stride == tuple(reversed(contiguous)):
        n = int(np.prod(size))
        return storage_arr[offset : offset + n].reshape(size).copy()
    itemsize = storage_arr.itemsize
    byte_strides = tuple(s * itemsize for s in stride)
    view = np.lib.stride_tricks.as_strided(
        storage_arr[offset:], shape=size, strides=byte_strides
    )
    return view.copy()


class _RestrictedUnpickler(pickle.Unpickler):
    """Unpickles a plain tensor state_dict and NOTHING else.

    Allowed symbols: OrderedDict, the torch storage classes, and the two
    tensor-rebuild helpers. Any other global is rejected — a weights file
    is untrusted input and must not execute arbitrary reduce callables.
    """

    def __init__(self, data: bytes, storages: dict[str, bytes]):
        super().__init__(io.BytesIO(data))
        self._storages = storages

    def persistent_load(self, pid):
        # ('storage', storage_type, key, location, numel)
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"Unsupported persistent id: {pid!r}")
        storage_type, key = pid[1], pid[2]
        name = storage_type.name if isinstance(storage_type, _StorageType) else str(storage_type)
        if name not in _TORCH_STORAGE_DTYPES:
            raise pickle.UnpicklingError(f"Unsupported storage type: {name}")
        return _StorageRef(name, str(key))

    def _materialize(self, ref: _StorageRef) -> np.ndarray:
        raw = self._storages[ref.key]
        dt = _TORCH_STORAGE_DTYPES[ref.dtype_name]
        if dt == "bfloat16":
            return _bf16_bytes_to_f32(raw)
        return np.frombuffer(raw, dtype=np.dtype(dt).newbyteorder("<"))

    def find_class(self, module, name):
        if (module, name) == ("collections", "OrderedDict"):
            return collections.OrderedDict
        if module == "torch" and name in _TORCH_STORAGE_DTYPES:
            return _StorageType(name)
        if module == "torch._utils" and name in (
            "_rebuild_tensor_v2",
            "_rebuild_parameter",
        ):
            if name == "_rebuild_parameter":
                return lambda data, requires_grad=False, hooks=None: data
            unpickler = self

            def rebuild_tensor_v2(storage, offset, size, stride, *_ignored):
                return _rebuild_tensor(
                    unpickler._materialize(storage), int(offset), size, stride
                )

            return rebuild_tensor_v2
        raise pickle.UnpicklingError(
            f"Blocked unpickling of {module}.{name} — only plain tensor "
            "state_dicts are supported"
        )


def load_torch_bin(path: str) -> dict[str, np.ndarray]:
    """Read a torch zip-format checkpoint (``torch.save`` default since 1.6)
    into ``{name: np.ndarray}`` with no torch dependency."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl_entries = [n for n in names if n.endswith("data.pkl")]
        if not pkl_entries:
            raise ValueError(
                f"{path!r} is a zip but holds no data.pkl — not a torch "
                "checkpoint (legacy pre-1.6 tar format is unsupported)"
            )
        pkl_name = pkl_entries[0]
        prefix = pkl_name[: -len("data.pkl")]
        storages = {
            n[len(prefix) + len("data/") :]: zf.read(n)
            for n in names
            if n.startswith(prefix + "data/")
        }
        obj = _RestrictedUnpickler(zf.read(pkl_name), storages).load()
    if not isinstance(obj, dict):
        raise ValueError(f"Expected a state_dict in {path!r}, got {type(obj)}")
    out = {}
    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            out[str(k)] = v
    return out


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Dispatch on the on-disk format (safetensors vs torch zip)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:4] == b"PK\x03\x04":
        return load_torch_bin(path)
    # safetensors: first 8 bytes are a plausible little-endian header
    # length and the next byte opens a JSON object
    (n,) = struct.unpack("<Q", magic)
    size = os.path.getsize(path)
    if 0 < n < size:
        with open(path, "rb") as f:
            f.seek(8)
            if f.read(1) in (b"{", b" "):
                return load_safetensors(path)
    raise ValueError(
        f"Unrecognized checkpoint format: {path!r} (expected .safetensors "
        "or torch zip .bin)"
    )
