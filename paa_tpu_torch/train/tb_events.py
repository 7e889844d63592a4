"""Dependency-free TensorBoard scalar event writer.

The reference *intends* TensorBoard logging but ships a phantom: it
imports ``training_utils.tensor_board_logging`` which does not exist on
disk, comments out the call, and sets an unused ``args.tensorboard_logger``
path (reference: src/run_attack.py:6,245-251, src/training_utils/
build.py:255 — SURVEY.md §5.5). This module makes that integration real
without adding a dependency: it writes the TFRecord event-file format
(`events.out.tfevents.*`) by hand — masked-CRC32C framing + the few
protobuf fields a scalar ``Event`` needs — so any stock TensorBoard can
point at a run dir. Verified byte-compatible against the real
TensorBoard reader in tests (tests/test_tb_events.py) when that package
happens to be installed; the writer itself imports nothing beyond the
stdlib.

Wire format per record::

    uint64 length (LE) | uint32 masked_crc32c(length_bytes) |
    payload           | uint32 masked_crc32c(payload)

Payload = ``tensorflow.Event`` protobuf. Fields used:
  Event:   1 wall_time (double) | 2 step (int64) |
           3 file_version (string, first record only) | 5 summary
  Summary: 1 repeated Value
  Value:   1 tag (string) | 2 simple_value (float)
"""

from __future__ import annotations

import os
import socket
import struct
import time

# -- CRC32C (Castagnoli), software table ------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf writers ------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value & (1 << 64) - 1)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, val)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


class EventWriter:
    """Append-only scalar writer for one TensorBoard event file."""

    def __init__(self, logdir: str, wall_time: float | None = None):
        os.makedirs(logdir, exist_ok=True)
        t = wall_time if wall_time is not None else time.time()
        name = f"events.out.tfevents.{int(t)}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        # version header record, required by readers
        self._record(_field_double(1, t) + _field_bytes(3, b"brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int,
               wall_time: float | None = None) -> None:
        t = wall_time if wall_time is not None else time.time()
        self._record(_scalar_event(tag, value, step, t))

    def scalars(self, metrics: dict, step: int,
                wall_time: float | None = None) -> None:
        """One record per (tag, value); None values are skipped."""
        for tag, value in metrics.items():
            if value is None:
                continue
            self.scalar(tag, float(value), step, wall_time)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
