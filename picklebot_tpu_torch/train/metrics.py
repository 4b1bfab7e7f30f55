"""TensorBoard scalars without TensorBoard: a tfevents writer, and windowed
averages.

The port's own copy of ``picklebot_tpu/train/metrics.py``: protobuf framing
(varint-encoded Event/Summary messages) and CRC32C record checksums written
directly, so the training path imports no tensorflow or tensorboard. Files
are readable by standard TensorBoard. The trainer logs under the
reference's tag names ("training loss", "training accuracy", "val loss",
"val accuracy") plus "learning rate" and "grad norm", against a monotone
global step. ``windowed_average`` is the reference's get_average: means
over chunks of 1000 with a ragged tail.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional, Sequence

import numpy as np

# CRC32C (Castagnoli), table-driven: the TFRecord framing's checksum

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# minimal protobuf encoding of tensorflow.Event / Summary

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


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _encode_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _encode_int64(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _encode_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    inner = _encode_bytes(1, tag.encode()) + _encode_float(2, value)
    return _encode_bytes(1, inner)  # Summary.value (field 1)


def _event(wall_time: float, step: int, *,
           summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    msg = _encode_double(1, wall_time) + _encode_int64(2, step)
    if file_version is not None:
        msg += _encode_bytes(3, file_version.encode())
    if summary is not None:
        msg += _encode_bytes(5, summary)
    return msg


class SummaryWriter:
    """Scalar-only tfevents writer: add_scalar / flush / close."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}.picklebot."
                 f"{os.getpid()}")
        self._path = os.path.join(logdir, fname)
        self._fh = open(self._path, "wb")
        self._write_record(_event(time.time(), 0,
                                  file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(data)
        self._fh.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_event(time.time(), int(step),
                                  summary=_summary_value(tag, float(value))))
        # flush per record (~60 bytes each): a live TensorBoard sees the
        # run as it goes, and a crash loses no buffered tail
        self._fh.flush()

    def flush(self):
        self._fh.flush()

    def close(self):
        self._fh.flush()
        self._fh.close()


def windowed_average(values: Sequence[float],
                     window_size: int = 1000) -> np.ndarray:
    """Chunk means + the ragged tail's mean."""
    values = np.asarray(values, np.float64)
    n = len(values)
    if n == 0:
        return np.zeros((0,))
    partial = n % window_size
    if partial:
        head = values[:n - partial].reshape(-1, window_size).mean(1) \
            if n > partial else np.zeros((0,))
        tail = values[n - partial:].mean(keepdims=True)
        return np.concatenate([head, tail])
    return values.reshape(-1, window_size).mean(1)
