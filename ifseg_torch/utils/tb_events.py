"""A TensorBoard event file writer of scalars, with no TensorBoard package.

The progress bar's TensorBoard mirror (``utils/progress.py``) writes through
it: the JAX package writes with ``tensorboardX``, which the card's machine
does not have.  The file is what TensorBoard reads:

  - TFRecord framing: each record is its length as a little-endian u64, the
    masked CRC-32C of those 8 bytes, the data, and the masked CRC-32C of the
    data (masked: the CRC rotated right by 15 bits plus 0xa282ead8);
  - the data is a serialized ``tensorflow.Event``: first one whose
    ``file_version`` is ``brain.Event:2``, then one per scalar with
    ``wall_time``, ``step`` and ``summary { value { tag, simple_value } }``;
  - the file is ``events.out.tfevents.<seconds>.<host>`` in the log dir.

The protocol-buffer fields are written by hand (field numbers from
tensorflow/core/util/event.proto and framework/summary.proto).
"""

import os
import socket
import struct
import time
from typing import Optional


def _crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def frame(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, the data's masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # int64 fields: two's complement, as protobuf writes them
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def event(wall_time: float, step: int = 0, file_version: Optional[str] = None,
          tag: Optional[str] = None, value: Optional[float] = None) -> bytes:
    """A serialized ``Event``: ``wall_time`` (1, double), ``step`` (2,
    int64), and ``file_version`` (3) or ``summary`` (5) holding one
    ``Summary.Value`` with ``tag`` (1) and ``simple_value`` (2, float)."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if tag is not None:
        val = _bytes_field(1, tag.encode()) + _varint(2 << 3 | 5) + struct.pack("<f", value)
        out += _bytes_field(5, _bytes_field(1, val))
    return out


class EventFileWriter:
    """Scalars into one event file of ``logdir``, each record flushed as it
    is written."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}")
        self._fp = open(self.path, "ab")
        self._write(event(now, file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        self._fp.write(frame(data))
        self._fp.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(event(time.time(), int(step), tag=tag, value=float(value)))

    def close(self) -> None:
        self._fp.close()
