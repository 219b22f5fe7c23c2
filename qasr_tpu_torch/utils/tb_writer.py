"""Minimal TensorBoard event-file writer, no tensorboard package needed
(port of qasr_tpu/utils/tb_writer.py, host only).  The tfevents wire
format is produced directly:

  record  = [len: uint64 LE][masked crc32c(len)] [payload] [masked crc32c(payload)]
  payload = Event protobuf:  wall_time(1: double), step(2: int64),
            file_version(3: string) | summary(5: Summary)
  Summary.Value = tag(1: string), simple_value(2: float)

Scalars written here open in stock TensorBoard.  The protobuf encoding is
hand-rolled (three message types, all tiny); crc32c is the table-based
Castagnoli polynomial with TF's rotate-and-add masking.
"""
from __future__ import annotations

import os
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-based, with TensorFlow's masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# protobuf wire-format helpers (varint + the three fields we need)
# ---------------------------------------------------------------------------


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


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


class TBWriter:
    """Append-only scalar event writer (SummaryWriter.add_scalar analogue)."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.qasr{filename_suffix}"
        self._f = open(os.path.join(log_dir, name), "ab")
        self.path = self._f.name
        # file-version header event
        self._write_event(_pb_double(1, time.time()) +
                          _pb_bytes(3, b"brain.Event:2"))

    def _write_event(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        # Summary.Value{tag=1, simple_value=2} inside Summary{value=1}
        summary_value = (_pb_bytes(1, tag.encode("utf-8")) +
                         _pb_float(2, float(value)))
        summary = _pb_bytes(1, summary_value)
        # Event{wall_time=1, step=2, summary=5}
        event = (_pb_double(1, wall_time if wall_time is not None
                            else time.time()) +
                 _pb_int64(2, int(step)) +
                 _pb_bytes(5, summary))
        self._write_event(event)

    def close(self) -> None:
        self._f.close()
