"""Minimal dependency-free TensorBoard scalar writer.

The port's own copy of ``causaldiffae_tpu/utils/tensorboard.py``: the
TFRecord + Event protobuf wire format hand-encoded (crc32c, varints), scalars
only, which is all the KV logger emits.
"""

from __future__ import annotations

import os
import struct
import time

__all__ = ["TensorBoardWriter"]

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _len_delim(field: int, payload: bytes) -> bytes:
    return bytes([(field << 3) | 2]) + _varint(len(payload)) + payload


def _event_proto(wall_time: float, step: int, tag: str = None, value: float = None,
                 file_version: str = None) -> bytes:
    msg = struct.pack("<B", 0x09) + struct.pack("<d", wall_time)  # field 1 double
    msg += bytes([0x10]) + _varint(step & 0xFFFFFFFFFFFFFFFF)      # field 2 varint
    if file_version is not None:
        msg += _len_delim(3, file_version.encode())                # field 3 string
    if tag is not None:
        val = _len_delim(1, tag.encode())                          # Value.tag
        val += bytes([0x15]) + struct.pack("<f", value)            # Value.simple_value
        summary = _len_delim(1, val)                               # Summary.value
        msg += _len_delim(5, summary)                              # Event.summary
    return msg


class TensorBoardWriter:
    """Writes ``events.out.tfevents.*`` files readable by TensorBoard."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.causaldiffae"
        self.file = open(os.path.join(logdir, fname), "wb")
        self._write_record(_event_proto(time.time(), 0, file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self.file.write(header)
        self.file.write(struct.pack("<I", _masked_crc(header)))
        self.file.write(data)
        self.file.write(struct.pack("<I", _masked_crc(data)))
        self.file.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_event_proto(time.time(), step, tag=tag, value=float(value)))

    def writekvs(self, kvs):
        """KVWriter interface: 'step' key drives the global step."""
        step = int(kvs.get("step", 0))
        for k, v in kvs.items():
            if hasattr(v, "__float__"):
                self.add_scalar(k, float(v), step)

    def close(self):
        self.file.close()
