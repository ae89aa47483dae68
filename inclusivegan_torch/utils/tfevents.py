"""Minimal TensorBoard event-file writer, dependency-free, copied from
``inclusivegan_tpu/utils/tfevents.py``.

Writes ``events.out.tfevents.*`` on top of the port's TFRecord framing and
protobuf codec (``data/tfrecord.py``), so runs are TensorBoard-browsable
without TensorFlow.

Wire format: each record is an Event proto
  Event { 1: wall_time (double)  2: step (int64)  5: Summary }
  Summary { 1: repeated Value { 1: tag (string)  2: simple_value (float) } }
plus the mandatory first record {wall_time, file_version="brain.Event:2"}.
"""

import os
import socket
import struct
import time
from typing import Dict

from ..data.tfrecord import _field, _len_field, _varint, write_record


def _double_field(tag: int, value: float) -> bytes:
    return _field(tag, 1, struct.pack("<d", value))


def _float_field(tag: int, value: float) -> bytes:
    return _field(tag, 5, struct.pack("<f", value))


def _int_field(tag: int, value: int) -> bytes:
    return _field(tag, 0, _varint(value & 0xFFFFFFFFFFFFFFFF))


class EventWriter:
    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}{filename_suffix}")
        self._f = open(os.path.join(log_dir, name), "wb")
        # version header event
        payload = _double_field(1, time.time()) + _len_field(
            3, b"brain.Event:2")
        write_record(self._f, payload)
        self._f.flush()

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        values = b""
        for tag, value in scalars.items():
            v = _len_field(1, tag.encode()) + _float_field(2, float(value))
            values += _len_field(1, v)
        event = (_double_field(1, time.time()) + _int_field(2, step) +
                 _len_field(5, values))
        write_record(self._f, event)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
