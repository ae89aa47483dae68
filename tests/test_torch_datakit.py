"""The port's native data kit (inclusivegan_torch.data.datakit) against the
pure-Python CRC32C and writer it replaces (``tfrecord._crc32c_py``), and
against the JAX package's library, the four cases of tests/test_datakit.py;
and the TFRecord writer's bytes against the JAX package's."""

import ctypes
import io
import os

import numpy as np
import pytest

from inclusivegan_torch.data import datakit, tfrecord


def test_crc32c_matches_python():
    r = np.random.RandomState(0)
    for n in (0, 1, 7, 8, 9, 63, 1024, 100_000):
        data = r.bytes(n)
        assert datakit.crc32c(data) == tfrecord._crc32c_py(data) == tfrecord.crc32c(data), n
    assert datakit.crc32c(b"123456789") == 0xE3069283


def test_crc32c_streaming():
    """The API finalizes: each call is a single shot, whose value the
    Python CRC and the JAX package's library agree on."""
    from inclusivegan_tpu.data import datakit as jdatakit
    data = os.urandom(10_000)
    for part in (data, data[:4000]):
        assert datakit.crc32c(part) == tfrecord._crc32c_py(part) == jdatakit.crc32c(part)


def _frame(payload: bytes) -> bytes:
    lib = datakit.get_lib()
    sizes = np.array([len(payload)], np.int64)
    out = ctypes.create_string_buffer(len(payload) + 16)
    n = lib.dk_frame_records(payload, sizes.ctypes.data_as(ctypes.c_void_p), 1, out)
    return out.raw[:n]


def _scan(path: str, max_records: int):
    offsets = np.zeros(max_records, np.int64)
    lengths = np.zeros(max_records, np.int64)
    n = datakit.get_lib().dk_scan_records(path.encode(),
                                          offsets.ctypes.data_as(ctypes.c_void_p),
                                          lengths.ctypes.data_as(ctypes.c_void_p),
                                          max_records, 1)
    return n, offsets, lengths


def test_frame_record_matches_python_writer():
    from inclusivegan_tpu.data import tfrecord as jtfrecord
    payload = os.urandom(5000)
    ours, theirs = io.BytesIO(), io.BytesIO()
    tfrecord.write_record(ours, payload)
    jtfrecord.write_record(theirs, payload)
    assert _frame(payload) == ours.getvalue() == theirs.getvalue()


def test_scan_records(tmp_path):
    path = str(tmp_path / "scan.rec")
    payloads = [os.urandom(n) for n in (10, 1000, 77)]
    with open(path, "wb") as f:
        for p in payloads:
            tfrecord.write_record(f, p)
    n, offsets, lengths = _scan(path, 10)
    assert n == 3
    blob = open(path, "rb").read()
    for i, p in enumerate(payloads):
        assert blob[offsets[i]:offsets[i] + lengths[i]] == p
    assert list(tfrecord.read_records(path, verify_crc=True)) == payloads
    with open(path, "r+b") as f:  # a flipped payload byte fails the check
        f.seek(int(offsets[1]) + 5)
        f.write(bytes([blob[int(offsets[1]) + 5] ^ 1]))
    assert _scan(path, 10)[0] < 0
    with pytest.raises(IOError, match="crc mismatch"):
        list(tfrecord.read_records(path, verify_crc=True))
