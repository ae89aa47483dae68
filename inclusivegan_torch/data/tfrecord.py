"""TFRecord container + tf.train.Example codec, dependency-free, copied from
``inclusivegan_tpu/data/tfrecord.py``.

Datasets are one ``<name>-r{log2res:02d}.tfrecords`` per resolution, with
Examples holding int64 'shape' and raw uint8 'data'; the format is
bit-compatible with TensorFlow's, so either side reads the other's datasets.
The CRC is computed by the native slice-by-8 library (``datakit.py``, built
with ``g++`` at first use), as in the JAX package; the pure-Python table
(``_crc32c_py``) is the plain version the tests hold it to. Records are read
without checking the CRC unless asked.

Format refresher (implemented below):
  record  := len:uint64le  crc32c(len)  payload  crc32c(payload)
  crc     := masked crc32c: ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32
  Example := message{ 1: Features{ 1: map<string, Feature> } }
  Feature := one of { 1: BytesList, 2: FloatList, 3: Int64List }
"""

import struct
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

from . import datakit

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven.
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C through the native library."""
    return datakit.crc32c(data, crc)


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """Pure-Python CRC32C: the plain version of ``crc32c``."""
    table = _crc_table()
    crc = crc ^ 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Record framing
# ---------------------------------------------------------------------------

def write_record(f, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", _masked_crc(header)))
    f.write(payload)
    f.write(struct.pack("<I", _masked_crc(payload)))


def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc = f.read(4)
            payload = f.read(length)
            pcrc = f.read(4)
            if len(payload) < length or len(pcrc) < 4:
                raise IOError(f"truncated record in {path}")
            if verify_crc:
                if struct.unpack("<I", hcrc)[0] != _masked_crc(header):
                    raise IOError(f"header crc mismatch in {path}")
                if struct.unpack("<I", pcrc)[0] != _masked_crc(payload):
                    raise IOError(f"payload crc mismatch in {path}")
            yield payload


# ---------------------------------------------------------------------------
# Minimal protobuf wire codec (only what tf.train.Example needs)
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


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _field(tag: int, wire: int, payload: bytes) -> bytes:
    return _varint((tag << 3) | wire) + payload


def _len_field(tag: int, payload: bytes) -> bytes:
    return _field(tag, 2, _varint(len(payload)) + payload)


def encode_example(features: Dict[str, Union[bytes, np.ndarray, List[int], List[float]]]) -> bytes:
    """features: name → bytes (BytesList), int array (Int64List) or float
    array (FloatList)."""
    entries = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            feature = _len_field(1, _len_field(1, value))  # BytesList.value
        else:
            arr = np.asarray(value)
            if arr.dtype.kind in "iu":
                body = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                                for v in arr.ravel())
                feature = _len_field(3, _len_field(1, body))  # Int64List packed
            elif arr.dtype.kind == "f":
                body = arr.astype("<f4").tobytes()
                feature = _len_field(2, _len_field(1, body))  # FloatList packed
            else:
                raise TypeError(f"unsupported feature dtype {arr.dtype}")
        entry = _len_field(1, name.encode()) + _len_field(2, feature)
        entries += _len_field(1, entry)  # Features.feature map entry
    return _len_field(1, entries)  # Example.features


def _parse_message(buf: bytes) -> List[Tuple[int, int, Union[int, bytes]]]:
    fields = []
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        tag, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.append((tag, wire, val))
    return fields


def decode_example(payload: bytes) -> Dict[str, Union[bytes, np.ndarray]]:
    out: Dict[str, Union[bytes, np.ndarray]] = {}
    for tag, _w, features_buf in _parse_message(payload):
        if tag != 1:
            continue
        for ftag, _fw, entry in _parse_message(features_buf):
            if ftag != 1:
                continue
            name = None
            feature_buf = b""
            for etag, _ew, val in _parse_message(entry):
                if etag == 1:
                    name = val.decode()
                elif etag == 2:
                    feature_buf = val
            for kind, _kw, list_buf in _parse_message(feature_buf):
                if kind == 1:  # BytesList
                    for t2, _w2, v2 in _parse_message(list_buf):
                        if t2 == 1:
                            out[name] = v2
                elif kind == 2:  # FloatList
                    for t2, w2, v2 in _parse_message(list_buf):
                        if t2 == 1 and w2 == 2:
                            out[name] = np.frombuffer(v2, "<f4")
                        elif t2 == 1 and w2 == 5:
                            prev = out.get(name, np.zeros((0,), "<f4"))
                            out[name] = np.concatenate(
                                [prev, np.frombuffer(v2, "<f4")])
                elif kind == 3:  # Int64List
                    vals = []
                    for t2, w2, v2 in _parse_message(list_buf):
                        if t2 == 1 and w2 == 2:  # packed
                            pos = 0
                            while pos < len(v2):
                                v, pos = _read_varint(v2, pos)
                                vals.append(np.int64(np.uint64(v)))
                        elif t2 == 1 and w2 == 0:
                            vals.append(np.int64(np.uint64(v2)))
                    out[name] = np.array(vals, np.int64)
    return out


def encode_image_example(img: np.ndarray) -> bytes:
    """Reference Example layout: int64 'shape' = [C,H,W], bytes 'data' = raw
    uint8 CHW (dataset_tool.py:76-85)."""
    assert img.dtype == np.uint8 and img.ndim == 3
    return encode_example({"shape": np.array(img.shape, np.int64),
                           "data": img.tobytes()})


def decode_image_example(payload: bytes) -> np.ndarray:
    ex = decode_example(payload)
    shape = tuple(int(v) for v in ex["shape"])
    return np.frombuffer(ex["data"], np.uint8).reshape(shape)


def load_image_records(path: str, max_images: int = None) -> np.ndarray:
    """Decode a whole image-example shard into one [N,C,H,W] uint8 array.

    Fast path for the fixed-shape shards the exporter (and the reference's
    dataset_tool.py:76-85) writes: every record then has byte-identical
    framing and Example skeleton, differing only in the 'data' payload, so
    after decoding record 0 the rest is a single strided gather instead of
    240k python protobuf parses (~100x faster at stacked-MNIST scale).
    Falls back to per-record decode for ragged shards.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 12:
        return np.zeros((0,), np.uint8)
    (plen0,) = struct.unpack_from("<Q", buf, 0)
    first = decode_image_example(buf[12:12 + plen0])
    stride = 8 + 4 + plen0 + 4
    n_total = len(buf) // stride
    uniform = len(buf) % stride == 0
    if uniform:
        # all record headers must announce the same payload length
        lens = np.frombuffer(buf, "<u8")[::stride // 8] if stride % 8 == 0 \
            else np.array([struct.unpack_from("<Q", buf, i * stride)[0]
                           for i in range(n_total)], np.uint64)
        uniform = bool((lens[:n_total] == plen0).all())
    if not uniform:
        images = []
        for payload in read_records(path):
            images.append(decode_image_example(payload))
            if max_images is not None and len(images) >= max_images:
                break
        return np.stack(images)
    n = n_total if max_images is None else min(max_images, n_total)
    # locate the raw image bytes inside the first payload: they are the
    # unique contiguous run equal to first.tobytes()
    data_off = buf.find(first.tobytes(), 12, 12 + plen0)
    assert data_off >= 0
    flat = np.frombuffer(buf, np.uint8)
    view = np.lib.stride_tricks.as_strided(
        flat[data_off:], shape=(n, first.size), strides=(stride, 1))
    out = np.ascontiguousarray(view).reshape((n,) + first.shape)
    # cross-check one non-first record against the slow decoder: catches the
    # (degenerate) case where `find` latched onto a false match inside the
    # protobuf skeleton
    if n > 1:
        k = n - 1
        check = decode_image_example(
            bytes(buf[k * stride + 12:k * stride + 12 + plen0]))
        if check.shape != first.shape or not np.array_equal(out[k], check):
            images = [decode_image_example(p)
                      for i, p in zip(range(n), read_records(path))]
            return np.stack(images)
    return out
