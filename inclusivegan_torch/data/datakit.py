"""ctypes binding of the native data kernels (``csrc/datakit.cpp``, the JAX
package's source): slice-by-8 CRC32C, TFRecord framing and file scanning.
``data/tfrecord.py`` computes its CRCs through ``crc32c``; the framing and
scanning entry points are reached through ``get_lib()``. The library is built with
``g++`` at first use into ``build/datakit/<key>/`` (``dci/build.py``); a
failed build raises, where the JAX package falls back to Python.
"""

import ctypes
from pathlib import Path

from ..dci.build import build_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "datakit.cpp"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-march=native")
_LIB = None


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library("datakit", [SOURCE], [], FLAGS)))
        p, l = ctypes.c_void_p, ctypes.c_long
        lib.dk_crc32c.restype = ctypes.c_uint
        lib.dk_crc32c.argtypes = [ctypes.c_char_p, l, ctypes.c_uint]
        lib.dk_write_record.restype = ctypes.c_int
        lib.dk_write_record.argtypes = [ctypes.c_char_p, ctypes.c_char_p, l]
        lib.dk_frame_records.restype = l
        lib.dk_frame_records.argtypes = [ctypes.c_char_p, p, l, p]
        lib.dk_scan_records.restype = l
        lib.dk_scan_records.argtypes = [ctypes.c_char_p, p, p, l, ctypes.c_int]
        _LIB = lib
    return _LIB


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, finalized."""
    return int(get_lib().dk_crc32c(data, len(data), crc))
