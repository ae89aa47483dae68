"""Host-side helpers of the training slice and the loop, copied from
``inclusivegan_tpu/utils/misc.py`` (numpy only).

``save_image_grid`` writes its PNG with ``write_png`` below and ``read_png``
reads one back (``zlib`` and ``struct``, no Pillow): the machines the port
trains on need not have it. ``parse_config_for_previous_run`` and
``apply_mirror_augment`` serve the metrics. ``open_url`` opens local paths
and ``file://`` URLs only: the port downloads nothing.
"""

import io
import os
import pickle
import re
import struct
import zlib
from typing import Any, Optional, Tuple
from urllib.parse import unquote, urlparse

import numpy as np


def format_time(seconds: float) -> str:
    """'1d 02h 03m' style elapsed-time formatting."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 86400:
        return f"{s // 3600}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // 86400}d {(s // 3600) % 24:02d}h {(s // 60) % 60:02d}m"


def is_pickleable(obj: Any) -> bool:
    try:
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        return True
    except Exception:
        return False


def adjust_dynamic_range(data, drange_in, drange_out):
    """Linear range remap, e.g. uint8 [0, 255] -> float [-1, 1], with the
    scale and bias in float32."""
    if drange_in != drange_out:
        scale = (np.float32(drange_out[1]) - np.float32(drange_out[0])) / (
            np.float32(drange_in[1]) - np.float32(drange_in[0]))
        bias = np.float32(drange_out[0]) - np.float32(drange_in[0]) * scale
        data = data * scale + bias
    return data


def slerp_np(a: np.ndarray, b: np.ndarray, t) -> np.ndarray:
    """Spherical interpolation of host latents a, b [..., D] in float64:
    inputs normalized, result re-normalized to the unit sphere, returned in
    a's dtype."""

    def normalize(v):
        return v / np.sqrt(np.sum(np.square(v), axis=-1, keepdims=True))

    a64 = normalize(a.astype(np.float64))
    b64 = normalize(b.astype(np.float64))
    d = np.clip(np.sum(a64 * b64, axis=-1, keepdims=True), -1.0, 1.0)
    p = np.asarray(t, np.float64) * np.arccos(d)
    c = normalize(b64 - d * a64)
    out = a64 * np.cos(p) + c * np.sin(p)
    return normalize(out).astype(a.dtype)


def apply_mirror_augment(minibatch: np.ndarray,
                         rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Flip a random half of an NCHW minibatch horizontally (a copy).
    ``rng=None`` draws from numpy's global stream; the metrics pass a seeded
    Generator so that cached real statistics are reproducible."""
    rand = (np.random.rand(minibatch.shape[0]) if rng is None
            else rng.random(minibatch.shape[0]))
    mask = rand < 0.5
    minibatch = np.array(minibatch)
    minibatch[mask] = minibatch[mask, :, :, ::-1]
    return minibatch


def parse_config_for_previous_run(run_dir: str) -> dict:
    """The training and dataset arguments of a run dir, from its
    ``submit_config.pkl``: {"train": the run function's keyword arguments,
    "dataset": their ``dataset_args``}. Unpickle only run dirs this project
    wrote."""
    with open(os.path.join(run_dir, "submit_config.pkl"), "rb") as f:
        sc = pickle.load(f)
    data = getattr(sc, "run_func_kwargs", {}) or {}
    return dict(train=data, dataset=data.get("dataset_args", {}))


def parse_kimg_time_from_log(log_path: str) -> Tuple[float, float]:
    """(kimg, seconds) from the last tick line of a previous run's
    ``log.txt``; (0, 0) when there is none."""
    kimg, seconds = 0.0, 0.0
    try:
        with open(log_path) as f:
            for line in f:
                m = re.search(r"kimg ([\d.]+).*time ((?:\d+d )?(?:\d+h )?(?:\d+m )?(?:\d+s)?)", line)
                if m:
                    kimg = float(m.group(1))
                    seconds = _time_to_seconds(m.group(2))
    except FileNotFoundError:
        pass
    return kimg, seconds


def _time_to_seconds(text: str) -> float:
    total = 0.0
    for value, unit in re.findall(r"(\d+)([dhms])", text):
        total += int(value) * {"d": 86400, "h": 3600, "m": 60, "s": 1}[unit]
    return total


def convert_images_from_uint8(images, drange=(-1, 1)):
    """uint8 [0, 255] -> float32 in ``drange``."""
    return adjust_dynamic_range(np.asarray(images, np.float32), [0, 255], list(drange))


def convert_images_to_uint8(images, drange=(-1, 1), nchw_to_nhwc=False):
    """float in ``drange`` -> uint8, rounded and clipped; NCHW to NHWC when
    asked."""
    img = adjust_dynamic_range(np.asarray(images, np.float32), list(drange), [0, 255])
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    if nchw_to_nhwc:
        img = np.transpose(img, (0, 2, 3, 1))
    return img


def is_url(obj: Any) -> bool:
    return isinstance(obj, str) and "://" in obj


def open_url(url: str):
    """The bytes of a local path or a ``file://`` URL as an open binary file.
    The JAX package's ``open_url`` downloads other schemes into a cache; the
    port has no network access and raises for them."""
    if is_url(url):
        parsed = urlparse(url)
        if parsed.scheme != "file":
            raise ValueError(f"open_url reads local files only, not {parsed.scheme}:// "
                             f"({url}); copy the file and pass its path")
        url = unquote(parsed.path)
    with open(url, "rb") as f:
        return io.BytesIO(f.read())


def load_pkl(path: str) -> Any:
    """Unpickle a file this project wrote (a local path or ``file://`` URL)."""
    with open_url(path) as f:
        return pickle.load(f)


def save_pkl(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def create_image_grid(images: np.ndarray, grid_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Tile [N, C, H, W] images into one [C, gh * H, gw * W] grid image,
    row by row; ``grid_size`` is (gw, gh), else the squarest grid."""
    assert images.ndim in (3, 4)
    num, img_c, img_h, img_w = images.shape
    if grid_size is not None:
        grid_w, grid_h = grid_size
    else:
        grid_w = max(int(np.ceil(np.sqrt(num))), 1)
        grid_h = max((num - 1) // grid_w + 1, 1)
    grid = np.zeros([img_c, grid_h * img_h, grid_w * img_w], dtype=images.dtype)
    for idx in range(num):
        x = (idx % grid_w) * img_w
        y = (idx // grid_w) * img_h
        grid[:, y:y + img_h, x:x + img_w] = images[idx]
    return grid


def convert_to_uint8_hwc(images: np.ndarray, drange=(-1, 1)) -> np.ndarray:
    """[C, H, W] or [N, C, H, W] float in ``drange`` -> HWC uint8 (the JAX
    package's ``convert_to_uint8_pil``)."""
    img = adjust_dynamic_range(images, drange, (0, 255))
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    if img.ndim == 3:
        return np.transpose(img, (1, 2, 0))
    return np.transpose(img, (0, 2, 3, 1))


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit greyscale ([H, W] or [H, W, 1]) or RGB ([H, W, 3]) uint8
    image as a PNG: one IDAT of zlib-compressed rows, each with filter 0."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes [H, W] or [H, W, 3] uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> channels: gray, RGB, RGBA


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth)."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, pixel by pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            # Average and Paeth refer to the byte bpp to the left, which this
            # row has just decoded: one pixel position at a time
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (line[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not 0-4")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced greyscale, RGB or RGBA PNG as uint8 [H, W] or
    [H, W, C]: the inverse of ``write_png``, for the PNGs of any writer
    (every row filter). Raises ValueError for other bit depths, palette
    images and interlaced images."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: read_png reads 8-bit non-interlaced greyscale, RGB "
                         f"or RGBA; this is bit depth {depth}, color type {color_type}, "
                         f"interlace {interlace}")
    channels = _PNG_CHANNELS[color_type]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels, channels)
    return img.reshape(h, w) if channels == 1 else img.reshape(h, w, channels)


def save_image_grid(images: np.ndarray, path: str, drange=(-1, 1), grid_size=None) -> None:
    """Tile ``images`` (float in ``drange`` or uint8 with drange [0, 255])
    into a grid and write it as a PNG."""
    write_png(path, convert_to_uint8_hwc(create_image_grid(images, grid_size), drange))
