"""Host-side helpers of the training slice, copied from
``inclusivegan_tpu/utils/misc.py`` (numpy only)."""

import numpy as np


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
