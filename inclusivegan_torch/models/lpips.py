"""LPIPS perceptual distance (VGG16 trunk, five taps, linear heads), ported
from ``inclusivegan_tpu/models/lpips.py``.

Parameters are a dict of tensors in the JAX package's layout, with conv
weights turned to OIHW: ``{"_mode": 0|1|2, "conv1_1": {"w", "b"}, ...,
"lin_conv1_2": [C], ...}``. Mode 1 is converted weights
(``load_lpips_params``), mode 2 the pixel-pyramid fallback, which has no conv
leaves. The trunk runs in the ``dtype`` the caller asks for (float32 by
default, bfloat16 with the training loop's ``--dtype bfloat16``); its tap
maps are channel-normalized in float32 (``norm="f32"``, the default) or, with
``norm="trunk"``, in the trunk's dtype with a float32 sum of squares
(``_normalize_channels_trunk_dtype``), as in the JAX package.
"""

import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .stylegan2 import compute_dtype

# (name, out_channels, pool_before): the VGG16 conv layout.
_VGG_LAYOUT: List[Tuple[str, int, bool]] = [
    ("conv1_1", 64, False), ("conv1_2", 64, False),
    ("conv2_1", 128, True), ("conv2_2", 128, False),
    ("conv3_1", 256, True), ("conv3_2", 256, False), ("conv3_3", 256, False),
    ("conv4_1", 512, True), ("conv4_2", 512, False), ("conv4_3", 512, False),
    ("conv5_1", 512, True), ("conv5_2", 512, False), ("conv5_3", 512, False),
]
_TAPS = ["conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"]
# Input normalization of the LPIPS net, in the [-1, 1] domain.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
_PIXEL_SCALES = 5
_PIXEL_CALIBRATION = 1.0  # divided by the scale count in the lin heads

# The drop-in location of converted weights, as in the JAX package.
DEFAULT_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "metrics_weights", "vgg16_zhang_perceptual.npz")

Params = Dict[str, Any]


def lpips_params_from_numpy(tree: Dict[str, Any], device="cuda") -> Params:
    """A JAX LPIPS parameter tree (numpy leaves, conv ``w`` as [3, 3, I, O])
    as the port's parameters on ``device``."""
    params: Params = {"_mode": int(np.asarray(tree["_mode"]))}
    for key, value in tree.items():
        if key == "_mode":
            continue
        if isinstance(value, dict):
            w = torch.from_numpy(np.array(value["w"], np.float32))
            params[key] = {"w": w.permute(3, 2, 0, 1).contiguous().to(device),
                           "b": torch.from_numpy(np.array(value["b"], np.float32)).to(device)}
        else:
            params[key] = torch.from_numpy(np.array(value, np.float32)).to(device)
    return params


def init_pixel_fallback_params(device="cuda") -> Params:
    """Multi-scale pixel-MSE params: uniform heads, no conv leaves."""
    params: Params = {"_mode": 2}
    for tap in _TAPS[:_PIXEL_SCALES]:
        params[f"lin_{tap}"] = torch.full((3,), _PIXEL_CALIBRATION / _PIXEL_SCALES,
                                          dtype=torch.float32, device=device)
    return params


def load_lpips_params(path: str, device="cuda") -> Params:
    """Converted weights: an npz with keys '<conv>_w', '<conv>_b', 'lin_<tap>'."""
    data = np.load(path)
    tree: Dict[str, Any] = {"_mode": np.array(1)}
    for name, _c, _p in _VGG_LAYOUT:
        tree[name] = {"w": data[f"{name}_w"], "b": data[f"{name}_b"]}
    for tap in _TAPS:
        tree[f"lin_{tap}"] = data[f"lin_{tap}"]
    return lpips_params_from_numpy(tree, device)


def get_lpips_params(weights_path: Optional[str] = None, device="cuda") -> Params:
    """Converted weights when available, else the pixel-pyramid fallback.
    With no path, the INCLUSIVEGAN_LPIPS_WEIGHTS environment variable (empty
    forces the fallback), then ``DEFAULT_WEIGHTS_PATH``, are tried."""
    if weights_path is None:
        env = os.environ.get("INCLUSIVEGAN_LPIPS_WEIGHTS")
        if env is not None:
            weights_path = env or None
        elif os.path.exists(DEFAULT_WEIGHTS_PATH):
            weights_path = DEFAULT_WEIGHTS_PATH
    if weights_path and os.path.exists(weights_path):
        print(f'LPIPS: loading weights from "{weights_path}"')
        return load_lpips_params(weights_path, device)
    print("LPIPS: pixel-pyramid fallback (no converted weights found)")
    return init_pixel_fallback_params(device)


def _vgg_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x [N, 3, H, W] in the normalized domain -> the five tap activations."""
    feats = []
    for name, _cout, pool in _VGG_LAYOUT:
        if pool:
            x = F.max_pool2d(x, 2, 2)
        p = params[name]
        x = F.conv2d(x, p["w"].to(x.dtype), padding=1)
        x = torch.clamp_min(x + p["b"][None, :, None, None].to(x.dtype), 0)
        if name in _TAPS:
            feats.append(x)
    return feats


def _normalize_channels(x, eps=1e-10):
    return x * torch.rsqrt(x.square().sum(dim=1, keepdim=True) + eps)


def _normalize_channels_trunk_dtype(x, eps=1e-10):
    """Channel normalization that keeps the map in its own dtype: the sum
    of squares in float32, the scale applied in ``x``'s dtype."""
    ss = x.float().square().sum(dim=1, keepdim=True)
    return x * torch.rsqrt(ss + eps).to(x.dtype)


def _preprocess(img_255):
    """[0, 255] RGB -> the LPIPS net's input domain; other channel counts
    are broadcast to RGB."""
    x = img_255.float() / 127.5 - 1.0
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    elif x.shape[1] != 3:
        x = x.mean(dim=1, keepdim=True).repeat(1, 3, 1, 1)
    shift = torch.from_numpy(_SHIFT).to(x.device)[None, :, None, None]
    scale = torch.from_numpy(_SCALE).to(x.device)[None, :, None, None]
    return (x - shift) / scale


def _pixel_pyramid(x) -> List[torch.Tensor]:
    """[-1, 1] images -> [x, avgpool2(x), avgpool4(x), ...], raw; with fewer
    than 5 levels (inputs under 16 px) each level is scaled by
    sqrt(5 / levels) to keep the calibrated scale."""
    feats = [x]
    levels = min(_PIXEL_SCALES, int(min(x.shape[2], x.shape[3])).bit_length())
    for _ in range(levels - 1):
        x = F.avg_pool2d(x, 2, 2)
        feats.append(x)
    if levels < _PIXEL_SCALES:
        feats = [f * math.sqrt(_PIXEL_SCALES / levels) for f in feats]
    return feats


def lpips_features(params: Params, img_255: torch.Tensor, dtype=torch.float32,
                   norm: Optional[str] = None) -> List[torch.Tensor]:
    """[N, C, H, W] in [0, 255] -> the tap feature maps: channel-normalized
    VGG activations, or, in the pixel-fallback mode, the raw pyramid.
    ``dtype``: the VGG trunk's compute dtype (a torch dtype, a name or None
    for float32). ``norm``: "f32" (None) normalizes float32 copies of the
    tap maps; "trunk" keeps them in the trunk's dtype."""
    if "conv1_1" not in params:
        x = img_255.float() / 127.5 - 1.0
        if x.shape[1] != 3:
            x = x.mean(dim=1, keepdim=True).repeat(1, 3, 1, 1)
        return _pixel_pyramid(x)
    dtype = compute_dtype(dtype)
    x = _preprocess(img_255)
    feats = _vgg_features(params, x.to(dtype))
    if dtype != torch.float32 and norm == "trunk":
        return [_normalize_channels_trunk_dtype(f) for f in feats]
    return [_normalize_channels(f.float()) for f in feats]


def lpips_distance_from_features(params: Params, f0, f1) -> torch.Tensor:
    total = 0.0
    for tap, a, b in zip(_TAPS, f0, f1):
        d = (a - b).square()
        lin = params[f"lin_{tap}"][None, :, None, None]
        total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
    return total


def lpips_distance(params: Params, img0_255, img1_255, dtype=torch.float32,
                   norm: Optional[str] = None) -> torch.Tensor:
    """Perceptual distance per pair: [N, C, H, W] in [0, 255] -> [N]
    (float32); ``dtype`` and ``norm`` as for ``lpips_features``."""
    return lpips_distance_from_features(
        params, lpips_features(params, img0_255, dtype, norm),
        lpips_features(params, img1_255, dtype, norm))
