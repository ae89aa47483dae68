"""InceptionV3 pool_3 features and its 1008-way softmax head, ported from
``inclusivegan_tpu/models/inception.py``: the FID and IS embedder.

The architecture is the JAX package's table of 94 BasicConvs (a convolution
without bias, batch normalization with ``scale=False`` and eps 1e-3, ReLU),
the VALID 3/2 max pools and the SAME 3x3 average pools that divide by the
number of cells inside the image. Inputs of another size than 299 are
resized to 299x299 bilinearly with half-pixel centres, as
``jax.image.resize`` does it: plain interpolation when it enlarges, a
triangle filter widened by the scale (antialiasing) when it shrinks.

Weights: an npz of ``<path>.w`` [kh, kw, Cin, Cout], ``<path>.beta``,
``<path>.mean`` and ``<path>.var`` per BasicConv, plus ``logits.w`` and
``logits.b`` (``scripts/convert_inception_weights.py`` writes it). The
repository holds none, so without a path the network is a seeded
random-feature embedder (mode ``"random-features"``, which the metrics tag
``_random_features`` / ``_random_classifier``). Its seeded draws come from a
``torch.Generator`` with the JAX package's distributions, not its stream, so
its checksum differs from the JAX net's; ``inception_params_from_numpy``
carries the JAX net's parameters across, and with them its checksum.
"""

import hashlib
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
INPUT_SIZE = 299

Params = Dict[str, torch.Tensor]


def conv_table() -> List[Tuple[str, int, int, Tuple[int, int], int, Tuple[int, int]]]:
    """Every BasicConv: (name, cin, cout, (kh, kw), stride, (pad_h, pad_w))."""
    out = []

    def c(name, cin, cout, k, stride=1, pad=0):
        k = (k, k) if isinstance(k, int) else tuple(k)
        pad = (pad, pad) if isinstance(pad, int) else tuple(pad)
        out.append((name, cin, cout, k, stride, pad))

    c("Conv2d_1a_3x3", 3, 32, 3, stride=2)
    c("Conv2d_2a_3x3", 32, 32, 3)
    c("Conv2d_2b_3x3", 32, 64, 3, pad=1)
    c("Conv2d_3b_1x1", 64, 80, 1)
    c("Conv2d_4a_3x3", 80, 192, 3)
    for name, cin, pf in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                          ("Mixed_5d", 288, 64)):
        c(f"{name}.branch1x1", cin, 64, 1)
        c(f"{name}.branch5x5_1", cin, 48, 1)
        c(f"{name}.branch5x5_2", 48, 64, 5, pad=2)
        c(f"{name}.branch3x3dbl_1", cin, 64, 1)
        c(f"{name}.branch3x3dbl_2", 64, 96, 3, pad=1)
        c(f"{name}.branch3x3dbl_3", 96, 96, 3, pad=1)
        c(f"{name}.branch_pool", cin, pf, 1)
    c("Mixed_6a.branch3x3", 288, 384, 3, stride=2)
    c("Mixed_6a.branch3x3dbl_1", 288, 64, 1)
    c("Mixed_6a.branch3x3dbl_2", 64, 96, 3, pad=1)
    c("Mixed_6a.branch3x3dbl_3", 96, 96, 3, stride=2)
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        c(f"{name}.branch1x1", 768, 192, 1)
        c(f"{name}.branch7x7_1", 768, c7, 1)
        c(f"{name}.branch7x7_2", c7, c7, (1, 7), pad=(0, 3))
        c(f"{name}.branch7x7_3", c7, 192, (7, 1), pad=(3, 0))
        c(f"{name}.branch7x7dbl_1", 768, c7, 1)
        c(f"{name}.branch7x7dbl_2", c7, c7, (7, 1), pad=(3, 0))
        c(f"{name}.branch7x7dbl_3", c7, c7, (1, 7), pad=(0, 3))
        c(f"{name}.branch7x7dbl_4", c7, c7, (7, 1), pad=(3, 0))
        c(f"{name}.branch7x7dbl_5", c7, 192, (1, 7), pad=(0, 3))
        c(f"{name}.branch_pool", 768, 192, 1)
    c("Mixed_7a.branch3x3_1", 768, 192, 1)
    c("Mixed_7a.branch3x3_2", 192, 320, 3, stride=2)
    c("Mixed_7a.branch7x7x3_1", 768, 192, 1)
    c("Mixed_7a.branch7x7x3_2", 192, 192, (1, 7), pad=(0, 3))
    c("Mixed_7a.branch7x7x3_3", 192, 192, (7, 1), pad=(3, 0))
    c("Mixed_7a.branch7x7x3_4", 192, 192, 3, stride=2)
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        c(f"{name}.branch1x1", cin, 320, 1)
        c(f"{name}.branch3x3_1", cin, 384, 1)
        c(f"{name}.branch3x3_2a", 384, 384, (1, 3), pad=(0, 1))
        c(f"{name}.branch3x3_2b", 384, 384, (3, 1), pad=(1, 0))
        c(f"{name}.branch3x3dbl_1", cin, 448, 1)
        c(f"{name}.branch3x3dbl_2", 448, 384, 3, pad=1)
        c(f"{name}.branch3x3dbl_3a", 384, 384, (1, 3), pad=(0, 1))
        c(f"{name}.branch3x3dbl_3b", 384, 384, (3, 1), pad=(1, 0))
        c(f"{name}.branch_pool", cin, 192, 1)
    return out


def random_numpy_params(seed: int = 0, num_logits: int = 1008) -> Dict[str, np.ndarray]:
    """Seeded parameters in the npz layout, from a CPU ``torch.Generator``
    (the same values on every device): conv weights N(0, 2 / fan_in), BN
    beta and mean 0, var 1; the head's weights N(0, 0.02^2), bias 0."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, cin, cout, (kh, kw), _s, _p in conv_table():
        std = math.sqrt(2.0 / (kh * kw * cin))
        params[f"{name}.w"] = (torch.randn((kh, kw, cin, cout), generator=gen)
                               * std).numpy()
        params[f"{name}.beta"] = np.zeros((cout,), np.float32)
        params[f"{name}.mean"] = np.zeros((cout,), np.float32)
        params[f"{name}.var"] = np.ones((cout,), np.float32)
    params["logits.w"] = (torch.randn((2048, num_logits), generator=gen) * 0.02).numpy()
    params["logits.b"] = np.zeros((num_logits,), np.float32)
    return params


def checksum(tree: Dict[str, np.ndarray]) -> str:
    """The JAX package's checksum: md5 over the first 256 bytes of each
    parameter in the npz layout, by sorted name."""
    h = hashlib.md5()
    for k in sorted(tree):
        h.update(np.asarray(tree[k]).tobytes()[:256])
    return h.hexdigest()[:12]


def inception_params_from_numpy(tree: Dict[str, np.ndarray], device="cuda") -> Params:
    """Parameters in the npz layout (the JAX net's ``params`` as numpy) as
    the port's tensors on ``device``: conv weights to OIHW, the rest as is."""
    out = {}
    for k, v in tree.items():
        t = torch.from_numpy(np.array(v, np.float32))
        if k.endswith(".w") and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t.to(device)
    return out


def resize_bilinear(x: torch.Tensor, size: int = INPUT_SIZE) -> torch.Tensor:
    """``jax.image.resize(x, (N, C, size, size), "bilinear")``: half-pixel
    centres; antialiased along an axis that shrinks."""
    shrink = x.shape[2] > size or x.shape[3] > size
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=shrink)


class InceptionV3:
    """Functional InceptionV3 over a dict of tensors on one device. Call it
    on [N, C, H, W] images in [0, 255] (numpy or a tensor) for the pool_3
    features [N, 2048] as numpy float32; ``softmax_probs`` gives the head's
    class probabilities. The network computes in its parameters' dtype."""

    feature_dim = 2048
    label = "InceptionV3"

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0,
                 num_logits: int = 1008, device="cuda", params=None,
                 mode: str = "pretrained"):
        """Weights from ``params`` (numpy, the npz layout, whose ``mode``
        the caller states), else from ``weights_path``, else seeded."""
        if params is not None:
            tree, self.mode = params, mode
        elif weights_path and os.path.exists(weights_path):
            tree, self.mode = dict(np.load(weights_path)), "pretrained"
        else:
            tree, self.mode = random_numpy_params(seed, num_logits), "random-features"
        self.num_logits = int(np.shape(tree["logits.b"])[0])
        self.device = torch.device(device)
        self._checksum = checksum(tree)
        self.params = inception_params_from_numpy(tree, self.device)
        self._convs = {name: (stride, pad)
                       for name, _i, _o, _k, stride, pad in conv_table()}

    def checksum(self) -> str:
        return self._checksum

    def _bconv(self, x, name):
        p = self.params
        stride, pad = self._convs[name]
        y = F.conv2d(x, p[f"{name}.w"], stride=stride, padding=pad)
        inv = torch.rsqrt(p[f"{name}.var"] + BN_EPS)
        y = (y - p[f"{name}.mean"][None, :, None, None]) * inv[None, :, None, None] \
            + p[f"{name}.beta"][None, :, None, None]
        return torch.clamp_min(y, 0.0)

    @staticmethod
    def _maxpool(x):
        return F.max_pool2d(x, 3, 2)

    @staticmethod
    def _avgpool_same(x):
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)

    def features(self, img_255: torch.Tensor) -> torch.Tensor:
        """[N, C, H, W] in [0, 255] on the net's device -> pool_3 [N, 2048]."""
        bc = self._bconv
        x = img_255.to(self.params["logits.w"].dtype)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        if x.shape[2] != INPUT_SIZE:
            x = resize_bilinear(x)
        x = x / 127.5 - 1.0
        x = bc(x, "Conv2d_1a_3x3")
        x = bc(x, "Conv2d_2a_3x3")
        x = bc(x, "Conv2d_2b_3x3")
        x = self._maxpool(x)
        x = bc(x, "Conv2d_3b_1x1")
        x = bc(x, "Conv2d_4a_3x3")
        x = self._maxpool(x)
        for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = torch.cat([
                bc(x, f"{n}.branch1x1"),
                bc(bc(x, f"{n}.branch5x5_1"), f"{n}.branch5x5_2"),
                bc(bc(bc(x, f"{n}.branch3x3dbl_1"), f"{n}.branch3x3dbl_2"),
                   f"{n}.branch3x3dbl_3"),
                bc(self._avgpool_same(x), f"{n}.branch_pool")], dim=1)
        x = torch.cat([
            bc(x, "Mixed_6a.branch3x3"),
            bc(bc(bc(x, "Mixed_6a.branch3x3dbl_1"), "Mixed_6a.branch3x3dbl_2"),
               "Mixed_6a.branch3x3dbl_3"),
            self._maxpool(x)], dim=1)
        for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            b2 = bc(bc(bc(x, f"{n}.branch7x7_1"), f"{n}.branch7x7_2"),
                    f"{n}.branch7x7_3")
            b3 = bc(x, f"{n}.branch7x7dbl_1")
            for i in range(2, 6):
                b3 = bc(b3, f"{n}.branch7x7dbl_{i}")
            x = torch.cat([bc(x, f"{n}.branch1x1"), b2, b3,
                           bc(self._avgpool_same(x), f"{n}.branch_pool")], dim=1)
        b1 = bc(bc(x, "Mixed_7a.branch3x3_1"), "Mixed_7a.branch3x3_2")
        b2 = bc(x, "Mixed_7a.branch7x7x3_1")
        for i in range(2, 5):
            b2 = bc(b2, f"Mixed_7a.branch7x7x3_{i}")
        x = torch.cat([b1, b2, self._maxpool(x)], dim=1)
        for n in ("Mixed_7b", "Mixed_7c"):
            b2 = bc(x, f"{n}.branch3x3_1")
            b3 = bc(bc(x, f"{n}.branch3x3dbl_1"), f"{n}.branch3x3dbl_2")
            x = torch.cat([
                bc(x, f"{n}.branch1x1"),
                bc(b2, f"{n}.branch3x3_2a"), bc(b2, f"{n}.branch3x3_2b"),
                bc(b3, f"{n}.branch3x3dbl_3a"), bc(b3, f"{n}.branch3x3dbl_3b"),
                bc(self._avgpool_same(x), f"{n}.branch_pool")], dim=1)
        return x.mean(dim=(2, 3))

    def _input(self, images_255) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images_255) if not torch.is_tensor(images_255)
                               else images_255).to(self.device)

    def __call__(self, images_255) -> np.ndarray:
        with torch.no_grad():
            return self.features(self._input(images_255)).float().cpu().numpy()

    def softmax_probs(self, images_255) -> np.ndarray:
        with torch.no_grad():
            feats = self.features(self._input(images_255))
            logits = feats @ self.params["logits.w"] + self.params["logits.b"]
            return torch.softmax(logits, dim=-1).float().cpu().numpy()
