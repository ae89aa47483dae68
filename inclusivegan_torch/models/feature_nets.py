"""The metrics' feature nets, ported from
``inclusivegan_tpu/models/feature_nets.py``.

- ``VGGFeatureNet``: the LPIPS VGG16 trunk (``models/lpips.py``), each of
  its five taps globally average-pooled and concatenated to 1472 dimensions;
  the embedder of FID's ``feature_net="vgg"`` and of ``pr50k3``. Converted
  weights from an npz, else seeded random features (mode
  ``"random-features"``).
- ``StackedMNISTClassifier``: per channel of a stacked-MNIST image, two
  conv + ReLU + 2x2 max-pool blocks and two dense layers; the mode is
  ``d_R + 10 d_G + 100 d_B``. For ``mode_counts`` and ``KL``.
- ``CelebAAttrClassifier``: four stride-2 SAME 3x3 convs with lrelu 0.2, a
  global pool, two dense layers and a sigmoid over 40 attributes; the
  scorer of ``ls``.

The classifiers read the same npz files, from the same default paths and
under the same environment variables as the JAX package. Without them each
warns and takes a seeded random init: JAX's distributions from a CPU
``torch.Generator``, not its stream. ``*_params_from_numpy`` carry the JAX
package's parameters across (conv weights [kh, kw, I, O] turned to OIHW,
dense weights [I, O] kept). Each net runs on the device it was built for,
``cuda`` unless the caller passes ``device="cpu"``, in float32.
"""

import hashlib
import math
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .lpips import (_preprocess, _vgg_features, lpips_params_from_numpy, random_lpips_tree,
                    read_lpips_tree)

Params = Dict[str, Dict[str, torch.Tensor]]


def _as_tensor(images, device) -> torch.Tensor:
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.asarray(images))
    return images.to(device)


def _checksum(tree) -> str:
    """The JAX package's checksum: md5 over the first 1024 bytes of each
    leaf, in ``jax.tree_util.tree_leaves`` order (sorted keys)."""
    h = hashlib.md5()

    def walk(node):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k])
            else:
                h.update(np.asarray(node[k]).tobytes()[:1024])
    walk(tree)
    return h.hexdigest()[:12]


def _layers_from_numpy(tree, names, device) -> Params:
    out = {}
    for name in names:
        w = torch.from_numpy(np.array(tree[name]["w"], np.float32))
        if w.ndim == 4:
            w = w.permute(3, 2, 0, 1).contiguous()
        out[name] = {"w": w.to(device),
                     "b": torch.from_numpy(np.array(tree[name]["b"], np.float32)).to(device)}
    return out


def _he_tree(shapes: Dict[str, tuple], seed: int):
    """N(0, 2 / fan_in) weights and zero biases in the JAX layout, from a
    CPU ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for name, shape in shapes.items():
        std = math.sqrt(2.0 / int(np.prod(shape[:-1])))
        tree[name] = {"w": (torch.randn(shape, generator=gen) * std).numpy(),
                      "b": np.zeros((shape[-1],), np.float32)}
    return tree


def _read_npz(path, names):
    data = np.load(path)
    return {name: {"w": data[f"{name}_w"], "b": data[f"{name}_b"]} for name in names}


# ---------------------------------------------------------------------------
# VGG16 pooled features (FID's "vgg", pr50k3)

class VGGFeatureNet:
    """images [N, C, H, W] in [0, 255] -> [N, 1472] pooled features (64 +
    128 + 256 + 512 + 512 tap channels, globally average-pooled)."""

    feature_dim = 64 + 128 + 256 + 512 + 512
    label = "VGG16 features"

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0, device="cuda",
                 params=None, mode: str = "pretrained"):
        """Weights from ``params`` (a JAX LPIPS tree as numpy, whose ``mode``
        the caller states), else from ``weights_path``, else seeded."""
        if params is not None:
            tree, self.mode = params, mode
        elif weights_path and os.path.exists(weights_path):
            tree, self.mode = read_lpips_tree(weights_path), "pretrained"
        else:
            tree, self.mode = random_lpips_tree(seed), "random-features"
        self.device = torch.device(device)
        self._checksum = _checksum(tree)
        self.params = lpips_params_from_numpy(tree, self.device)

    def features(self, img_255: torch.Tensor) -> torch.Tensor:
        taps = _vgg_features(self.params, _preprocess(img_255))
        return torch.cat([t.mean(dim=(2, 3)) for t in taps], dim=1)

    def __call__(self, images_255) -> np.ndarray:
        with torch.no_grad():
            return self.features(_as_tensor(images_255, self.device)).cpu().numpy()

    def checksum(self) -> str:
        return self._checksum


# ---------------------------------------------------------------------------
# Stacked-MNIST digit classifier (mode_counts, KL)

_MNIST_SHAPES = {"conv1": (5, 5, 1, 32), "conv2": (5, 5, 32, 64),
                 "dense1": (64 * 8 * 8, 256), "dense2": (256, 10)}


def init_mnist_classifier(seed: int = 0):
    """Conv(32, 5x5)/pool, Conv(64, 5x5)/pool, Dense(256), Dense(10): a
    numpy tree in the JAX layout."""
    return _he_tree(_MNIST_SHAPES, seed)


def mnist_classifier_params_from_numpy(tree, device="cuda") -> Params:
    """A JAX stacked-MNIST classifier tree (numpy) as the port's tensors."""
    return _layers_from_numpy(tree, _MNIST_SHAPES, device)


def mnist_classifier_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [N, 1, 32, 32] in [0, 1] -> logits [N, 10]. The 5x5 SAME convs pad
    2 on each side."""
    def conv(x, p):
        return torch.clamp_min(F.conv2d(x, p["w"], p["b"], padding=2), 0)

    x = F.max_pool2d(conv(x, params["conv1"]), 2, 2)
    x = F.max_pool2d(conv(x, params["conv2"]), 2, 2)
    x = x.reshape(x.shape[0], -1)
    x = torch.clamp_min(x @ params["dense1"]["w"] + params["dense1"]["b"], 0)
    return x @ params["dense2"]["w"] + params["dense2"]["b"]


class StackedMNISTClassifier:
    """RGB stacked-MNIST image -> 1000-way mode id (per-channel digit CNN)."""

    label = "stacked-MNIST classifier"

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0, device="cuda",
                 params=None, mode: str = "pretrained"):
        """Weights from ``params`` (a JAX tree as numpy, whose ``mode`` the
        caller states), else from ``weights_path`` (default: the JAX
        package's environment variable, then
        ``metrics_weights/stacked_mnist_classifier.npz``), else seeded."""
        if params is not None:
            tree, self.mode = params, mode
        else:
            if weights_path is None:
                weights_path = os.environ.get(
                    "INCLUSIVEGAN_TPU_MNIST_CLASSIFIER",
                    os.path.join("metrics_weights", "stacked_mnist_classifier.npz"))
            if weights_path and os.path.exists(weights_path):
                tree, self.mode = _read_npz(weights_path, _MNIST_SHAPES), "pretrained"
            else:
                print(f"WARNING: stacked-MNIST classifier weights not found at "
                      f"{weights_path!r}; mode_counts/KL will use an UNTRAINED "
                      f"classifier (train one with scripts/train_mnist_classifier.py)",
                      file=sys.stderr)
                tree = init_mnist_classifier(seed)
                self.mode = "random-init (train with scripts/train_mnist_classifier.py)"
        self.device = torch.device(device)
        self.params = mnist_classifier_params_from_numpy(tree, self.device)

    def digits(self, img_255: torch.Tensor) -> torch.Tensor:
        """[N, C, H, W] in [0, 255] -> the digit of each channel [N, C]."""
        n, c, h, w = img_255.shape
        x = img_255.float().reshape(n * c, 1, h, w) / 255.0
        return torch.argmax(mnist_classifier_logits(self.params, x), dim=1).reshape(n, c)

    def modes(self, images_255) -> np.ndarray:
        """[N, 3, 32, 32] in [0, 255] -> mode ids [N] in [0, 1000)."""
        with torch.no_grad():
            d = self.digits(_as_tensor(images_255, self.device)).cpu().numpy()
        return d[:, 0] + 10 * d[:, 1] + 100 * d[:, 2]

    __call__ = modes


# ---------------------------------------------------------------------------
# CelebA 40-attribute classifier (ls)

_ATTR_SHAPES = {"conv1": (3, 3, 3, 32), "conv2": (3, 3, 32, 64), "conv3": (3, 3, 64, 128),
                "conv4": (3, 3, 128, 128), "dense1": (128, 256), "dense2": (256, 40)}


def init_attr_classifier(seed: int = 0, num_attrs: int = 40):
    """Strided conv trunk 128 px -> 8 px, global pool, two dense layers: a
    numpy tree in the JAX layout."""
    return _he_tree(dict(_ATTR_SHAPES, dense2=(256, num_attrs)), seed)


def attr_classifier_params_from_numpy(tree, device="cuda") -> Params:
    """A JAX CelebA attribute classifier tree (numpy) as the port's tensors."""
    return _layers_from_numpy(tree, _ATTR_SHAPES, device)


def same_pads(size: int, kernel: int, stride: int):
    """(before, after) of XLA's SAME padding along one axis: the output has
    ceil(size / stride) cells, and an odd total pads one more after, so a
    stride-2 3x3 conv pads (0, 1) on an even size and (1, 1) on an odd one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def attr_classifier_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [N, 3, H, W] in [0, 1] -> logits [N, num_attrs]."""
    def conv(x, p):
        top, bottom = same_pads(x.shape[2], 3, 2)
        left, right = same_pads(x.shape[3], 3, 2)
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), p["w"], p["b"], stride=2)
        return F.leaky_relu(y, 0.2)

    for name in ("conv1", "conv2", "conv3", "conv4"):
        x = conv(x, params[name])
    x = x.mean(dim=(2, 3))
    x = F.leaky_relu(x @ params["dense1"]["w"] + params["dense1"]["b"], 0.2)
    return x @ params["dense2"]["w"] + params["dense2"]["b"]


class CelebAAttrClassifier:
    """[N, 3, H, W] uint8 images in [0, 255] -> attribute probabilities [N, 40]."""

    label = "CelebA attribute classifier"

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0, device="cuda",
                 params=None, mode: str = "pretrained"):
        """Weights from ``params`` (a JAX tree as numpy, whose ``mode`` the
        caller states), else from ``weights_path`` (default: the JAX
        package's environment variable, then
        ``metrics_weights/celeba_attr_classifier.npz``), else seeded."""
        if params is not None:
            tree, self.mode = params, mode
        else:
            if weights_path is None:
                weights_path = os.environ.get(
                    "INCLUSIVEGAN_TPU_ATTR_CLASSIFIER",
                    os.path.join("metrics_weights", "celeba_attr_classifier.npz"))
            if weights_path and os.path.exists(weights_path):
                tree, self.mode = _read_npz(weights_path, _ATTR_SHAPES), "pretrained"
            else:
                print(f"WARNING: CelebA attribute classifier weights not found at "
                      f"{weights_path!r}; LS will use an UNTRAINED scorer (train one "
                      f"with scripts/train_attr_classifier.py)", file=sys.stderr)
                tree = init_attr_classifier(seed)
                self.mode = "random-init (train with scripts/train_attr_classifier.py)"
        self.device = torch.device(device)
        self.params = attr_classifier_params_from_numpy(tree, self.device)

    def probs(self, img_255: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(attr_classifier_logits(self.params, img_255.float() / 255.0))

    def __call__(self, images_255) -> np.ndarray:
        with torch.no_grad():
            return self.probs(_as_tensor(images_255, self.device)).cpu().numpy()
