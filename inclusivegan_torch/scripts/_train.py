"""What the trainers share: the device check, parameter trees in the JAX
layout carried to flat dicts of tensors for the port's Adam and back, one
Adam step by autograd, and the npz writer of the classifiers' layout."""

import os
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..models.feature_nets import _layers_from_numpy
from ..training.optimizer import AdamState, adam_apply

Flat = Dict[str, torch.Tensor]


def training_device(name: str) -> torch.device:
    """The device to train on, with TF32 off for convolutions and matrix
    products, as ``run_training`` trains; raises for a missing card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (copied first where numpy
    holds it read-only, as a TFRecord set's decoded images)."""
    return torch.from_numpy(np.require(array, requirements=["C", "W"])).to(device)


def flat_from_tree(tree, device, prefix: str = "") -> Flat:
    """A nested numpy tree of layers {name: {"w", "b"}} in the JAX layout as
    a flat dict {"name/w": tensor}: conv weights [kh, kw, I, O] turned to
    OIHW, float32."""
    return {f"{prefix}{name}/{leaf}": t
            for name, p in _layers_from_numpy(tree, tree, device).items()
            for leaf, t in p.items()}


def layers(flat: Flat, prefix: str = "") -> Dict[str, Dict[str, torch.Tensor]]:
    """The layers under ``prefix`` of a flat dict, nested as the port's
    networks take them."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in flat.items():
        if key.startswith(prefix):
            name, leaf = key[len(prefix):].split("/")
            out.setdefault(name, {})[leaf] = t
    return out


def numpy_leaf(t: torch.Tensor) -> np.ndarray:
    """A parameter in the JAX layout: OIHW back to [kh, kw, I, O]."""
    t = t.detach().cpu()
    if t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    return np.ascontiguousarray(t.numpy())


def save_layers(flat: Flat, path: str) -> None:
    """The npz of the JAX package's ``StackedMNISTClassifier.save`` and
    ``CelebAAttrClassifier.save``: ``{layer}_w`` and ``{layer}_b`` per layer."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{f"{name}_{leaf}": numpy_leaf(p[leaf]) for name, p in layers(flat).items()
                      for leaf in ("w", "b")})


def adam_step(params: Flat, opt: AdamState, loss_fn: Callable[[Flat], torch.Tensor],
              lr: float) -> Tuple[Flat, AdamState, torch.Tensor]:
    """The loss and its gradient at ``params``, then one Adam step with
    beta1 0.9 and beta2 0.999, as the JAX scripts' ``train_step``."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    params, opt, _ = adam_apply(leaves, dict(zip(leaves, grads)), opt, learning_rate=lr,
                                beta1=0.9, beta2=0.999)
    return params, opt, loss.detach()


def epoch_batches(order: np.ndarray, batch: int):
    """Consecutive full batches of ``order``; the last partial one is
    dropped."""
    for i in range(0, order.shape[0] - batch + 1, batch):
        yield order[i:i + batch]


class EpochClock:
    """An epoch's seconds on the host clock, the device synchronized: over
    all its steps and over those after the first, which carries cuDNN's
    algorithm search and the device's lazy set-up."""

    def __init__(self, device: torch.device):
        self.device = device
        self.steps = 0
        self.t0 = time.time()
        self.t1 = self.t0

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.time()

    def step(self) -> None:
        self.steps += 1
        if self.steps == 1:
            self.t1 = self._sync()

    def line(self, epoch: int, batch: int) -> str:
        """The line each trainer prints after an epoch's loss line."""
        t = self._sync()
        n = self.steps * batch
        out = (f"epoch {epoch}: {n} images in {t - self.t0:.3f} s, "
               f"{n / max(t - self.t0, 1e-9):.1f} images/s")
        if self.steps > 1:
            out += (f"; after the first step {(n - batch) / max(t - self.t1, 1e-9):.1f} "
                    f"images/s")
        return out
