"""Train the stacked-MNIST mode classifier: the port's
``scripts/train_mnist_classifier.py``.

The per-digit CNN of ``models/feature_nets.py`` learns from MNIST idx files
(zero-padded to 32 px) with a softmax cross-entropy and Adam (lr 1e-3,
betas 0.9 and 0.999), in minibatches of a ``RandomState(0)`` permutation per
epoch, the last partial one dropped. The npz it saves (``{layer}_w``,
``{layer}_b``, weights in the JAX layout) is what ``mode_counts`` and ``KL``
load through ``--classifier-weights`` in either package.

A fresh run starts from ``feature_nets.init_mnist_classifier(0)``: JAX's
distributions from a ``torch.Generator``, not the JAX script's
``jax.random.key(0)`` draws, so its weights differ from the JAX script's
while its data order is the same. ``train`` takes any initial tree.

    python -m inclusivegan_torch.scripts.train_mnist_classifier --mnist-dir mnist/ \\
        --out metrics_weights/stacked_mnist_classifier.npz [--device cpu]
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset_tool import _find, _load_mnist_images, _load_mnist_labels
from ..models.feature_nets import init_mnist_classifier, mnist_classifier_logits
from ..training.optimizer import init_adam
from ._train import (EpochClock, adam_step, epoch_batches, flat_from_tree, layers,
                     save_layers, to_device, training_device)


def load_mnist(mnist_dir: str):
    """Images [N, 1, 32, 32] float32 in [0, 1] and labels [N] uint8."""
    images = _load_mnist_images(_find(mnist_dir, "train-images-idx3-ubyte*"))
    labels = _load_mnist_labels(_find(mnist_dir, "train-labels-idx1-ubyte*"))
    images = np.pad(images, [(0, 0), (2, 2), (2, 2)])[:, None].astype(np.float32) / 255.0
    return images, labels


def train(images: np.ndarray, labels: np.ndarray, init_tree, *, epochs: int = 3,
          batch: int = 256, lr: float = 1e-3, device="cuda", log=print):
    """Train from ``init_tree`` (numpy, the JAX layout); returns the flat
    parameters."""
    device = torch.device(device)
    x_all = to_device(images, device)
    y_all = to_device(labels.astype(np.int64), device)
    params = flat_from_tree(init_tree, device)
    opt = init_adam(params)

    def loss_fn(idx):
        x, y = x_all[idx], y_all[idx]

        def fn(p):
            logp = F.log_softmax(mnist_classifier_logits(layers(p), x), dim=1)
            return -logp.gather(1, y[:, None]).mean()
        return fn

    n = images.shape[0]
    rng = np.random.RandomState(0)
    for epoch in range(epochs):
        clock = EpochClock(device)
        order = rng.permutation(n)
        losses = []
        for idx in epoch_batches(order, batch):
            params, opt, loss = adam_step(params, opt, loss_fn(torch.from_numpy(idx).to(device)),
                                          lr)
            losses.append(loss)
            clock.step()
        rate = clock.line(epoch, batch)
        losses = [float(v) for v in losses]
        # train accuracy on a slice
        with torch.no_grad():
            logits = mnist_classifier_logits(layers(params), x_all[:4096])
        acc = float((np.argmax(logits.cpu().numpy(), 1) == labels[:4096]).mean())
        log(f"epoch {epoch}: loss {np.mean(losses):.4f} acc {acc:.4f}")
        log(rate)
    return params


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mnist-dir", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = training_device(args.device)

    images, labels = load_mnist(args.mnist_dir)
    params = train(images, labels, init_mnist_classifier(0), epochs=args.epochs,
                      batch=args.batch, lr=args.lr, device=device)
    save_layers(params, args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
