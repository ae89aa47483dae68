"""Train the CelebA 40-attribute classifier (the ``ls`` metric's scorer and
the minority filter): the port's ``scripts/train_attr_classifier.py``.

One shared conv trunk with 40 sigmoid heads (``models/feature_nets.py``)
learns from a CelebA-layout TFRecord set whose labels are the 40 binary
attributes (``dataset_tool create_celeba``): the mean sigmoid cross-entropy
and Adam (lr 2e-4, betas 0.9 and 0.999), in minibatches of a
``RandomState(0)`` permutation per epoch, the last partial one dropped. The
first ``--val-frac`` of the images, unshuffled, are held out. The npz it
saves (``{layer}_w``, ``{layer}_b``, the JAX layout) is what ``ls`` loads by
default in either package.

A fresh run starts from ``feature_nets.init_attr_classifier(0)``: JAX's
distributions from a ``torch.Generator``, not the JAX script's
``jax.random.key(0)`` draws. ``train`` takes any initial tree.

    python -m inclusivegan_torch.scripts.train_attr_classifier \\
        --data-dir /tmp/exp/datasets --dataset celeba_synth_30k \\
        --out metrics_weights/celeba_attr_classifier.npz [--device cpu]
"""

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import TFRecordDataset
from ..models.feature_nets import attr_classifier_logits, init_attr_classifier
from ..training.optimizer import init_adam
from ._train import (EpochClock, adam_step, epoch_batches, flat_from_tree, layers,
                     save_layers, to_device, training_device)


def train(images: np.ndarray, labels: np.ndarray, init_tree, *, epochs: int = 4,
          batch: int = 64, lr: float = 2e-4, val_frac: float = 0.05, device="cuda",
          log=print):
    """Train from ``init_tree`` (numpy, the JAX layout) on uint8 images
    [N, 3, H, W] and labels [N, 40] in {0, 1}; returns the flat
    parameters."""
    device = torch.device(device)
    n_val = max(int(len(images) * val_frac), 1)
    val_x, val_y = images[:n_val], labels[:n_val]
    tr_y = labels[n_val:]
    log(f"{len(images) - n_val} train / {n_val} val images, res {images.shape[2]}")
    tr_x = to_device(images[n_val:], device)
    tr_yd = to_device(np.asarray(tr_y, np.float32), device)
    val_xd = to_device(val_x, device)
    params = flat_from_tree(init_tree, device)
    opt = init_adam(params)

    def loss_fn(idx):
        x, y = tr_x[idx].float() / 255.0, tr_yd[idx]

        def fn(p):
            logits = attr_classifier_logits(layers(p), x)
            # sigmoid BCE, mean over batch x attrs
            return -(y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits)).mean()
        return fn

    rng = np.random.RandomState(0)
    n = len(tr_y)
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
        preds = []
        with torch.no_grad():
            for i in range(0, n_val, batch):
                x = val_xd[i:i + batch].float() / 255.0
                logits = attr_classifier_logits(layers(params), x)
                preds.append(torch.sigmoid(logits).cpu().numpy())
        preds = np.concatenate(preds) > 0.5
        acc = (preds == (val_y[:len(preds)] > 0.5)).mean()
        per_attr = (preds == (val_y[:len(preds)] > 0.5)).mean(0)
        log(f"epoch {epoch}: loss {np.mean(losses):.4f} "
            f"val acc {acc:.4f} (worst attr {per_attr.min():.3f})")
        log(rate)
    return params


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--val-frac", type=float, default=0.05)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = training_device(args.device)

    ds = TFRecordDataset(os.path.join(args.data_dir, args.dataset), max_label_size="full")
    images = ds.get_all_images()           # [N,3,H,W] uint8
    labels = ds.get_all_labels()           # [N,40] float {0,1}
    assert labels.shape[1] == 40, labels.shape
    params = train(images, labels, init_attr_classifier(0), epochs=args.epochs,
                      batch=args.batch, lr=args.lr, val_frac=args.val_frac, device=device,
                      log=lambda line: print(line, flush=True))
    save_layers(params, args.out)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
