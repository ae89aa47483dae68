"""Train the VGG16-LPIPS trunk as a domain perceptual net and calibrate its
LPIPS taps: the port's ``scripts/train_perceptual_vgg.py``.

The trunk of ``models/lpips.py`` (after its input normalization) learns
from the target dataset itself: a zero-initialised head over the globally
average-pooled conv5_3 features gives three 10-way digit heads for
stacked-MNIST labels (``--label-mode stacked``) or one sigmoid head per
binary attribute for CelebA-style labels (``attrs``); ``auto`` picks by the
label width. Adam (betas 0.9 and 0.999) runs in minibatches of the held-in
images, each epoch in a new order. Then every LPIPS tap is set to
``1/cout`` and scaled so that the mean distance between distinct dataset
images is ``--target-scale``, and three geometry checks run: an all-black
image and the dataset's mean image must not be much closer to a dataset
image than two distinct images are, and similar pairs (the same digit
triple, or the most attribute-similar pairs of a random sample) must be
closer than distinct ones. The npz (``{conv}_w``, ``{conv}_b``,
``lin_{tap}``; weights in the JAX layout) is what ``load_lpips_params`` of
either package reads as mode 1, the ``--lpips-weights`` of training, the
metrics and the projector. When a check fails, the file is saved as
``*.rejected.npz`` instead and the script exits 3.

The uint8 dataset lives on the device and each minibatch is gathered there
by index, so only the indices cross from the host each step. Every host
draw comes from one ``RandomState(--seed)``, in the JAX script's order: the
split, each epoch's order, the calibration pairs, the similar pairs. A fresh
run starts from ``lpips.random_lpips_tree(--seed)``: JAX's distributions
from a ``torch.Generator``, not the JAX script's ``init_lpips_params``
draws, so its weights and verdict may differ from the JAX script's.
``train`` takes any initial trunk.

    python -m inclusivegan_torch.scripts.train_perceptual_vgg \\
        --data-dir /tmp/exp/datasets --dataset stacked_synth_240k \\
        --out /tmp/exp/perceptual_vgg.npz [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.dataset import load_dataset
from ..models.lpips import (_TAPS, _VGG_LAYOUT, _preprocess, _vgg_features, lpips_distance,
                            random_lpips_tree)
from ..training.optimizer import init_adam
from ._train import (EpochClock, adam_step, epoch_batches, flat_from_tree, layers,
                     numpy_leaf, to_device, training_device)

PAIR_CHUNK = 256  # pairs per LPIPS call, to bound the activations' memory


def targets_of(labels: np.ndarray, mode: str):
    """(mode, targets, label_idx) of the labels: ``auto`` takes
    ``stacked`` for one-hot labels of 100 or more classes (the 1000 stacked
    modes), else ``attrs``."""
    if mode == "auto":
        mode = "stacked" if labels.shape[1] >= 100 else "attrs"
    if mode == "stacked":
        label_idx = np.argmax(labels, axis=1).astype(np.int32)
        targets = np.stack([label_idx % 10, (label_idx // 10) % 10,
                            label_idx // 100], axis=1).astype(np.int32)  # [N,3]
        return mode, targets, label_idx
    targets = (labels > 0.5).astype(np.int32)  # [N,A] binary attributes
    return mode, targets, None


def train(images_dev: torch.Tensor, targets: np.ndarray, mode: str, trunk_tree, rng,
          train_idx: np.ndarray, val_idx: np.ndarray, *, epochs: int = 2, batch: int = 256,
          lr: float = 1e-3, log=print):
    """Train the trunk (``trunk_tree``: numpy conv layers in the JAX layout)
    and a zero head on ``images_dev`` (uint8 [N, 3, H, W] on the device),
    taking each epoch's order from ``rng``; returns the flat parameters
    (``trunk/<conv>/w``, ``head/w``, ...)."""
    device = images_dev.device
    n_out = 30 if mode == "stacked" else targets.shape[1]
    params = flat_from_tree(trunk_tree, device, "trunk/")
    params["head/w"] = torch.zeros((512, n_out), dtype=torch.float32, device=device)
    params["head/b"] = torch.zeros((n_out,), dtype=torch.float32, device=device)
    opt = init_adam(params)
    targets_dev = torch.from_numpy(targets.astype(np.int64)).to(device)

    def logits_fn(p, idx):
        # the preprocessing of lpips_features
        x = _preprocess(images_dev[idx])
        f = _vgg_features(layers(p, "trunk/"), x)[-1].mean(dim=(2, 3))  # GAP conv5_3
        lg = f @ p["head/w"] + p["head/b"]
        return lg.reshape(-1, 3, 10) if mode == "stacked" else lg

    def loss_fn(idx):
        y = targets_dev[idx]

        def fn(p):
            lg = logits_fn(p, idx)
            if mode == "stacked":
                lp = F.log_softmax(lg, dim=-1)
                return -lp.gather(-1, y[..., None]).mean()
            # multi-label attributes: mean sigmoid BCE. The head starts at
            # zero, so the gradients at 0 are jnp's: one half for maximum,
            # one for abs
            yf = y.float()
            abs_lg = torch.where(lg >= 0, lg, -lg)
            return (torch.maximum(lg, lg.new_zeros(())) - lg * yf
                    + torch.log1p(torch.exp(-abs_lg))).mean()
        return fn

    def acc_fn(p, idx):
        y = targets_dev[idx]
        with torch.no_grad():
            lg = logits_fn(p, idx)
        pred = lg.argmax(dim=-1) if mode == "stacked" else (lg > 0).long()
        return (pred == y).all(dim=1).float().mean(), (pred == y).float().mean()

    t0 = time.time()
    for epoch in range(epochs):
        clock = EpochClock(device)
        ep_order = train_idx[rng.permutation(train_idx.shape[0])]
        losses = []
        for idx in epoch_batches(ep_order, batch):
            params, opt, loss = adam_step(params, opt, loss_fn(torch.from_numpy(idx).to(device)),
                                          lr)
            losses.append(loss)
            clock.step()
        rate = clock.line(epoch, batch)
        losses = [float(v) for v in losses]
        accs = [acc_fn(params, torch.from_numpy(idx).to(device))
                for idx in epoch_batches(val_idx, batch)]
        acc3 = float(np.mean([float(a[0]) for a in accs]))
        acc1 = float(np.mean([float(a[1]) for a in accs]))
        lab3 = "triple-acc" if mode == "stacked" else "all-attr-acc"
        lab1 = "digit-acc" if mode == "stacked" else "attr-acc"
        log(f"epoch {epoch}: loss {np.mean(losses):.4f} "
            f"val {lab3} {acc3:.4f} {lab1} {acc1:.4f} "
            f"({time.time() - t0:.0f}s)")
        log(rate)
    return params


def distances(final, x0: torch.Tensor, x1: torch.Tensor) -> np.ndarray:
    """LPIPS per pair, in chunks of ``PAIR_CHUNK`` pairs, as float32 numpy."""
    with torch.no_grad():
        return np.concatenate([
            lpips_distance(final, x0[i:i + PAIR_CHUNK], x1[i:i + PAIR_CHUNK]).cpu().numpy()
            for i in range(0, x0.shape[0], PAIR_CHUNK)])


def calibrate_and_check(images_dev: torch.Tensor, trunk, mode: str, targets: np.ndarray,
                        label_idx, rng, target_scale: float, log=print):
    """Uniform taps scaled to ``target_scale``, then the geometry checks.
    ``trunk``: ``{conv: {"w" (OIHW), "b"}}`` on the device. Returns the
    LPIPS parameters, the scale and the three verdicts (black, mean, same)."""
    n = images_dev.shape[0]
    device = images_dev.device
    # uniform taps, then scale so mean distinct-pair distance = target
    couts = dict((nm, c) for nm, c, _ in _VGG_LAYOUT)
    final = {"_mode": 1}
    final.update(trunk)
    for tap in _TAPS:
        final[f"lin_{tap}"] = torch.full((couts[tap],), 1.0 / couts[tap], dtype=torch.float32,
                                         device=device)

    def take(idx):
        return images_dev[torch.from_numpy(np.asarray(idx, np.int64)).to(device)]

    npairs = min(1024, (n - 1) // 2)
    pairs = rng.permutation(n)[:4 * npairs]
    half = pairs.shape[0] // 2
    a, b = pairs[:half], pairs[half:2 * half]
    if mode == "stacked":
        keep = label_idx[a] != label_idx[b]
    else:
        keep = (targets[a] != targets[b]).sum(axis=1) >= 1
    a, b = a[keep][:npairs], b[keep][:npairs]
    npairs = a.shape[0]
    da, db = take(a), take(b)
    d_raw = distances(final, da, db)
    scale = target_scale / float(d_raw.mean())
    for tap in _TAPS:
        final[f"lin_{tap}"] = final[f"lin_{tap}"] * scale
    log(f"calibration: raw distinct-pair mean {d_raw.mean():.5f} -> "
        f"scale x{scale:.2f}")

    # ------------------------------------------------- acceptance checks
    d_distinct = distances(final, da, db)
    d_black = distances(final, da, torch.zeros_like(da))
    if mode == "stacked":
        # same-triple pairs: group indices by label
        by_label = {}
        for i in rng.permutation(n)[:60000]:
            by_label.setdefault(int(label_idx[i]), []).append(i)
        sa, sb = [], []
        for v in by_label.values():
            for i in range(0, len(v) - 1, 2):
                sa.append(v[i])
                sb.append(v[i + 1])
    else:
        # attribute mode: "same" = the most attribute-similar pairs mined
        # from a large random-pair sample (exact attr matches are rare at
        # 40 binary attributes)
        ca = rng.randint(0, n, 300000)
        cb = rng.randint(0, n, 300000)
        ok = ca != cb
        ca, cb = ca[ok], cb[ok]
        ham = (targets[ca] != targets[cb]).sum(axis=1)
        order2 = np.argsort(ham, kind="stable")
        sa, sb = list(ca[order2]), list(cb[order2])
        log(f"similar-attr pair hamming: p50 {np.median(ham):.0f}, "
            f"selected <= {ham[order2[min(npairs, len(order2)) - 1]]}")
    sa, sb = sa[:npairs], sb[:npairs]
    if len(sa) == npairs:
        d_same = distances(final, take(sa), take(sb))
    else:  # tiny/degenerate datasets: not enough same-label pairs
        d_same = np.array([np.nan])
    mean_img = images_dev[:20000].float().mean(dim=0).expand(da.shape)
    d_mean = distances(final, da, mean_img)
    log(f"distinct-triple mean {d_distinct.mean():.4f} "
        f"(p10 {np.percentile(d_distinct, 10):.4f} "
        f"p90 {np.percentile(d_distinct, 90):.4f})")
    log(f"same-triple mean     {d_same.mean():.4f}")
    log(f"black-vs-digit mean  {d_black.mean():.4f}")
    log(f"mean-blob-vs-digit   {d_mean.mean():.4f}")
    # black and the mean blob must not sit much closer than a distinct
    # image (the random-feature fallback measured 0.78x, which drove G
    # dark); on an aligned face corpus the mean image is itself face-like,
    # so attrs mode asks only 0.75x of it; similar pairs must be clearly
    # closer (0.8x for digit triples, 0.95x for attribute-similar faces)
    ok_black = d_black.mean() > 0.9 * d_distinct.mean()
    mean_factor = 0.9 if mode == "stacked" else 0.75
    ok_mean = d_mean.mean() > mean_factor * d_distinct.mean()
    same_factor = 0.8 if mode == "stacked" else 0.95
    ok_same = d_same.mean() < same_factor * d_distinct.mean()
    log(f"geometry: black not-much-closer: {ok_black}; "
        f"mean-blob not-much-closer: {ok_mean}; "
        f"class-aware (same << distinct): {ok_same}")
    return final, scale, (bool(ok_black), bool(ok_mean), bool(ok_same))


def save_lpips(final, path: str) -> None:
    """The npz of the JAX script: ``{conv}_w`` for every conv, then
    ``{conv}_b``, then ``lin_{tap}``; weights in the JAX layout."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    convs = {k: v for k, v in final.items() if isinstance(v, dict)}
    np.savez(path, **{f"{k}_w": numpy_leaf(v["w"]) for k, v in convs.items()},
             **{f"{k}_b": numpy_leaf(v["b"]) for k, v in convs.items()},
             **{k: numpy_leaf(v) for k, v in final.items() if k.startswith("lin_")})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--target-scale", type=float, default=0.3,
                   help="calibrated mean LPIPS distance between distinct "
                        "dataset images (converted-zhang scale)")
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--val-frac", type=float, default=0.02)
    p.add_argument("--label-mode", default="auto",
                   choices=("auto", "stacked", "attrs"),
                   help="stacked: 1000-way stacked-digit one-hot labels -> "
                        "3x10-way digit heads; attrs: multi-label binary "
                        "attributes (CelebA's 40) -> sigmoid heads; auto "
                        "picks by label shape")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = training_device(args.device)

    ds = load_dataset(data_dir=args.data_dir, tfrecord_dir=args.dataset,
                      max_label_size="full", shuffle=False, verbose=True)
    images = np.asarray(ds.get_all_images())  # uint8 [N,3,H,W]
    mode, targets, label_idx = targets_of(np.asarray(ds.get_all_labels()), args.label_mode)
    n = images.shape[0]
    n_val = max(int(n * args.val_frac), args.batch)
    rng = np.random.RandomState(args.seed)
    order = rng.permutation(n)
    val_idx, train_idx = order[:n_val], order[n_val:]
    print(f"dataset {args.dataset}: {n} images, {n_val} held out")

    tree = random_lpips_tree(args.seed)
    trunk_tree = {k: v for k, v in tree.items() if isinstance(v, dict)}
    images_dev = to_device(images, device)
    params = train(images_dev, targets, mode, trunk_tree, rng, train_idx, val_idx,
                      epochs=args.epochs, batch=args.batch, lr=args.lr)
    final, _, verdicts = calibrate_and_check(images_dev, layers(params, "trunk/"), mode,
                                             targets, label_idx, rng, args.target_scale)
    out = args.out
    if not all(verdicts):
        # never overwrite a (possibly good) anchor with a rejected one
        base, ext = os.path.splitext(out)
        out = base + ".rejected" + (ext or ".npz")
        print("WARNING: geometry checks failed — saving to "
              f"{out} (NOT usable for training)")
    save_lpips(final, out)
    print(f"saved {out}")
    if not all(verdicts):
        sys.exit(3)


if __name__ == "__main__":
    main()
